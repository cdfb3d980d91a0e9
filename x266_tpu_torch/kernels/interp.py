"""Motion-compensation interpolation (C7), as x266_tpu/kernels/interp.py.

Quarter-pel prediction reads a precomputed 16-plane pyramid: the
reference plane is edge-padded by REF_PAD and filtered once per picture
with the separable 8-tap (luma) / 4-tap (chroma) filters into planes
indexed by frac_y*4 + frac_x, one rounding stage:
out = clip((f_v . (f_h . p) + 2048) >> 12, 0, 255), exact int32.

The filter taps shift the plane with ``torch.roll`` as the reference
shifts it with ``jnp.roll``: the wrap-around puts far-side samples into
the outermost rows and columns of the pad, and a zero-padded
convolution would give other values there, which MC can read.
"""

from __future__ import annotations

import numpy as np
import torch

# HEVC luma 8-tap interpolation filters, fracs 0..3 (quarter-pel) [STD].
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# HEVC chroma 4-tap filters at eighth-pel positions 0,2,4,6 [STD]
# (chroma MVs are quarter-pel, so only even eighth positions).
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-4, 54, 16, -2],
    [-4, 36, 36, -4],
    [-2, 16, 54, -4],
], dtype=np.int32)

REF_PAD = 80    # edge-replication padding of reference planes


def pad_ref(plane: torch.Tensor) -> torch.Tensor:
    """Edge-replicate pad a (H, W) picture plane by REF_PAD on all
    sides, as int32."""
    p = plane.to(torch.int32)
    rows = torch.cat([p[:1].expand(REF_PAD, -1), p,
                      p[-1:].expand(REF_PAD, -1)])
    return torch.cat([rows[:, :1].expand(-1, REF_PAD), rows,
                      rows[:, -1:].expand(-1, REF_PAD)], dim=1)


def _filter_axis(p: torch.Tensor, taps: np.ndarray, axis: int
                 ) -> torch.Tensor:
    """n-tap FIR along axis (int32, no shift); tap k reads offset
    k - (n//2 - 1), with the reference's wrap-around."""
    n = len(taps)
    c = n // 2 - 1
    acc = torch.zeros_like(p)
    for k in range(n):
        if taps[k]:
            acc = acc + int(taps[k]) * torch.roll(p, c - k, dims=axis)
    return acc


def build_pyramid(plane: torch.Tensor, chroma: bool = False,
                  max_val: int = 255) -> torch.Tensor:
    """Padded reference plane (Hp, Wp) -> (16, Hp, Wp) uint8 pyramid;
    index f = frac_y*4 + frac_x, plane 0 the integer plane."""
    if max_val > 255:
        raise NotImplementedError("the port's slices are 8-bit")
    filters = CHROMA_FILTERS if chroma else LUMA_FILTERS
    p = plane.to(torch.int32)
    planes = []
    for fy in range(4):
        v = _filter_axis(p, filters[fy], axis=0)          # scale 64
        for fx in range(4):
            hv = _filter_axis(v, filters[fx], axis=1)     # scale 4096
            planes.append(((hv + 2048) >> 12).clamp(0, max_val)
                          .to(torch.uint8))
    return torch.stack(planes)


def mc_block(pyramid: torch.Tensor, x0: int, y0: int, mv_x: int,
             mv_y: int, size: int) -> torch.Tensor:
    """Motion-compensated (size, size) int32 prediction of the block at
    picture position (x0, y0); mv in quarter-pel units.  The read must
    lie inside the pyramid (the reference clamps an out-of-range start;
    the MV bounds keep every read inside, so this asserts instead)."""
    f = (mv_y & 3) * 4 + (mv_x & 3)
    ix = x0 + REF_PAD + (mv_x >> 2)
    iy = y0 + REF_PAD + (mv_y >> 2)
    assert (0 <= iy and iy + size <= pyramid.shape[1]
            and 0 <= ix and ix + size <= pyramid.shape[2]), (x0, y0, mv_x,
                                                             mv_y)
    return pyramid[f, iy:iy + size, ix:ix + size].to(torch.int32)


def mv_bounds(cfg, size: int) -> int:
    """Max |mv| in quarter-pel units such that every gather stays
    inside the padded plane."""
    return 4 * (REF_PAD - 8)
