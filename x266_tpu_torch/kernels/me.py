"""Motion estimation (C8), encoder-only, as x266_tpu/kernels/me.py.

Hierarchical bounded-window search: a 4x-subsampled dense search covers
+-SEARCH_R full-pel in two passes (centre bias, then an AMVP-shaped MVD
rate against the left neighbour's pass-1 MV), then a combined refinement
evaluates a stride-2 and a stride-1 3x3 full-pel pattern and 25
quarter-pel candidates around the winner by reading the interpolation
pyramid (kernels.interp), so ME sees exactly the normative MC samples.

The refinement is kernel K5 (kernels.me_cuda) on CUDA tensors;
``refine_search_ref`` is its plain version and the path CPU tensors
take.  Decisions must equal the reference's: float32 costs are built op
by op in the reference's order (the Python-side products in double, one
float32 multiply, one add), ``argmin`` keeps the first minimum and a
later dy wins only on a strictly smaller cost.
"""

from __future__ import annotations

import numpy as np
import torch

from x266_tpu_torch.kernels import interp

ME_BLOCK = 16          # ME grid granularity (16x16 luma blocks)
SEARCH_R = 16          # integer search radius (full-pel)
FRAC_D = 2             # quarter-pel refinement radius
REFINE_R = 3           # full-pel refinement reach around the coarse MV

# candidate orders of the refinement (first minimum wins in list order)
_REF_DELTAS_A = [(dx, dy) for dy in (-2, 0, 2) for dx in (-2, 0, 2)]
_REF_DELTAS_B = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_QP_DELTAS = [(dx, dy) for dy in range(-FRAC_D, FRAC_D + 1)
              for dx in range(-FRAC_D, FRAC_D + 1)]


def _ceil_pad(img: torch.Tensor) -> torch.Tensor:
    """Edge-pad a (H, W) picture to ME_BLOCK multiples."""
    h, w = img.shape
    ph = -(-h // ME_BLOCK) * ME_BLOCK - h
    pw = -(-w // ME_BLOCK) * ME_BLOCK - w
    if ph:
        img = torch.cat([img, img[-1:].expand(ph, -1)])
    if pw:
        img = torch.cat([img, img[:, -1:].expand(-1, pw)], dim=1)
    return img


def mvd_rate(v: torch.Tensor) -> torch.Tensor:
    """Integer MVD-component rate model: 1 + 2*ceil(log2(v+1)) bits."""
    r = (v >= 1).to(torch.int32)
    for k in range(1, 8):
        r = r + (v >= (1 << k)).to(torch.int32)
    return 1 + 2 * r


def integer_search(cur: torch.Tensor, ref_pad: torch.Tensor, lam: float,
                   radius: int = SEARCH_R, pad: int = interp.REF_PAD,
                   blk: int = ME_BLOCK, pen_scale: float = 2.0,
                   pred: torch.Tensor | None = None,
                   lam_rate: float = 0.0) -> torch.Tensor:
    """cur: (H, W) int32 (blk multiples); ref_pad: the pad-padded int32
    reference.  Returns (H/blk, W/blk, 2) int32 full-pel MVs [x, y].

    pred None: centre bias lam*pen_scale*(|dx|+|dy|).  pred (By, Bx, 2):
    lam_rate * (mvd_rate(|dx-px|) + mvd_rate(|dy-py|)) instead."""
    h, w = cur.shape
    by, bx = h // blk, w // blk
    r = radius
    dev = cur.device
    dxs = torch.arange(-r, r + 1, dtype=torch.int32, device=dev)
    pen_w = torch.tensor(np.float32(lam * pen_scale), device=dev)
    rate_w = torch.tensor(np.float32(lam_rate), device=dev)
    best_cost = torch.full((by, bx), float("inf"), dtype=torch.float32,
                           device=dev)
    best_mv = torch.zeros((by, bx, 2), dtype=torch.int32, device=dev)
    assert (pad - r >= 0 and pad + r + h <= ref_pad.shape[0]
            and pad + r + w <= ref_pad.shape[1])
    for dy in range(-r, r + 1):
        row = ref_pad[pad + dy:pad + dy + h, pad - r:pad + r + w]
        sads = torch.stack([
            (cur - row[:, k:k + w]).abs().reshape(by, blk, bx, blk)
            .sum((1, 3), dtype=torch.int32) for k in range(2 * r + 1)])
        if pred is None:
            pen = (dxs.abs() + abs(dy)).to(torch.float32)
            cost = sads.to(torch.float32) + pen_w * pen[:, None, None]
        else:
            rx = mvd_rate((dxs[:, None, None] - pred[None, :, :, 0]).abs())
            ry = mvd_rate((dy - pred[:, :, 1]).abs())[None]
            cost = sads.to(torch.float32) + rate_w * (rx + ry).to(
                torch.float32)
        c = cost.amin(dim=0)
        k = torch.argmin(cost, dim=0)          # the first minimum
        better = c < best_cost
        best_cost = torch.where(better, c, best_cost)
        mv = torch.stack([k.to(torch.int32) - r,
                          torch.full_like(k, dy, dtype=torch.int32)], -1)
        best_mv = torch.where(better[..., None], mv, best_mv)
    return best_mv


def coarse_search(cur: torch.Tensor, pyramid: torch.Tensor,
                  lam: float) -> torch.Tensor:
    """4x-downsampled dense search over +-SEARCH_R full-pel, centre-bias
    pass then the AMVP-shaped pass against the left neighbour's pass-1
    MV.  Returns (By, Bx, 2) int32 full-pel MVs (multiples of 4)."""
    cur4 = cur[::4, ::4]
    ref4 = pyramid[0][::4, ::4].to(torch.int32)
    kw = dict(radius=SEARCH_R // 4, pad=interp.REF_PAD // 4,
              blk=ME_BLOCK // 4)
    mv4 = integer_search(cur4, ref4, lam, pen_scale=8.0, **kw)
    bx = mv4.shape[1]
    left = torch.from_numpy(np.maximum(np.arange(bx) - 1, 0)).to(cur.device)
    pred = mv4[:, left, :]
    mv4 = integer_search(cur4, ref4, lam, pred=pred,
                         lam_rate=float(lam) ** 0.5 * 2.0, **kw)
    return mv4 * 4


def block_sad(cur_blocks: torch.Tensor, pyramid: torch.Tensor,
              gx: torch.Tensor, gy: torch.Tensor, mvx: torch.Tensor,
              mvy: torch.Tensor) -> torch.Tensor:
    """(B,) int32 SADs of the 16x16 blocks at (gx, gy) against their MC
    predictions at quarter-pel MVs (mvx, mvy)."""
    ar = torch.arange(ME_BLOCK, device=pyramid.device)
    f = (mvy & 3) * 4 + (mvx & 3)
    iy = gy + interp.REF_PAD + (mvy >> 2)
    ix = gx + interp.REF_PAD + (mvx >> 2)
    assert int(iy.min()) >= 0 and int(ix.min()) >= 0
    assert int(iy.max()) + ME_BLOCK <= pyramid.shape[1]
    assert int(ix.max()) + ME_BLOCK <= pyramid.shape[2]
    pred = pyramid[f.long()[:, None, None],
                   (iy.long()[:, None, None] + ar[None, :, None]),
                   (ix.long()[:, None, None] + ar[None, None, :])]
    return (cur_blocks - pred.to(torch.int32)).abs().sum(
        (1, 2), dtype=torch.int32)


def refine_search_ref(cur: torch.Tensor, pyramid: torch.Tensor,
                      base: torch.Tensor) -> torch.Tensor:
    """The plain version of K5: stride-2 then stride-1 3x3 full-pel
    around ``base`` on the integer plane, then +-FRAC_D quarter-pel
    around that winner; the first minimum wins in list order.

    cur (H, W) int32 (ME_BLOCK multiples); base (By, Bx, 2) full-pel.
    Returns (By, Bx, 2) int32 quarter-pel MVs."""
    return refine_search_stages(cur, pyramid, base)[-1]


def refine_search_stages(cur: torch.Tensor, pyramid: torch.Tensor,
                         base: torch.Tensor):
    """refine_search_ref with the centre of each of its three searches:
    (base and the stride-2 winner, full-pel; the stride-1 winner and the
    result, quarter-pel), each (By, Bx, 2) int32."""
    h, w = cur.shape
    by, bx = h // ME_BLOCK, w // ME_BLOCK
    dev = cur.device
    gy, gx = torch.meshgrid(
        torch.arange(by, device=dev, dtype=torch.int32) * ME_BLOCK,
        torch.arange(bx, device=dev, dtype=torch.int32) * ME_BLOCK,
        indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    cur_blocks = cur.reshape(by, ME_BLOCK, bx, ME_BLOCK).permute(
        0, 2, 1, 3).reshape(-1, ME_BLOCK, ME_BLOCK).to(torch.int32)
    b = base.reshape(-1, 2).to(torch.int32)

    def pick(cands, deltas):
        k = torch.argmin(torch.stack(cands), dim=0)
        return torch.tensor(deltas, dtype=torch.int32, device=dev)[k]

    def sad(mvx, mvy):
        return block_sad(cur_blocks, pyramid, gx, gy, mvx, mvy)

    a = b + pick([sad((b[:, 0] + dx) * 4, (b[:, 1] + dy) * 4)
                  for dx, dy in _REF_DELTAS_A], _REF_DELTAS_A)
    ib = (a + pick([sad((a[:, 0] + dx) * 4, (a[:, 1] + dy) * 4)
                    for dx, dy in _REF_DELTAS_B], _REF_DELTAS_B)) * 4
    dq = pick([sad(ib[:, 0] + dx, ib[:, 1] + dy) for dx, dy in _QP_DELTAS],
              _QP_DELTAS)
    return tuple(v.reshape(by, bx, 2) for v in (b, a, ib, ib + dq))


def me_search(cur: torch.Tensor, pyramid: torch.Tensor, cfg,
              lam: float) -> torch.Tensor:
    """(H, W) current picture + (16, Hp, Wp) luma pyramid -> (By, Bx, 2)
    int32 quarter-pel MVs, By/Bx = ceil(H/16)/ceil(W/16).  The refine
    runs as K5 on CUDA tensors and as its plain version on CPU ones."""
    from x266_tpu_torch.kernels import me_cuda

    cur = _ceil_pad(cur.to(torch.int32)).contiguous()
    base = coarse_search(cur, pyramid, lam)
    bound = interp.mv_bounds(cfg, ME_BLOCK) - 8
    if cur.device.type == "cuda":
        mv = me_cuda.refine_search(cur, pyramid, base)
    elif cur.device.type == "cpu":
        mv = refine_search_ref(cur, pyramid, base)
    else:
        raise ValueError(f"unsupported device {cur.device}")
    return mv.clamp(-bound, bound)
