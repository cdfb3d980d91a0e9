"""Wrappers of the ALF estimator's CUDA kernels, csrc/alf.cu: the
per-class normal equations in XLA CPU's float32 order and their float32
solve, from the post-SAO recon and the source (``normal_solve``), and
the per-CTB on/off decision from the per-CTB SSEs in XLA's reduction
order (``ctb_flags``) -- port-only, ROADMAP queue 3, F9; no Pallas
kernel computes them.  The kernels form the diamond features themselves
and sum in int32 wherever the terms' magnitudes add up to at most 2^24
(float32 is exact there in any order); only the rest runs the fixed
float32 order, inside the kernels.

The plain versions are kernels/alf.py (``normal_solve_plain``,
``_ctb_flags``, ``ctb_sse_plain``), which route CUDA tensors here and
keep CPU ones.  These wrappers launch their kernel or raise -- they
never fall back.

LAUNCHES counts each wrapper's calls ("ALF": one call of the normal
equations' kernels -- the block sums, totals and solve; "ALFSSE": one
launch of the CTB decision kernel), so a run can show that its main path
went through them.
"""

from __future__ import annotations

import numpy as np
import torch

from x266_tpu_torch import _build
from x266_tpu_torch.kernels import alf

LAUNCHES = {"ALF": 0, "ALFSSE": 0}
SEGMENT = 8192          # samples per plane segment (csrc/alf.cu kSegment)
CHUNK_BLOCKS = 128      # blocks per chunk of the totals (kChunkBlocks)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _orders(luma: bool):
    kind = "luma" if luma else "chroma"
    out = []
    for q in ("gram", "rhs"):
        block, lanes, how = alf.SUM_ORDERS[f"{kind}_{q}"]
        out += [block, lanes, int(how == "halves")]
    return out


def _check(name, x):
    if x is not None and x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")


def _launch(lib, stream, recon, orig, cls):
    """Allocate the scratch and outputs and call the entry point on int32
    contiguous planes; returns (error code, (coef, gram, rhs, stats))."""
    h, w = recon.shape
    n, dev = h * w, recon.device
    luma = cls is not None
    t = len(alf.DIAMOND if luma else alf.CHROMA_DIAMOND)
    nc = alf.NUM_CLASSES if luma else 1
    orders = _orders(luma)
    nb = [-(-n // min(blk, n)) if blk else 1 for blk in orders[0::3]]

    def scratch(size, dtype):
        return torch.empty(max(size, 1), dtype=dtype, device=dev)

    part_g = scratch(nb[0] * nc * t * (t + 1) // 2, torch.float32)
    part_r = scratch(nb[1] * nc * t if orders[3] else 0, torch.float32)
    block_ordered = scratch(max(nb), torch.int32)
    chunk = scratch(-(-nb[0] // CHUNK_BLOCKS) * nc * t * (t + 1), torch.int64)
    plane = not orders[3]         # the rhs's lanes run over the whole plane
    segs = scratch(-(-n // SEGMENT) * 2 * t * orders[4] if plane else 0,
                   torch.int32)
    terms = scratch(t * n if plane else 0, torch.float32)
    gram = torch.empty((nc, t, t), dtype=torch.float32, device=dev)
    rhs = torch.empty((nc, t), dtype=torch.float32, device=dev)
    coef = torch.empty((nc, t), dtype=torch.int32, device=dev)
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    err_code = lib.x266_alf_normal(
        h, w, t, nc, recon.data_ptr(), orig.data_ptr(),
        None if cls is None else cls.data_ptr(), *orders,
        part_g.data_ptr(), part_r.data_ptr(), block_ordered.data_ptr(),
        chunk.data_ptr(), segs.data_ptr(), terms.data_ptr(), gram.data_ptr(),
        rhs.data_ptr(), coef.data_ptr(), stats.data_ptr(), stream)
    return err_code, (coef, gram, rhs, stats)


def _planes(*xs):
    return [None if x is None else x.to(torch.int32).contiguous()
            for x in xs]


def normal_solve(recon, orig, cls=None, with_sums: bool = False,
                 bit_depth: int = 8, with_stats: bool = False):
    """alf.normal_solve on the card: recon and orig (H, W), cls (H/4,
    W/4) or None (chroma), integer CUDA tensors of 8-bit samples.
    Returns the coefficients (C, T) int32; with_sums also the float32
    gram (C, T, T) and rhs (C, T); with_stats then also the (4,) int32
    counts of (class, entry) chains of blocks (or of the whole plane's
    lanes) summed exactly and in order, and of (class, entry) totals
    over blocks summed exactly and in order."""
    for name, x in (("recon", recon), ("orig", orig), ("cls", cls)):
        _check(name, x)
    if bit_depth != 8:
        raise ValueError("the ALF kernel's int32 sums hold 8-bit samples")
    h, w = recon.shape
    if orig.shape != recon.shape or h % 4 or w % 4 or (h * w) % 8:
        raise ValueError(f"expected two planes of one shape, sides multiples "
                         f"of 4, got {tuple(recon.shape)} and "
                         f"{tuple(orig.shape)}")
    if cls is not None and tuple(cls.shape) != (h // 4, w // 4):
        raise ValueError(f"cls: expected ({h // 4}, {w // 4}), got "
                         f"{tuple(cls.shape)}")
    lib = _build.LIBRARY.build()
    with torch.cuda.device(recon.device):
        stream = torch.cuda.current_stream(recon.device).cuda_stream
        code, out = _launch(lib, stream, *_planes(recon, orig, cls))
    _build.check(code)
    LAUNCHES["ALF"] += 1
    if with_stats:
        return out
    return out[:3] if with_sums else out[0]


def sse_mode(ctb: int, width: int) -> int:
    """The kernel's order for a CTB size and plane width (alf.ctb_sse)."""
    if ctb == 64:
        return 0
    if ctb != 32:
        raise ValueError(f"XLA's CTB-SSE order is pinned for 64 and 32, "
                         f"got {ctb}")
    return 1 if width % 32 == 0 else 2


def _launch_flags(lib, stream, filt, recon, orig, ctb, lam, extras=True):
    """Call the CTB entry point on int32 contiguous planes; returns (error
    code, (flags (Cy, Cx) int32, and with extras the SSEs (2, Cy, Cx)
    float32 and the (2,) int32 counts of windows summed exactly and in
    order, else None, None))."""
    h, w = orig.shape
    dev = orig.device
    cy, cx = -(-h // ctb), -(-w // ctb)
    flags = torch.empty((cy, cx), dtype=torch.int32, device=dev)
    sse = stats = None
    if extras:
        sse = torch.empty((2, cy, cx), dtype=torch.float32, device=dev)
        stats = torch.zeros(2, dtype=torch.int32, device=dev)
    code = lib.x266_alf_ctb_flags(
        h, w, sse_mode(ctb, w), float(np.float32(lam * 1.5)),
        filt.data_ptr(), recon.data_ptr(), orig.data_ptr(), flags.data_ptr(),
        None if sse is None else sse.data_ptr(),
        None if stats is None else stats.data_ptr(), stream)
    return code, (flags, sse, stats)


def _flags(filt, recon, orig, ctb, lam, extras):
    for name, x in (("filt", filt), ("recon", recon), ("orig", orig)):
        _check(name, x)
    if (not (filt.shape == recon.shape == orig.shape) or orig.dim() != 2
            or orig.shape[1] % 4):
        raise ValueError(f"expected three planes of one shape, a width "
                         f"that is a multiple of 4, got "
                         f"{tuple(filt.shape)}, {tuple(recon.shape)} and "
                         f"{tuple(orig.shape)}")
    lib = _build.LIBRARY.build()
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        code, out = _launch_flags(lib, stream, *_planes(filt, recon, orig),
                                  ctb, lam, extras)
    _build.check(code)
    LAUNCHES["ALFSSE"] += 1
    return out


def ctb_flags(filt, recon, orig, ctb: int, lam: float,
              with_stats: bool = False):
    """alf.ctb_flags on the card: filt, recon and orig (H, W) integer CUDA
    tensors; (Cy, Cx) int32 flags, and with_stats the (2,) int32 counts
    of CTB windows summed exactly and in order."""
    flags, _, stats = _flags(filt, recon, orig, ctb, lam, with_stats)
    return (flags, stats) if with_stats else flags


def ctb_sse(a, orig, ctb: int) -> torch.Tensor:
    """alf.ctb_sse on the card (the CTB kernel's SSE of a against orig):
    (Cy, Cx) float32."""
    return _flags(a, a, orig, ctb, 0.0, True)[1][0]
