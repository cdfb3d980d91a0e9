"""Wrappers of the ALF estimator's CUDA kernels, csrc/alf.cu: the
per-class normal equations in XLA CPU's float32 order and their float32
solve, from the post-SAO recon and the source, for every kind of feature
-- the linear and the clipped (nonlinear) diamonds, the 12 aligned by the
transposes, and CC-ALF's from the luma (``normal_solve``,
``cc_normal_solve``) -- the per-CTB on/off decision from the per-CTB SSEs
in XLA's reduction order, with CC-ALF's whole-filter gate
(``ctb_flags``, ``ccalf_gate``), and the nonlinear estimator's per-class
SSE of 4x4 blocks (``class_sse``) -- port-only, ROADMAP queue 3, F9; no
Pallas kernel computes them.  The kernels form the features themselves
and sum in int32 wherever the terms' magnitudes add up to at most 2^24
(float32 is exact there in any order); only the rest runs the fixed
float32 order, inside the kernels.

The plain versions are kernels/alf.py (``normal_solve_plain``,
``cc_normal_solve_plain``, ``_ctb_flags``, ``_ccalf_gate``,
``ctb_sse_plain``, ``class_sse_plain``), which route CUDA tensors here
and keep CPU ones.  These wrappers launch their kernel or raise -- they
never fall back.

CC-ALF's gate runs at the end of the CTB kernel's launch, in the block
that takes the last of a ticket, and the class SSE's chain totals are
read and reset by its last kernel: both scratch buffers must be 0 before
a call and are left so.  So each stream keeps one pair, zeroed once
(``_WORK``).  The class SSE reads the filtered levels as uint8.

LAUNCHES counts each wrapper's calls ("ALF": one call of the normal
equations' kernels -- the block sums, totals and solve; "ALFSSE": one
launch of the CTB decision kernel, with CC-ALF's gate at its end;
"ALFCLS": one call of the class-SSE kernels), so a run can show that its
main path went through them.
"""

from __future__ import annotations

import numpy as np
import torch

from x266_tpu_torch import _build
from x266_tpu_torch.kernels import alf

LAUNCHES = {"ALF": 0, "ALFSSE": 0, "ALFCLS": 0}
SEGMENT = 8192          # samples per plane segment (csrc/alf.cu kSegment)
CHUNK_BLOCKS = 128      # blocks per chunk of the totals (kChunkBlocks)
CLASS_LANES = 16        # lanes of a class-SSE chain total (kClsLanes)
MAX_LEVELS = 4          # filtered levels a class-SSE call (kMaxLevels)
_WORK: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def new_work(device) -> tuple:
    """A zeroed (ticket (1,), chain totals (4 * 25 * 16,)) int64 pair: the
    gate's ticket and the class SSE's (level, class, lane) totals."""
    return (torch.zeros(1, dtype=torch.int64, device=device),
            torch.zeros(MAX_LEVELS * alf.NUM_CLASSES * CLASS_LANES,
                        dtype=torch.int64, device=device))


def _work(dev, stream) -> tuple:
    key = (dev, stream)
    if key not in _WORK:
        _WORK[key] = new_work(dev)
    return _WORK[key]


def _orders(kind: str):
    out = []
    for q in ("gram", "rhs"):
        block, lanes, how = alf.SUM_ORDERS[f"{kind}_{q}"]
        out += [block, lanes, int(how == "halves")]
    return out


def _check(name, x):
    if x is not None and x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")


def _launch(lib, stream, recon, orig, cls, tmap=None, clip=0, luma=None):
    """Allocate the scratch and outputs and call the entry point on int32
    contiguous planes; returns (error code, (coef, gram, rhs, stats)).
    With luma (CC-ALF), recon is the chroma plane the error is taken
    against and the features come from luma."""
    h, w = orig.shape
    n, dev = h * w, orig.device
    kind = ("cc" if luma is not None else "luma" if cls is not None
            else "chroma")
    t = {"cc": 7, "luma": 12, "chroma": 6}[kind]
    nc = alf.NUM_CLASSES if cls is not None else 1
    orders = _orders(kind)
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

    def ptr(x):
        return None if x is None else x.data_ptr()

    lh, lw = (0, 0) if luma is None else luma.shape
    err_code = lib.x266_alf_normal(
        h, w, t, nc, recon.data_ptr(), orig.data_ptr(), ptr(cls), ptr(tmap),
        int(clip or 0), ptr(luma), recon.data_ptr() if luma is not None
        else None, lh, lw, *orders,
        part_g.data_ptr(), part_r.data_ptr(), block_ordered.data_ptr(),
        chunk.data_ptr(), segs.data_ptr(), terms.data_ptr(), gram.data_ptr(),
        rhs.data_ptr(), coef.data_ptr(), stats.data_ptr(), stream)
    return err_code, (coef, gram, rhs, stats)


def _planes(*xs):
    return [None if x is None else x.to(torch.int32).contiguous()
            for x in xs]


def _run_normal(recon, orig, cls, tmap, clip, luma):
    lib = _build.LIBRARY.build()
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        code, out = _launch(lib, stream, *_planes(recon, orig, cls, tmap),
                            clip, *_planes(luma))
    _build.check(code)
    LAUNCHES["ALF"] += 1
    return out


def _results(out, with_sums, with_stats):
    if with_stats:
        return out
    return out[:3] if with_sums else out[0]


def normal_solve(recon, orig, cls=None, with_sums: bool = False,
                 bit_depth: int = 8, with_stats: bool = False, clip=None,
                 transpose=None):
    """alf.normal_solve on the card: recon and orig (H, W), cls (H/4,
    W/4) or None (chroma), integer CUDA tensors of 8-bit samples; clip, a
    clip value (the nonlinear estimators), and transpose (H/4, W/4, luma
    only), the block transposes the features are aligned by.
    Returns the coefficients (C, T) int32; with_sums also the float32
    gram (C, T, T) and rhs (C, T); with_stats then also the (4,) int32
    counts of (class, entry) chains of blocks (or of the whole plane's
    lanes) summed exactly and in order, and of (class, entry) totals
    over blocks summed exactly and in order."""
    for name, x in (("recon", recon), ("orig", orig), ("cls", cls),
                    ("transpose", transpose)):
        _check(name, x)
    if bit_depth != 8:
        raise ValueError("the ALF kernel's int32 sums hold 8-bit samples")
    h, w = recon.shape
    if orig.shape != recon.shape or h % 4 or w % 4 or (h * w) % 8:
        raise ValueError(f"expected two planes of one shape, sides multiples "
                         f"of 4, got {tuple(recon.shape)} and "
                         f"{tuple(orig.shape)}")
    for name, x in (("cls", cls), ("transpose", transpose)):
        if x is not None and tuple(x.shape) != (h // 4, w // 4):
            raise ValueError(f"{name}: expected ({h // 4}, {w // 4}), got "
                             f"{tuple(x.shape)}")
    if transpose is not None and cls is None:
        raise ValueError("transposes align the luma features only")
    out = _run_normal(recon, orig, cls, transpose, clip, None)
    return _results(out, with_sums, with_stats)


def cc_normal_solve(luma, c, orig_c, with_sums: bool = False,
                    with_stats: bool = False):
    """alf.cc_normal_solve on the card: luma (H, W), c and orig_c (H/2,
    W/2) integer CUDA tensors of 8-bit samples.  Returns the coefficients
    (1, 7) int32, with_sums and with_stats as normal_solve's."""
    for name, x in (("luma", luma), ("c", c), ("orig_c", orig_c)):
        _check(name, x)
    h, w = c.shape
    if (orig_c.shape != c.shape or tuple(luma.shape) != (2 * h, 2 * w)
            or h % 4 or w % 4 or (h * w) % 8):
        raise ValueError(f"expected a chroma plane and its source of one "
                         f"shape, sides multiples of 4, and a luma plane of "
                         f"twice their sides, got {tuple(c.shape)}, "
                         f"{tuple(orig_c.shape)} and {tuple(luma.shape)}")
    out = _run_normal(c, orig_c, None, None, 0, luma)
    return _results(out, with_sums, with_stats)


def sse_mode(ctb: int, width: int) -> int:
    """The kernel's order for a CTB size and plane width (alf.ctb_sse)."""
    if ctb == 64:
        return 0
    if ctb != 32:
        raise ValueError(f"XLA's CTB-SSE order is pinned for 64 and 32, "
                         f"got {ctb}")
    return 1 if width % 32 == 0 else 2


def _launch_flags(lib, stream, filt, recon, orig, ctb, lam, extras=True,
                  worth=None, ticket=None):
    """Call the CTB entry point on int32 contiguous planes; returns (error
    code, (flags (Cy, Cx) int32, and with extras the SSEs (2, Cy, Cx)
    float32 and the (2,) int32 counts of windows summed exactly and in
    order, else None, None)).  worth, a (1,) int32 tensor: CC-ALF's gate
    writes its decision there (the kernel then keeps the CTBs' kept gains
    where the SSEs would go, which are not returned); ticket, new_work's
    (1,) int64 ticket, is then the launch's."""
    h, w = orig.shape
    dev = orig.device
    cy, cx = -(-h // ctb), -(-w // ctb)
    flags = torch.empty((cy, cx), dtype=torch.int32, device=dev)
    sse = stats = None
    if extras or worth is not None:
        sse = torch.empty((2, cy, cx), dtype=torch.float32, device=dev)
    if extras:
        stats = torch.zeros(2, dtype=torch.int32, device=dev)
    code = lib.x266_alf_ctb_flags(
        h, w, sse_mode(ctb, w), float(np.float32(lam * 1.5)),
        filt.data_ptr(), recon.data_ptr(), orig.data_ptr(), flags.data_ptr(),
        None if sse is None else sse.data_ptr(),
        None if stats is None else stats.data_ptr(),
        alf._gate_constant(lam, cy, cx),
        None if worth is None else worth.data_ptr(),
        None if ticket is None else ticket.data_ptr(), stream)
    return code, (flags, sse if extras else None, stats)


def _flags(filt, recon, orig, ctb, lam, extras, worth=None):
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
        ticket = None if worth is None else _work(orig.device, stream)[0]
        code, out = _launch_flags(lib, stream, *_planes(filt, recon, orig),
                                  ctb, lam, extras, worth, ticket)
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


def ccalf_gate(filt, c, orig_c, lam: float):
    """alf.ccalf_gate on the card: filt, c and orig_c (H, W) integer CUDA
    tensors (32x32 CTBs); (flags (Cy, Cx) int32, worth () bool), in one
    launch of the CTB kernel, whose last block runs the gate, without a
    host sync."""
    worth = torch.empty(1, dtype=torch.int32, device=orig_c.device)
    flags = _flags(filt, c, orig_c, 32, lam, False, worth)[0]
    return flags, worth[0] > 0


def _launch_class(lib, stream, filt, orig, cls, tot, with_stats=True):
    """Call the class-SSE entry point on filt (L, H, W) uint8, orig (H, W)
    and cls (H/4, W/4) int32, contiguous and 16-byte aligned, with tot,
    new_work's zeroed chain totals; returns (error code, (sse (L, 25)
    float32, with_stats the (2,) int32 counts of lane chains exact and
    with an ordered tail, else None))."""
    lv, h, w = filt.shape
    dblk = torch.empty(lv * (h // 4) * (w // 4), dtype=torch.int32,
                       device=orig.device)
    out = torch.empty((lv, alf.NUM_CLASSES), dtype=torch.float32,
                      device=orig.device)
    stats = (torch.zeros(2, dtype=torch.int32, device=orig.device)
             if with_stats else None)
    code = lib.x266_alf_class_sse(lv, h, w, filt.data_ptr(), orig.data_ptr(),
                                  cls.data_ptr(), dblk.data_ptr(),
                                  tot.data_ptr(), out.data_ptr(),
                                  None if stats is None else stats.data_ptr(),
                                  stream)
    return code, (out, stats)


def _aligned(x):
    """x, or a copy of it where its data is not 16-byte aligned."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def class_sse(filt, orig, cls, with_stats: bool = False):
    """alf.class_sse on the card: filt (L, H, W) uint8 (L <= 4: the
    filtered levels of 8-bit samples), orig (H, W) and cls (H/4, W/4)
    integer CUDA tensors; (L, 25) float32, and with_stats the (2,) int32
    counts of lane chains summed exactly and with an ordered tail."""
    for name, x in (("filt", filt), ("orig", orig), ("cls", cls)):
        _check(name, x)
    lv, h, w = filt.shape
    if (tuple(orig.shape) != (h, w) or tuple(cls.shape) != (h // 4, w // 4)
            or h % 4 or w % 4):
        raise ValueError(f"expected planes (L, H, W), (H, W) and (H/4, W/4) "
                         f"with sides multiples of 4, got {tuple(filt.shape)}"
                         f", {tuple(orig.shape)} and {tuple(cls.shape)}")
    if filt.dtype != torch.uint8 or not 1 <= lv <= MAX_LEVELS:
        raise ValueError(f"the class-SSE kernel reads 1 to {MAX_LEVELS} "
                         f"levels of uint8, got {lv} of {filt.dtype}")
    lib = _build.LIBRARY.build()
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        f, o, c = (_aligned(x) for x in (filt.contiguous(),
                                         *_planes(orig, cls)))
        code, out = _launch_class(lib, stream, f, o, c,
                                  _work(orig.device, stream)[1], with_stats)
    _build.check(code)
    LAUNCHES["ALFCLS"] += 1
    return out if with_stats else out[0]
