"""Wrapper of the picture-SSE kernel, csrc/sse.cu: the float32 sum of
squared errors of each plane of F frames in the order XLA CPU gives the
reference's reduction (x266_tpu/engine/fused.py:483-486), and the exact
int64 sum (engine/fused.py ``frame_sse``), in one launch -- port-only,
ROADMAP queue 3, F4; no Pallas kernel computes it.

The plain versions are kernels/cost.py ``plane_sse_f32_plain`` and
``fused.frame_sse``; ``fused._sse_outputs`` and ``cost.plane_sse_f32``
route CUDA tensors here and keep CPU ones.  This wrapper launches the
kernel or raises -- it never falls back.

The kernel's scratch must be zero wherever no window sum lands, and its
tickets zero; the kernel leaves both so.  So each stream keeps one pair,
zeroed once, for each shape of call (``_WORK``).

LAUNCHES["SSE"] counts the wrapper's launches (one per call: the three
planes of F frames, every tree level and the int64 sum), so a run can
show that its main path went through it.
"""

from __future__ import annotations

import torch

from x266_tpu_torch import _build

LAUNCHES = {"SSE": 0}
WINDOW = 32             # csrc/sse.cu kWin
MAX_SIDE = WINDOW ** 3  # two window levels (csrc/sse.cu kMaxSide)
_WORK: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _dim(d: int) -> tuple[int, int]:
    """One dimension of a window level: (window length, window count)."""
    return (d, 1) if d <= WINDOW else (WINDOW, -(-d // WINDOW))


def _blocks(h: int, w: int) -> tuple[int, int, int] | None:
    """A plane's blocks of level-1 sums (csrc/sse.cu make_plane): (count,
    rows, pitch), or None for a plane of at most 32 x 32."""
    if h <= WINDOW and w <= WINDOW:
        return None
    (wh, nh), (ww, nw) = _dim(_dim(h)[1]), _dim(_dim(w)[1])
    return nh * nw, wh, -(-ww // 4) * 4


def scratch_floats(shapes) -> int:
    """Floats of scratch a frame of planes of these (h, w) shapes takes:
    per plane with a window level, its level-1 sums blocked by the next
    level's windows (rows padded to 4 floats) and its level-2 sums,
    rounded up to 4 (csrc/sse.cu scratch_floats)."""
    total = 0
    for h, w in shapes:
        b = _blocks(h, w)
        if b is not None:
            total += b[0] * b[1] * b[2] + -(-b[0] // 4) * 4
    return total


def new_work(frames: int, shapes, device) -> tuple:
    """A zeroed (scratch, tickets) pair for calls of this shape: the
    tickets are a row per (frame, plane) of the plane's ticket, its int64
    sum and a ticket per block."""
    blocks = max((b[0] for b in (_blocks(h, w) for h, w in shapes) if b),
                 default=1)
    scratch = torch.zeros(max(1, frames * scratch_floats(shapes)),
                          dtype=torch.float32, device=device)
    tickets = torch.zeros((frames * len(shapes), 2 + blocks),
                          dtype=torch.int64, device=device)
    return scratch, tickets


def _launch(lib, stream, recs, origs, work):
    """Call the entry point on checked planes with work = (scratch,
    tickets); returns (error code, ((F, P) float32, (F, P) int64))."""
    f = origs[0].shape[0]
    dev = origs[0].device
    scratch, tickets = work
    out = torch.empty((f, len(origs)), dtype=torch.float32, device=dev)
    exact = torch.empty((f, len(origs)), dtype=torch.int64, device=dev)
    args = []
    for q in range(3):
        r, o = (recs[q], origs[q]) if q < len(origs) else (recs[0], origs[0])
        args += [o.shape[1], o.shape[2], r.data_ptr(), o.data_ptr()]
    code = lib.x266_picture_sse(f, len(origs), *args, scratch.data_ptr(),
                                scratch.numel(), tickets.data_ptr(),
                                tickets.numel(), out.data_ptr(),
                                exact.data_ptr(), stream)
    return code, (out, exact)


def _check(recs, origs) -> None:
    if not 1 <= len(origs) <= 3 or len(recs) != len(origs):
        raise ValueError(f"expected 1 to 3 pairs of planes, got "
                         f"{len(recs)} and {len(origs)}")
    for name, planes in (("rec", recs), ("orig", origs)):
        for x in planes:
            if x.device.type != "cuda":
                raise ValueError(f"{name}: expected a CUDA tensor, got "
                                 f"{x.device}")
            if x.dtype != torch.uint8 or not x.is_contiguous():
                raise ValueError(f"{name}: expected contiguous uint8, got "
                                 f"{x.dtype} of strides {x.stride()}")
    f = origs[0].shape[0]
    for r, o in zip(recs, origs):
        if (r.shape != o.shape or o.dim() != 3 or o.shape[0] != f
                or r.device != origs[0].device or o.device != r.device):
            raise ValueError(f"expected (F, H, W) planes of one frame count "
                             f"on one device, rec and orig of one shape; "
                             f"got {tuple(r.shape)} and {tuple(o.shape)}")
        if max(o.shape[1:]) > MAX_SIDE or min(o.shape) < 1:
            raise ValueError(f"plane {tuple(o.shape)}: sides of 1 to "
                             f"{MAX_SIDE} are supported")


def picture_sse(rec_planes, src_planes) -> tuple:
    """The step's SSE on the card: rec_planes and src_planes, 1 to 3
    contiguous uint8 CUDA tensors each, (F, H, W) per plane (the planes
    may differ in size) -> (sse (F, P) float32 in the reference's order,
    sse_exact (F, P) int64), one launch."""
    recs, origs = list(rec_planes), list(src_planes)
    _check(recs, origs)
    lib = _build.LIBRARY.build()
    dev = origs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = (dev, stream, origs[0].shape[0],
               tuple(tuple(o.shape[1:]) for o in origs))
        if key not in _WORK:
            _WORK[key] = new_work(key[2], key[3], dev)
        code, out = _launch(lib, stream, recs, origs, _WORK[key])
    _build.check(code)
    LAUNCHES["SSE"] += 1
    return out
