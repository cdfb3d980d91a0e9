"""Wrappers of the ALF estimator's CUDA kernels, csrc/alf.cu: the
per-class normal equations in XLA CPU's float32 order and their float32
solve (``normal_solve``), and the per-CTB SSE of the on/off decision in
XLA's reduction order (``ctb_sse``) -- port-only, ROADMAP queue 3, F9; no
Pallas kernel computes them.

The plain versions are kernels/alf.py (``normal_sums`` and
``coefficients``; ``ctb_sse``), which route CUDA tensors here and keep
CPU ones.  These wrappers launch their kernel or raise -- they never fall
back.

LAUNCHES counts each wrapper's calls ("ALF": one launch of the normal
equations' kernels -- the two sums' passes and the solve; "ALFSSE": one
launch of the SSE kernel), so a run can show that its main path went
through them.
"""

from __future__ import annotations

import torch

from x266_tpu_torch import _build
from x266_tpu_torch.kernels import alf

LAUNCHES = {"ALF": 0, "ALFSSE": 0}


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


def _launch(lib, stream, feats, err, cls_px, n_classes):
    """Allocate the scratch and outputs and call the entry point on
    checked tensors; returns (error code, (coef, gram, rhs))."""
    t = feats.shape[0]
    n = err.numel()
    dev = feats.device
    f = feats.reshape(t, n).to(torch.int32).contiguous()
    e = err.reshape(n).to(torch.int32).contiguous()
    c = None if cls_px is None else cls_px.reshape(n).to(
        torch.int32).contiguous()
    orders = _orders(c is not None)
    nb = [-(-n // (blk if 0 < blk < n else n)) for blk in orders[0::3]]
    part_g = torch.empty(nb[0] * n_classes * t * t, dtype=torch.float32,
                         device=dev)
    part_r = torch.empty(nb[1] * n_classes * t, dtype=torch.float32,
                         device=dev)
    gram = torch.empty((n_classes, t, t), dtype=torch.float32, device=dev)
    rhs = torch.empty((n_classes, t), dtype=torch.float32, device=dev)
    coef = torch.empty((n_classes, t), dtype=torch.int32, device=dev)
    err_code = lib.x266_alf_normal(
        t, n, n_classes, f.data_ptr(), e.data_ptr(),
        None if c is None else c.data_ptr(), *orders, part_g.data_ptr(),
        part_r.data_ptr(), gram.data_ptr(), rhs.data_ptr(), coef.data_ptr(),
        stream)
    return err_code, (coef, gram, rhs)


def normal_solve(feats, err, cls_px=None, n_classes: int = 1,
                 with_sums: bool = False):
    """alf.normal_solve on the card: feats (T, H, W), err (H, W) and
    cls_px (H, W) integer CUDA tensors.  Returns the coefficients (C, T)
    int32, and with_sums also the float32 gram (C, T, T) and rhs (C, T)."""
    for name, x in (("feats", feats), ("err", err), ("cls_px", cls_px)):
        if x is not None and x.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{x.device}")
    n = err.numel()
    if feats.shape[0] > 12 or n % 8 or feats[0].numel() != n:
        raise ValueError(f"ALF sums take up to 12 feature planes of the "
                         f"error's size, a multiple of 8 samples; got "
                         f"{tuple(feats.shape)} and {tuple(err.shape)}")
    if cls_px is not None and cls_px.numel() != n:
        raise ValueError("cls_px: expected one class per sample")
    lib = _build.LIBRARY.build()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        code, out = _launch(lib, stream, feats, err, cls_px, n_classes)
    _build.check(code)
    LAUNCHES["ALF"] += 1
    return out if with_sums else out[0]


def sse_mode(ctb: int, width: int) -> int:
    """The kernel's order for a CTB size and plane width (alf.ctb_sse)."""
    if ctb == 64:
        return 0
    if ctb != 32:
        raise ValueError(f"XLA's CTB-SSE order is pinned for 64 and 32, "
                         f"got {ctb}")
    return 1 if width % 32 == 0 else 2


def _launch_sse(lib, stream, a, orig, ctb):
    """Call the SSE entry point on int32 contiguous planes; returns
    (error code, (Cy, Cx) float32)."""
    h, w = orig.shape
    out = torch.empty((-(-h // ctb), -(-w // ctb)), dtype=torch.float32,
                      device=orig.device)
    code = lib.x266_alf_ctb_sse(h, w, sse_mode(ctb, w), a.data_ptr(),
                                orig.data_ptr(), out.data_ptr(), stream)
    return code, out


def ctb_sse(a, orig, ctb: int) -> torch.Tensor:
    """alf.ctb_sse on the card: a and orig (H, W) integer CUDA tensors;
    (Cy, Cx) float32."""
    for name, x in (("a", a), ("orig", orig)):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{x.device}")
    if a.shape != orig.shape or a.dim() != 2:
        raise ValueError(f"expected two planes of one shape, got "
                         f"{tuple(a.shape)} and {tuple(orig.shape)}")
    lib = _build.LIBRARY.build()
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        a32, o32 = a.to(torch.int32).contiguous(), orig.to(
            torch.int32).contiguous()
        code, out = _launch_sse(lib, stream, a32, o32, ctb)
    _build.check(code)
    LAUNCHES["ALFSSE"] += 1
    return out
