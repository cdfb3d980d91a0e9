"""Wrapper of the picture-SSE kernel, csrc/sse.cu: each plane's float32
sum of squared errors in the order XLA CPU gives the reference's
reduction (x266_tpu/engine/fused.py:483-486) -- port-only, ROADMAP queue
3, F4; no Pallas kernel computes it.

The plain version is kernels/cost.py ``plane_sse_f32_plain``;
``cost.plane_sse_f32`` routes CUDA tensors here and keeps CPU ones.
This wrapper launches the kernel or raises -- it never falls back.

LAUNCHES["SSE"] counts the wrapper's calls (one per plane: a launch per
tree level and one for the last reduction), so a run can show that its
main path went through it.
"""

from __future__ import annotations

import torch

from x266_tpu_torch import _build

LAUNCHES = {"SSE": 0}
WINDOW = 32             # csrc/sse.cu kWin


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(lib, stream, rec, orig):
    """Allocate the scratch and the output and call the entry point on
    checked planes; returns (error code, (N,) float32)."""
    n, h, w = orig.shape
    dev = orig.device
    cells = n * -(-h // WINDOW) * -(-w // WINDOW)
    scratch = torch.empty((2, cells), dtype=torch.float32, device=dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    code = lib.x266_plane_sse(n, h, w, rec.data_ptr(), orig.data_ptr(),
                              scratch[0].data_ptr(), scratch[1].data_ptr(),
                              out.data_ptr(), stream)
    return code, out


def plane_sse(rec: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    """cost.plane_sse_f32 on the card: rec and orig (N, H, W) uint8
    contiguous CUDA tensors of one shape -> (N,) float32."""
    for name, x in (("rec", rec), ("orig", orig)):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{x.device}")
        if x.dtype != torch.uint8 or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous uint8, got "
                             f"{x.dtype} of strides {x.stride()}")
    if rec.shape != orig.shape or orig.dim() != 3:
        raise ValueError(f"expected two (N, H, W) planes of one shape, got "
                         f"{tuple(rec.shape)} and {tuple(orig.shape)}")
    lib = _build.LIBRARY.build()
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        code, out = _launch(lib, stream, rec, orig)
    _build.check(code)
    LAUNCHES["SSE"] += 1
    return out
