"""Device resolution and the float-precision guard.

The codec's normative math is exact integer arithmetic carried in
float64 matmuls (kernels/transforms.py) and int32 ops.  TF32 would round
float32 matmul operands to 10 mantissa bits and silently break any exact
float32 product, so on CUDA the process must run with TF32 off.
"""

from __future__ import annotations

import torch


def check_precision() -> None:
    """Raise unless float32 matmuls and convolutions run in full float32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be "
                           "False (exact integer transforms)")
    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError("torch.backends.cudnn.allow_tf32 must be False")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("torch.get_float32_matmul_precision() must be "
                           "'highest'")


def exact_float32() -> None:
    """Run this process's float32 matmuls and convolutions in full float32
    (TF32 off), as check_precision requires: for a program that owns its
    process, as the command line does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve(device: str | torch.device) -> torch.device:
    """Device string -> torch.device.  "cuda" requires a visible card
    and full float32 precision; no device is ever chosen implicitly."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        check_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
