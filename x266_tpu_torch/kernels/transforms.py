"""Batched integer transforms (C10): DCT-II / DST-VII / DCT-VIII, 4-32,
and the 64-point DCT-II with its high-frequency zero-out.

Counterpart of x266_tpu/kernels/transforms.py.  A transform of B blocks
is two matmuls against the (s, s) integer matrix.  The reference splits
int32 data into 11-bit f32 limbs so the TPU's f32 MXU stays exact; here
the operands go through float64, exact when every partial sum is an
integer below 2^53: |data| < 2^31, matrix entries <= 255 and s <= 64
keep them below 2^45.  At s = 64 the entries are at most 90 and the
sums far smaller: with 8-bit residuals the forward's first stage is at
most 255 * 90 * 64 < 2^21 and its second 2^15 * 90 * 64 < 2^29; the
inverse's stages, on 16-bit clipped inputs, at most 2^15 * 90 * 64 <
2^29.  float64 matmuls also run on CUDA, where torch has no integer
matmul.  A 64-point forward keeps only its low ZO64 x ZO64 band (the
coded one), as the reference's.
"""

from __future__ import annotations

import torch

from x266_tpu_torch.specmodel import transforms as spec

from x266_tpu_torch.tables import Tables


def _rshift_round(x: torch.Tensor, shift: int) -> torch.Tensor:
    return (x + (1 << (shift - 1))) >> shift


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer-valued operands via float64."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def forward_transform(tab: Tables, residual: torch.Tensor, size: int,
                      tx_v: int = spec.TX_DCT2, tx_h: int = spec.TX_DCT2,
                      bit_depth: int = 8) -> torch.Tensor:
    """(B, s, s) int32 residual -> (B, s, s) int32 coefficients.
    HM shift schedule: log2s + bit_depth - 9, then log2s + 6."""
    log2s = size.bit_length() - 1
    tv = tab.tx[(tx_v, size)]
    th = tab.tx[(tx_h, size)]
    tmp = _rshift_round(_mm(tv, residual), log2s + bit_depth - 9)  # T @ X
    coef = _rshift_round(_mm(tmp, th.T), log2s + 6)                # . @ T^T
    coef = coef.clamp(-32768, 32767)
    if size == 64:
        # the 64-point zero-out: only the low band is kept (and coded)
        z = spec.ZO64
        coef[..., z:, :] = 0
        coef[..., :z, z:] = 0
    return coef


def inverse_transform(tab: Tables, coef: torch.Tensor, size: int,
                      tx_v: int = spec.TX_DCT2, tx_h: int = spec.TX_DCT2,
                      bit_depth: int = 8) -> torch.Tensor:
    """Normative inverse [STD]: shifts 7 then 20 - bit_depth."""
    tv = tab.tx[(tx_v, size)]
    th = tab.tx[(tx_h, size)]
    tmp = _rshift_round(_mm(tv.T, coef), 7).clamp(-32768, 32767)  # T^T @ C
    res = _rshift_round(_mm(tmp, th), 20 - bit_depth)              # . @ T
    return res.clamp(-32768, 32767)
