"""Batched integer transforms (C10): DCT-II / DST-VII / DCT-VIII, 4-32.

Counterpart of x266_tpu/kernels/transforms.py.  A transform of B blocks
is two matmuls against the (s, s) integer matrix.  The reference splits
int32 data into 11-bit f32 limbs so the TPU's f32 MXU stays exact; here
the operands go through float64, exact because |data| < 2^31, matrix
entries <= 255 and s <= 32 keep every partial sum below 2^45 < 2^53.
float64 matmuls also run on CUDA, where torch has no integer matmul.
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
    return coef.clamp(-32768, 32767)


def inverse_transform(tab: Tables, coef: torch.Tensor, size: int,
                      tx_v: int = spec.TX_DCT2, tx_h: int = spec.TX_DCT2,
                      bit_depth: int = 8) -> torch.Tensor:
    """Normative inverse [STD]: shifts 7 then 20 - bit_depth."""
    tv = tab.tx[(tx_v, size)]
    th = tab.tx[(tx_h, size)]
    tmp = _rshift_round(_mm(tv.T, coef), 7).clamp(-32768, 32767)  # T^T @ C
    res = _rshift_round(_mm(tmp, th), 20 - bit_depth)              # . @ T
    return res.clamp(-32768, 32767)
