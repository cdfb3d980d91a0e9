"""Scalar quantization (C11): deadzone quantizer, dequantizer and the
element-wise RDOQ, as x266_tpu/kernels/quant.py:20-83.

Integer ops are exact int32 as in the reference.  RDOQ's float32 cost
``e*e*err_scale + lam*rate`` is evaluated op by op in float32 (no fused
multiply-add) with ``rate`` read from the table the reference evaluated
(Tables.rate), so it chooses the same levels.  Sign-data hiding and
dependent quantization belong to a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from x266_tpu_torch.specmodel.quant import transform_shift

from x266_tpu_torch.tables import Tables


def quantize(tab: Tables, coef: torch.Tensor, qp: int, size: int,
             bit_depth: int = 8) -> torch.Tensor:
    qbits = 14 + qp // 6 + transform_shift(size, bit_depth)
    add = 171 << (qbits - 9)
    scale = tab.quant_scales[qp % 6]
    c = coef.to(torch.int32)
    level = ((c.abs() * scale + add) >> qbits).clamp(0, 32767)
    return torch.sign(c) * level


def dequantize(tab: Tables, level: torch.Tensor, qp: int, size: int,
               bit_depth: int = 8) -> torch.Tensor:
    ishift = 6 - transform_shift(size, bit_depth)
    scale = tab.dequant_scales[qp % 6] << (qp // 6)
    c = (level.to(torch.int32) * scale + (1 << (ishift - 1))) >> ishift
    return c.clamp(-32768, 32767)


def rd_quantize(tab: Tables, coef: torch.Tensor, qp: int, size: int,
                lam: float, bit_depth: int = 8) -> torch.Tensor:
    """Per coefficient, the level in {0, l_dn, l_up} minimizing
    D + lam*R (l_up the nearest level, l_dn = l_up - 1); ties keep the
    larger level and prefer a nonzero level over zero, as the
    reference (cu <= cd, min(cu, cd) <= c0)."""
    tsh = transform_shift(size, bit_depth)
    qbits = 14 + qp // 6 + tsh
    scale = tab.quant_scales[qp % 6]
    ishift = 6 - tsh
    dscale = tab.dequant_scales[qp % 6] << (qp // 6)
    err_scale = float(2.0 ** (-2 * tsh))
    lam32 = torch.tensor(np.float32(lam), device=coef.device)

    c = coef.to(torch.int32)
    a = c.abs()
    lup = ((a * scale + (1 << (qbits - 1))) >> qbits).clamp(0, 32767)
    ldn = (lup - 1).clamp_min(0)

    def cost(lv):
        dq = ((lv * dscale + (1 << (ishift - 1))) >> ishift).clamp(
            -32768, 32767)
        e = (a - dq).to(torch.float32)
        return (e * e) * err_scale + lam32 * tab.rate[lv.long()]

    c0 = cost(torch.zeros_like(a))
    cd, cu = cost(ldn), cost(lup)
    lev = torch.where(cu <= cd, lup, ldn)
    lbest = torch.where(torch.minimum(cu, cd) <= c0, lev,
                        torch.zeros_like(lev))
    return torch.sign(c) * lbest
