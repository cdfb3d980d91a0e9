"""Scalar quantization model (C11) [STD, HM convention].

  transform_shift = 15 - bit_depth - log2(s)     (coef scale vs residual;
                                                  7 - log2(s) at 8-bit)
  quant:   level = sign * ((|coef| * fQ[qp%6] + add) >> qbits)
           qbits = 14 + qp//6 + transform_shift, add = 171 << (qbits - 9)
  dequant: coef  = (level * gD[qp%6] << (qp//6) + round) >> (6 - t_shift)

fQ * gD ~= 2^20, making quant∘dequant gain ~1 at every QP.  Only dequant is
normative; the encoder-side quantizer (incl. RDOQ later) is free [STD].
Lossless mode bypasses this module entirely (cfg.lossless, C11).
"""

from __future__ import annotations

import numpy as np

QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                        dtype=np.int64)
DEQUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)


def transform_shift(size: int, bit_depth: int = 8) -> int:
    return 15 - bit_depth - (size.bit_length() - 1)


def quantize(coef: np.ndarray, qp: int, size: int,
             bit_depth: int = 8) -> np.ndarray:
    qbits = 14 + qp // 6 + transform_shift(size, bit_depth)
    add = 171 << (qbits - 9)
    c = coef.astype(np.int64)
    level = (np.abs(c) * QUANT_SCALES[qp % 6] + add) >> qbits
    level = np.clip(level, 0, 32767)
    return (np.sign(c) * level).astype(np.int32)


def dequantize(level: np.ndarray, qp: int, size: int,
               bit_depth: int = 8) -> np.ndarray:
    ishift = 6 - transform_shift(size, bit_depth)
    scale = int(DEQUANT_SCALES[qp % 6]) << (qp // 6)
    c = (level.astype(np.int64) * scale + (1 << (ishift - 1))) >> ishift
    return np.clip(c, -32768, 32767).astype(np.int32)
