"""Integer transform matrices and scalar transform model (C10) [STD].

DCT-II integer matrices of the HEVC family, generated from the standard
distinct-coefficient sets via the even/odd folding identity of the DCT-II
basis: T_N[k][n] = sign * base_N[fold(k*(2n+1) mod 4N)].  The generated
T4/T8 rows equal the well-known HEVC tables (asserted in tests).  DST-VII /
DCT-VIII (VVC MTS, C10) are generated by rounding the scaled analytic bases
— only the *inverse* transform is normative in this framework, and both
sides share these exact integer matrices, so encode/decode consistency holds
by construction (SURVEY.md §0 on why HEVC/VVC table-conformance cannot be
verified in this environment).

Two-stage integer forward/inverse with HM-style shifts for 8-bit video:
  forward:  shift1 = log2(s) - 1,  shift2 = log2(s) + 6
  inverse:  shift1 = 7,            shift2 = 12
giving fwd gain 2^(7 - log2 s) ("transform shift") and fwd∘inv == identity
up to rounding [STD].
"""

from __future__ import annotations

import functools

import numpy as np

# Distinct coefficient sets of the HEVC DCT-II family [STD].
_C = {
    2: [64],
    4: [83, 36],
    8: [89, 75, 50, 18],
    16: [90, 87, 80, 70, 57, 43, 25, 9],
    32: [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
    # 64-pt DCT-II (VVC C10, round-5): round(64*sqrt(2)*cos(pi*(2i+1)
    # /128)) — the same quantization rule the smaller sets follow
    # (self-consistent format; SURVEY.md §0 on table conformance).
    64: [90, 90, 90, 89, 88, 87, 86, 84, 83, 81, 79, 76, 74, 71, 69,
         66, 62, 59, 56, 52, 48, 45, 41, 37, 33, 28, 24, 20, 15, 11,
         7, 2],
}

# 64-pt high-frequency zero-out (VVC-shaped): only the low ZO64 x ZO64
# coefficients of a 64-pt DCT-II TU are retained/coded.
ZO64 = 32


@functools.cache
def _base(n: int) -> tuple[int, ...]:
    """base_n[a] for a in [0, n]: the quantized cos(pi*a/(2n)) ladder."""
    if n == 1:
        return (64, 0)
    prev = _base(n // 2)
    out = []
    for a in range(n + 1):
        out.append(prev[a // 2] if a % 2 == 0 else _C[n][(a - 1) // 2])
    return tuple(out)


@functools.cache
def dct2_matrix(size: int) -> np.ndarray:
    """HEVC-family integer DCT-II matrix, shape (size, size), int32."""
    base = _base(size)
    four_n = 4 * size
    t = np.zeros((size, size), dtype=np.int64)
    for k in range(size):
        for n in range(size):
            a = (k * (2 * n + 1)) % four_n
            sign = 1
            if a > 2 * size:
                a = four_n - a
            if a > size:
                a = 2 * size - a
                sign = -1
            t[k, n] = sign * base[a]
    return t.astype(np.int32)


@functools.cache
def dst7_matrix(size: int) -> np.ndarray:
    """Integer DST-VII matrix (HEVC 4x4 alternative / VVC MTS), int32.

    The 4x4 matrix equals the HEVC table [STD]; larger sizes are rounded
    from the analytic basis (VVC-style generation).
    """
    n = size
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sin(np.pi * (2 * k + 1) * (i + 1) / (2 * n + 1))
    # Row norm of the unit sin basis is sqrt((2n+1)/4); scale so integer
    # rows have norm^2 = n*64^2, matching the DCT-II family.
    scale = 128.0 * np.sqrt(n / (2.0 * n + 1.0))
    t = np.round(m * scale)
    return t.astype(np.int32)


@functools.cache
def dct8_matrix(size: int) -> np.ndarray:
    """Integer DCT-VIII matrix (VVC MTS), rounded analytic basis, int32."""
    n = size
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * k + 1) * (2 * i + 1) / (4 * n + 2))
    scale = 128.0 * np.sqrt(n / (2.0 * n + 1.0))
    t = np.round(m * scale)
    return t.astype(np.int32)


# Transform-type ids shared with the bitstream / kernels (C10).
TX_DCT2 = 0
TX_DST7 = 1
TX_DCT8 = 2


def matrix_for(tx_type: int, size: int) -> np.ndarray:
    if tx_type == TX_DCT2:
        return dct2_matrix(size)
    if tx_type == TX_DST7:
        return dst7_matrix(size)
    if tx_type == TX_DCT8:
        return dct8_matrix(size)
    raise ValueError(f"unknown transform type {tx_type}")


def _rshift_round(x: np.ndarray, shift: int) -> np.ndarray:
    return (x + (1 << (shift - 1))) >> shift


def forward_transform(residual: np.ndarray, tx_v: int = TX_DCT2,
                      tx_h: int = TX_DCT2) -> np.ndarray:
    """Forward 2-D transform of an (s, s) int residual block -> int32 coefs.

    Vertical transform first (rows of T times columns of X), then
    horizontal, with intermediate rounding shifts [STD HM convention].
    """
    s = residual.shape[0]
    log2s = s.bit_length() - 1
    tv = matrix_for(tx_v, s).astype(np.int64)
    th = matrix_for(tx_h, s).astype(np.int64)
    x = residual.astype(np.int64)
    tmp = _rshift_round(tv @ x, log2s - 1)
    coef = _rshift_round(tmp @ th.T, log2s + 6)
    coef = np.clip(coef, -32768, 32767).astype(np.int32)
    if s == 64:                      # high-frequency zero-out [STD]
        coef[ZO64:, :] = 0
        coef[:, ZO64:] = 0
    return coef


def inverse_transform(coef: np.ndarray, tx_v: int = TX_DCT2,
                      tx_h: int = TX_DCT2) -> np.ndarray:
    """Normative inverse 2-D transform -> int32 residual [STD]."""
    s = coef.shape[0]
    tv = matrix_for(tx_v, s).astype(np.int64)
    th = matrix_for(tx_h, s).astype(np.int64)
    c = coef.astype(np.int64)
    tmp = _rshift_round(tv.T @ c, 7)
    tmp = np.clip(tmp, -32768, 32767)
    res = _rshift_round(tmp @ th, 12)
    return np.clip(res, -32768, 32767).astype(np.int32)
