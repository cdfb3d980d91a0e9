"""Scalar quantization (C11): deadzone quantizer, dequantizer and the
element-wise RDOQ, as x266_tpu/kernels/quant.py:20-83; sign-data hiding
(sdh_adjust, :102-203) and dependent quantization (the 4-state trellis
dq_quantize_trellis and dq_dequantize, :206-450).

Integer ops are exact int32 as in the reference.  Every float32 cost
``e*e*err_scale + lam*rate`` (RDOQ's, SDH's move costs, the trellis's
level costs) is evaluated op by op in float32, ``(e*e)*err_scale`` then
``lam*rate`` then the add, as XLA's CPU fusions compute them (no fused
multiply-add in their optimized LLVM IR), with ``rate`` read from the
table the reference evaluated (Tables.rate: XLA folds ``2*log2(k + 1)``
into ``log(k + 1) * 2.88539`` in these fusions as in the table's), so
they choose the same levels.  The trellis's prefix and suffix (min,+)
products follow jax.lax.associative_scan's tree (assoc_scan): every
entry is a float32 sum grouped as the reference groups it, and
``BIG + BIG`` overflows to inf as there.  Ties take the first index,
as jnp.argmin / argmax.  The reference's X266T_SDH_MODE switch (a
measurement switch of its BD-rate tool) is not ported: the port takes
its default, the rate-aware move.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from x266_tpu_torch.cabac.syntax import tu_scan
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


# ---- sign-data hiding (C11) -------------------------------------------------

SDH_SPAN = 4     # min (last - first) significant scan distance per CG
BIG_SDH = np.float32(3.4e38)


@functools.cache
def _sdh_perm(size: int):
    """(ys, xs) index arrays in TU scan order (the entropy layer's
    diagonal scan, so the parity CGs match both syntax walkers)."""
    sc = tu_scan(size)
    return sc[:, 1].copy(), sc[:, 0].copy()


@functools.cache
def _perm(perm, size: int, device):
    ys, xs = perm(size)
    return (torch.from_numpy(ys).long().to(device),
            torch.from_numpy(xs).long().to(device))


def default_lam(qp: int) -> float:
    """The weight of sdh_adjust and of the trellis when the caller has no
    RDOQ lambda (the reference's sdh_adjust default and _dq_lam, float64;
    rounded once to float32 where it is used)."""
    return 0.57 * math.pow(2.0, (qp - 12) / 3.0)


def sdh_adjust(tab: Tables, lev: torch.Tensor, size: int,
               coef: torch.Tensor | None = None, qp: int = 0,
               bit_depth: int = 8, lam: float | None = None) -> torch.Tensor:
    """Encoder-side sign-data-hiding parity enforcement on one TU's
    (size, size) levels: in every 4x4 CG whose first and last significant
    scan positions are >= SDH_SPAN apart, the first significant level's
    sign is hidden in the parity of the CG's absolute sum (odd =
    negative); a mismatch moves one level by one step.  With ``coef``
    (the pre-quant coefficients) the move is the +-1 step in [first,
    last] of least D + lam*R increase that zeroes neither end; without,
    the first significant level moves (toward zero above 1)."""
    ys, xs = _perm(_sdh_perm, size, lev.device)
    v = lev.to(torch.int32)[ys, xs].reshape(-1, 16)     # (ncg, 16)
    nz = v != 0
    has = nz.any(dim=1)
    first = nz.to(torch.int32).argmax(dim=1)
    last = 15 - nz.flip(1).to(torch.int32).argmax(dim=1)
    eligible = has & ((last - first) >= SDH_SPAN)
    parity = v.abs().sum(dim=1) & 1
    fv = v.gather(1, first[:, None])[:, 0]
    mismatch = eligible & ((fv < 0) != (parity == 1))
    j = torch.arange(16, device=lev.device)[None, :]
    out = torch.zeros_like(lev, dtype=torch.int32)

    if coef is None:
        sgn = torch.where(fv < 0, -1, 1).to(torch.int32)
        nfv = torch.where(fv.abs() > 1, fv - sgn,
                          (fv + sgn).clamp(-32767, 32767))
        hit = (j == first[:, None]) & mismatch[:, None]
        v = torch.where(hit, nfv[:, None], v)
        out[ys, xs] = v.reshape(-1)
        return out

    tsh = transform_shift(size, bit_depth)
    ishift = 6 - tsh
    dscale = tab.dequant_scales[qp % 6] << (qp // 6)
    err_scale = float(2.0 ** (-2 * tsh))
    if lam is None:
        lam = default_lam(qp)
    lam32 = torch.tensor(np.float32(lam), device=lev.device)
    c = coef.to(torch.int32)[ys, xs].reshape(-1, 16)

    def rdcost(lv):
        d = ((lv * dscale + (1 << (ishift - 1))) >> ishift).clamp(
            -32768, 32767)
        e = (d - c).to(torch.float32)
        return (e * e) * err_scale + lam32 * tab.rate[lv.abs().long()]

    e0 = rdcost(v)
    in_span = (j >= first[:, None]) & (j <= last[:, None])
    boundary = (j == first[:, None]) | (j == last[:, None])
    big = torch.tensor(BIG_SDH, device=lev.device)
    deltas, moves = [], []
    for d in (-1, 1):
        nv = (v + d).clamp(-32767, 32767)
        ok = in_span & ~((nv == 0) & boundary) & (nv != v)
        deltas.append(torch.where(ok, rdcost(nv) - e0, big))
        moves.append(nv)
    up = deltas[1] < deltas[0]                  # ties keep the -1 move
    best = torch.where(up, deltas[1], deltas[0])
    pos = best.argmin(dim=1)                    # first minimum in scan
    nv_sel = torch.where(up, moves[1], moves[0]).gather(1, pos[:, None])
    hit = (j == pos[:, None]) & mismatch[:, None]
    v = torch.where(hit, nv_sel, v)
    out[ys, xs] = v.reshape(-1)
    return out


# ---- dependent quantization (C11, VVC-shaped) -------------------------------

# next = DQ_TRANS[state][level parity] over the TU's coding order (the
# reverse scan, from its highest position); states 0/1 use quantizer Q0,
# 2/3 Q1 (odd half-steps)
DQ_TRANS = np.array([[0, 2], [2, 0], [1, 3], [3, 1]], dtype=np.int32)
BIG = np.float32(3.0e38)


@functools.cache
def _dq_perm(size: int):
    """Coding-order (reverse scan) index arrays."""
    sc = tu_scan(size)[::-1]
    return sc[:, 1].copy(), sc[:, 0].copy()


def dq_deq_val(k: torch.Tensor, q1: torch.Tensor, dscale: int,
               ishift: int) -> torch.Tensor:
    """Signed level k under quantizer q1: sgn(k) * clip(((2|k| - q1) *
    dscale + 2^ishift) >> (ishift + 1), 0, 32767)."""
    a = k.abs()
    mag = ((2 * a - q1 * (a > 0).to(torch.int32)) * dscale
           + (1 << ishift)) >> (ishift + 1)
    return torch.sign(k) * mag.clamp(0, 32767)


def dq_states(parity: torch.Tensor) -> torch.Tensor:
    """parity (..., n) in coding order -> the state before each position
    (from state 0): the 4-state maps composed by a doubling scan
    (integers, so any grouping gives the reference's states)."""
    trans = torch.from_numpy(DQ_TRANS).to(parity.device)
    comp = trans[:, parity.long()].movedim(0, -1)      # (..., n, 4)
    n = comp.shape[-2]
    d = 1
    while d < n:
        # comp[j] <- comp[j - d] then comp[j]
        later = comp[..., d:, :]
        comp = torch.cat([comp[..., :d, :],
                          later.gather(-1, comp[..., :-d, :].long())], -2)
        d *= 2
    after = comp[..., 0]
    return torch.cat([torch.zeros_like(after[..., :1]), after[..., :-1]], -1)


def minplus(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(min,+) product over the trailing (4, 4) dims."""
    return (x[..., :, :, None] + y[..., None, :, :]).amin(dim=-2)


def assoc_scan(fn, x: torch.Tensor, dim: int, reverse: bool = False):
    """jax.lax.associative_scan's tree: adjacent pairs combined, the scan
    recursed on them, then the even positions combined with the odd
    results (interleaved by adding zero pads, as there); reverse scans
    the flipped sequence and flips back."""
    x = x.movedim(dim, 0)
    if reverse:
        x = x.flip(0)

    def scan(e):
        n = e.shape[0]
        if n < 2:
            return e
        odd = scan(fn(e[0:n - 1:2], e[1::2]))
        if n % 2 == 0:
            even = fn(odd[:-1], e[2::2])
        else:
            even = fn(odd, e[2::2])
        even = torch.cat([e[:1], even], 0)
        out = torch.zeros((n,) + tuple(e.shape[1:]), dtype=e.dtype,
                          device=e.device)
        out[0::2] = even + 0
        out[1::2] = odd + 0
        return out

    out = scan(x)
    if reverse:
        out = out.flip(0)
    return out.movedim(0, dim)


def dq_quantize_trellis(tab: Tables, coef: torch.Tensor, qp: int,
                        size: int, lam: float,
                        bit_depth: int = 8) -> torch.Tensor:
    """Exact 4-state Viterbi dependent quantization of coef (..., size,
    size): per coding-order position the best level of each (quantizer,
    parity) by D + lam*R, the (4, 4) (min,+) transition matrices, their
    prefix and suffix products, then the state after each position read
    off as argmin_b prefix[j][0, b] + min_c suffix[j+1][b, c] and the
    level implied by the transition into it."""
    tsh = transform_shift(size, bit_depth)
    qbits = 14 + qp // 6 + tsh
    scale = tab.quant_scales[qp % 6]
    ishift = 6 - tsh
    dscale = tab.dequant_scales[qp % 6] << (qp // 6)
    err_scale = float(2.0 ** (-2 * tsh))
    dev = coef.device
    lam32 = torch.tensor(np.float32(lam), device=dev)
    big = torch.tensor(BIG, device=dev)

    ys, xs = _perm(_dq_perm, size, dev)
    c = coef.to(torch.int32)[..., ys, xs]              # (..., n)
    a = c.abs()

    def lev_cost(k, q1):
        d = ((2 * k - q1 * (k > 0).to(torch.int32)) * dscale
             + (1 << ishift)) >> (ishift + 1)
        e = (a - d).to(torch.float32)
        return (e * e) * err_scale + lam32 * tab.rate[k.long()]

    levs, costs = [], []        # [q1][p]
    zero = torch.zeros_like(a)
    for q1 in (0, 1):
        u = (a * scale + (1 << (qbits - 2))) >> (qbits - 1)
        kup = ((u + q1 + 1) >> 1).clamp(0, 32767)
        kdn = (kup - 1).clamp_min(0)
        cu, cd, c0 = lev_cost(kup, q1), lev_cost(kdn, q1), lev_cost(zero, q1)
        lrow, crow = [], []
        for p in (0, 1):
            cu_p = torch.where((kup & 1) == p, cu, big)
            cd_p = torch.where((kdn & 1) == p, cd, big)
            kbest = torch.where(cu_p <= cd_p, kup, kdn)
            cbest = torch.minimum(cu_p, cd_p)
            if p == 0:                  # k = 0 has parity 0
                kbest = torch.where(c0 <= cbest, zero, kbest)
                cbest = torch.minimum(c0, cbest)
            lrow.append(kbest)
            crow.append(cbest)
        levs.append(lrow)
        costs.append(crow)

    m = big.expand(a.shape + (4, 4)).clone()
    for st in range(4):
        for p in (0, 1):
            m[..., st, int(DQ_TRANS[st][p])] = torch.minimum(
                m[..., st, int(DQ_TRANS[st][p])], costs[int(st >= 2)][p])
    nd = a.dim() - 1                                   # the n axis of m
    pref = assoc_scan(minplus, m, nd)
    suff = assoc_scan(minplus, m.transpose(-1, -2), nd,
                      reverse=True).transpose(-1, -2)
    alpha = pref[..., 0, :]                            # (..., n, 4)
    beta = suff.amin(dim=-1)
    tail = torch.cat([beta[..., 1:, :], torch.zeros_like(beta[..., :1, :])],
                     -2)
    sigma = (alpha + tail).argmin(dim=-1)              # state after j
    before = torch.cat([torch.zeros_like(sigma[..., :1]), sigma[..., :-1]],
                       -1)
    trans = torch.from_numpy(DQ_TRANS).to(dev).long()
    p_j = trans[:, 1][before] == sigma                 # parity 1 chosen
    q_j = before >= 2
    k = torch.where(q_j, torch.where(p_j, levs[1][1], levs[1][0]),
                    torch.where(p_j, levs[0][1], levs[0][0]))
    k = torch.where(a > 0, k, zero)
    out = torch.zeros(coef.shape, dtype=torch.int32, device=dev)
    out[..., ys, xs] = torch.sign(c) * k
    return out


def dq_dequantize(tab: Tables, lev: torch.Tensor, qp: int, size: int,
                  bit_depth: int = 8) -> torch.Tensor:
    """Dependent dequantization of levels (..., size, size): the states
    from the levels' parities in coding order, then each level under its
    state's quantizer.  Shared by the decoder and the encoder's recon."""
    tsh = transform_shift(size, bit_depth)
    ishift = 6 - tsh
    dscale = tab.dequant_scales[qp % 6] << (qp // 6)
    ys, xs = _perm(_dq_perm, size, lev.device)
    v = lev.to(torch.int32)[..., ys, xs]
    state = dq_states(v.abs() & 1)
    deq = dq_deq_val(v, (state >= 2).to(torch.int32), dscale, ishift)
    out = torch.zeros(lev.shape, dtype=torch.int32, device=lev.device)
    out[..., ys, xs] = deq
    return out
