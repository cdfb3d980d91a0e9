"""Deblocking filter (C13), as x266_tpu/kernels/deblock.py.

Vertical edges of the whole picture in one vectorized step, then the
horizontal edges on the vertically filtered samples.  Luma edges lie on
the 8-sample grid where a CU boundary exists; chroma edges on its
8-sample grid (16 luma).  Inter pictures derive a boundary strength per
8x8-unit edge from the coded prediction kinds, the recon scan's final
MV planes and the luma levels (``bs_units``): 2 where either side is
intra, 1 where either side has luma levels, the kinds differ or an MV
component differs by a full pel, else 0 (not filtered); chroma filters
at BS 2 only.  Intra pictures filter every CU edge at BS 2.

Integer arithmetic only (shifts, clips, selects), so the result equals
the reference bit for bit on any device.  Tensors are int32 on the
planes' device.
"""

from __future__ import annotations

import numpy as np
import torch

BETA_TABLE = np.array(
    [0] * 16 + [6 + q for q in range(13)]
    + [20 + 2 * q for q in range(23)], dtype=np.int32)
TC_TABLE = np.array(
    [0] * 18
    + [1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
       6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24, 24, 24],
    dtype=np.int32)


def beta_of(qp: int) -> int:
    return int(BETA_TABLE[min(max(qp, 0), 51)])


def tc_of(qp: int, bs: int = 2) -> int:
    return int(TC_TABLE[min(max(qp + 2 * (bs - 1), 0), 53)])


def _shift_prev(a: torch.Tensor, axis: int) -> torch.Tensor:
    """a's neighbour at -1 along axis (index 0 repeats itself)."""
    if axis == 1:
        return torch.cat([a[:, :1], a[:, :-1]], dim=1)
    return torch.cat([a[:1], a[:-1]], dim=0)


def bs_units(pred, mvx, mvy, cbf, axis: int = 1) -> torch.Tensor:
    """(Uy, Ux) boundary strength of the edge between each 8x8 unit and
    its neighbour at -1 along axis (left for 1, above for 0)."""
    sp = _shift_prev(pred, axis)
    intra = (sp == 0) | (pred == 0)
    bs1 = ((_shift_prev(cbf, axis) | cbf) != 0) | (sp != pred) \
        | ((_shift_prev(mvx, axis) - mvx).abs() >= 4) \
        | ((_shift_prev(mvy, axis) - mvy).abs() >= 4)
    return torch.where(intra, 2, torch.where(bs1, 1, 0)).to(torch.int32)


def cbf_units(coef_y: torch.Tensor) -> torch.Tensor:
    """(H, W) luma levels -> (H/8, W/8) int32 non-zero flags."""
    h, w = coef_y.shape
    blk = coef_y.abs().reshape(h // 8, 8, w // 8, 8)
    return (blk.amax(dim=(1, 3)) > 0).to(torch.int32)


def _edge_mask(size_map: torch.Tensor) -> torch.Tensor:
    """(Uy, Ux) bool: a CU edge at the left of each 8x8 unit (column 0,
    the picture border, excluded)."""
    k = torch.arange(size_map.shape[1], device=size_map.device)[None, :]
    m = (k % (size_map // 8)) == 0
    m[:, 0] = False
    return m


def _filter_luma_dir(y, em_units, beta, tc, maxv=255):
    """Luma deblocking of the vertical edges of y (H, W) int32; em_units
    (H/8, W/8) bool; tc a scalar or a per-unit (H/8, W/8) tensor."""
    h, w = y.shape
    ux = w // 8
    if ux < 2 or beta == 0:
        return y
    dev = y.device
    ecols = torch.arange(1, ux, device=dev) * 8
    em = em_units[:, 1:]
    if torch.is_tensor(tc):
        tc = tc[:, 1:].repeat_interleave(8, dim=0)          # (H, E)

    def col(off):
        return y[:, ecols + off]

    p3, p2, p1, p0 = col(-4), col(-3), col(-2), col(-1)
    q0, q1, q2, q3 = col(0), col(1), col(2), col(3)

    def seg(a):
        return a.reshape(h // 4, 4, -1)

    dp = (p2 - 2 * p1 + p0).abs()
    dq = (q2 - 2 * q1 + q0).abs()
    dp0, dp3 = seg(dp)[:, 0], seg(dp)[:, 3]
    dq0, dq3 = seg(dq)[:, 0], seg(dq)[:, 3]
    filter_on = (dp0 + dp3 + dq0 + dq3) < beta
    sgap = (p3 - p0).abs() + (q3 - q0).abs()
    pq = (p0 - q0).abs()
    strong_line = (sgap < (beta >> 3)) & (pq < ((5 * tc + 1) >> 1))
    strong = (filter_on
              & (2 * (dp0 + dq0) < (beta >> 2))
              & (2 * (dp3 + dq3) < (beta >> 2))
              & seg(strong_line)[:, 0] & seg(strong_line)[:, 3])
    side_th = (beta + (beta >> 1)) >> 3
    side_p = filter_on & ((dp0 + dp3) < side_th)
    side_q = filter_on & ((dq0 + dq3) < side_th)

    def up(a):
        return a.repeat_interleave(4, dim=0)

    edge_lines = em.repeat_interleave(8, dim=0)
    filter_on_l = up(filter_on) & edge_lines
    strong_l = up(strong) & edge_lines
    normal_l = filter_on_l & ~strong_l
    side_p_l = up(side_p) & edge_lines
    side_q_l = up(side_q) & edge_lines

    def cl2(x0, v):
        return torch.clamp(v, x0 - 2 * tc, x0 + 2 * tc)

    sp0 = cl2(p0, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = cl2(p1, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = cl2(p2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = cl2(q0, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3)
    sq1 = cl2(q1, (q2 + q1 + q0 + p0 + 2) >> 2)
    sq2 = cl2(q2, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3)

    delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    mag_ok = delta0.abs() < 10 * tc
    delta = torch.clamp(delta0, -tc, tc)
    np0 = (p0 + delta).clamp(0, maxv)
    nq0 = (q0 - delta).clamp(0, maxv)
    half = tc >> 1
    dp1 = torch.clamp((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -half, half)
    dq1 = torch.clamp((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -half, half)
    np1 = (p1 + dp1).clamp(0, maxv)
    nq1 = (q1 + dq1).clamp(0, maxv)

    norm_app = normal_l & mag_ok
    out = {-1: torch.where(strong_l, sp0, torch.where(norm_app, np0, p0)),
           0: torch.where(strong_l, sq0, torch.where(norm_app, nq0, q0)),
           -2: torch.where(strong_l, sp1,
                           torch.where(norm_app & side_p_l, np1, p1)),
           1: torch.where(strong_l, sq1,
                          torch.where(norm_app & side_q_l, nq1, q1)),
           -3: torch.where(strong_l, sp2, p2),
           2: torch.where(strong_l, sq2, q2)}
    y = y.clone()
    for off in (-3, -2, -1, 0, 1, 2):
        y[:, ecols + off] = out[off]
    return y


def _filter_chroma_dir(c, em_units, tc, maxv=255):
    """Chroma deblocking of the vertical edges on the 8-sample chroma
    grid; em_units is indexed by luma units (chroma column 8m is luma
    unit column 2m)."""
    h, w = c.shape
    n_edge = w // 8
    if n_edge < 2 or tc == 0:
        return c
    dev = c.device
    ecols = torch.arange(1, n_edge, device=dev) * 8
    em = em_units[:, 2 * torch.arange(1, n_edge, device=dev)]
    edge_lines = em.repeat_interleave(4, dim=0)
    p1, p0 = c[:, ecols - 2], c[:, ecols - 1]
    q0, q1 = c[:, ecols], c[:, ecols + 1]
    delta = ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3).clamp(-tc, tc)
    c = c.clone()
    c[:, ecols - 1] = torch.where(edge_lines, (p0 + delta).clamp(0, maxv),
                                  p0)
    c[:, ecols] = torch.where(edge_lines, (q0 - delta).clamp(0, maxv), q0)
    return c


def deblock_picture(y, cb, cr, size_map, qp: int, pred_map=None, mvx=None,
                    mvy=None, coef_y=None, bit_depth: int = 8):
    """The normative deblock of one picture: vertical then horizontal
    edges, luma and chroma.  y (H, W), cb/cr (H/2, W/2) and size_map
    (H/8, W/8) int32; an inter picture passes its pred_map, final
    mvx/mvy planes and luma levels for per-edge boundary strengths.
    Returns the filtered (y, cb, cr) int32."""
    dsh = bit_depth - 8
    maxv = (1 << bit_depth) - 1
    beta = beta_of(qp) << dsh
    tc_c = tc_of(qp, bs=2) << dsh
    vm = _edge_mask(size_map)
    hm = _edge_mask(size_map.T)
    if pred_map is None:
        tc_v = tc_h = tc_of(qp) << dsh
        vm_c, hm_c = vm, hm
    else:
        cbf = cbf_units(coef_y)
        bs_v = bs_units(pred_map, mvx, mvy, cbf, axis=1)
        bs_h = bs_units(pred_map.T, mvx.T, mvy.T, cbf.T, axis=1)
        def tc_of_bs(bs):
            return torch.where(bs == 2, tc_of(qp, 2) << dsh, torch.where(
                bs == 1, tc_of(qp, 1) << dsh, 0)).to(torch.int32)

        tc_v, tc_h = tc_of_bs(bs_v), tc_of_bs(bs_h)
        vm = vm & (bs_v > 0)
        hm = hm & (bs_h > 0)
        vm_c = vm & (bs_v == 2)
        hm_c = hm & (bs_h == 2)
    y = _filter_luma_dir(y, vm, beta, tc_v, maxv)
    y = _filter_luma_dir(y.T, hm, beta, tc_h, maxv).T
    cb = _filter_chroma_dir(cb, vm_c, tc_c, maxv)
    cb = _filter_chroma_dir(cb.T, hm_c, tc_c, maxv).T
    cr = _filter_chroma_dir(cr, vm_c, tc_c, maxv)
    cr = _filter_chroma_dir(cr.T, hm_c, tc_c, maxv).T
    return y.contiguous(), cb.contiguous(), cr.contiguous()
