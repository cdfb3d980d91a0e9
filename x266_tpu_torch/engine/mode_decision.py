"""Pass A: parallel intra mode decision + quadtree partitioning, and the
MTS transform choice (C5/C8/C9/C10).

Counterpart of x266_tpu/engine/mode_decision.py:143-547.  Every block of
every CU size is evaluated for all intra modes at once (MIP's among
them, and with PDPC blended in) from ORIGINAL-pixel references masked by
the decode-order availability rule; an 8-mode SAD preselect feeds the
full transform/quant/rate/recon RD chain, or in lossless mode the rate
of the residual alone; the quadtree is decided bottom-up; with MTT each
16 and 32 leaf also
competes against its two binary splits into shared-mode rectangular CUs
(_eval_pair).  The transform choice follows: the MTS pairs, transform
skip (mts_map value TS_IDX) and LFNST's two kernels.  Pass B
(engine.recon) recomputes the normative levels against reconstructed
pixels.

Decisions must equal the reference's, so the preselect orders modes by
(SAD, mode index) with a stable sort (``jax.lax.top_k`` puts the lower
index first on ties, ``torch.topk`` does not), ``argmin`` keeps the first
minimum, and the float32 costs are built op by op in the reference's
order (kernels.cost: the rate sums nested in the argmin's loop fusion,
rate_nested, and D + lam * R as one fused multiply-add, rd_cost; the
lossless rate sum flattens the block first, window_then_sum).
"""

from __future__ import annotations

import numpy as np
import torch

from x266_tpu_torch.config import CodecConfig
from x266_tpu_torch.engine import availability as avail

from x266_tpu_torch.engine.availability import ref_masks
from x266_tpu_torch.kernels import cost as kcost
from x266_tpu_torch.kernels import intra as kintra
from x266_tpu_torch.kernels import lfnst as klfnst
from x266_tpu_torch.kernels import quant as kquant
from x266_tpu_torch.kernels import transforms as ktx
from x266_tpu_torch.specmodel.quant import transform_shift
from x266_tpu_torch.tables import MTS_COMBOS, Tables

PAD = 72                 # right/bottom plane padding, as the reference
MODE_SIGNAL_BITS = 6.0   # flat estimate for coding one luma mode
SPLIT_BITS = 2.0         # estimate for quadtree split signalling
RD_MODES = 8             # modes surviving the SAD preselect into full RD
RD_MODES_INTER = 4       # the same on P slices, where intra is the minority
TS_IDX = 5               # mts_map value of transform skip (luma)


def pad_plane(img: torch.Tensor, mid: int = 128) -> torch.Tensor:
    """(..., H, W) samples -> (..., 1+H+PAD, 1+W+PAD) planes of the same
    dtype on the same device, border = mid-gray; picture pixel (y, x)
    lives at plane[..., y+1, x+1]."""
    h, w = img.shape[-2:]
    plane = torch.full((*img.shape[:-2], 1 + h + PAD, 1 + w + PAD), mid,
                       dtype=img.dtype, device=img.device)
    plane[..., 1:1 + h, 1:1 + w] = img
    return plane


def _block_positions(width: int, height: int, size: int):
    gy, gx = -(-height // size), -(-width // size)
    iy, ix = np.mgrid[0:gy, 0:gx]
    return (ix * size).ravel(), (iy * size).ravel(), gy, gx


def _gather_refs(plane: torch.Tensor, gy: int, gx: int,
                 size: int) -> torch.Tensor:
    """(gy*gx, 4s+1) reference vectors [corner, top 2s, left 2s] of the
    aligned block grid, as engine.recon reads them: plane[y, x:x+2s+1]
    then plane[y+1:y+1+2s, x], (x, y) the block origin in plane coords."""
    s = size
    rows = plane[0:gy * s:s, :]
    need_w = (gx - 1) * s + 2 * s + 1
    if rows.shape[1] < need_w:
        # out-of-picture overhang: masked before any use
        rows = torch.nn.functional.pad(rows, (0, need_w - rows.shape[1]))
    top = torch.stack([rows[:, t:t + gx * s:s] for t in range(2 * s + 1)],
                      dim=-1)
    cols = plane[:, 0:gx * s:s]
    need_h = (gy - 1) * s + 2 * s + 1
    if cols.shape[0] < need_h:
        cols = torch.nn.functional.pad(cols,
                                       (0, 0, 0, need_h - cols.shape[0]))
    left = torch.stack([cols[1 + r:1 + r + gy * s:s, :]
                        for r in range(2 * s)], dim=-1)
    return torch.cat([top, left], dim=-1).reshape(gy * gx, 4 * s + 1)


def _block_gather(plane: torch.Tensor, gy: int, gx: int,
                  size: int) -> torch.Tensor:
    """All aligned (s, s) blocks, (gy*gx, s, s)."""
    s = size
    blk = plane[1:1 + gy * s, 1:1 + gx * s]
    return blk.reshape(gy, s, gx, s).permute(0, 2, 1, 3).reshape(-1, s, s)


def _mask_refs(refs: torch.Tensor, mask: torch.Tensor,
               cfg: CodecConfig) -> torch.Tensor:
    """Availability rule: mid-gray, or with cfg.ref_substitute the
    HEVC-style propagation fill."""
    if cfg.ref_substitute:
        return kintra.substitute_refs(refs, mask, cfg.mid_val)
    return torch.where(mask, refs, torch.full_like(refs, cfg.mid_val))


class _Geometry:
    """Static per-size block geometry, availability masks and PDPC gates
    (block x > 0, y > 0) of one picture size, built once per session on
    the target device."""

    def __init__(self, cfg: CodecConfig, device: torch.device):
        self.by_size = {}
        self.gates = {}
        for s in (8, 16, 32, 64):
            if s > cfg.max_cu_size:
                continue
            xs, ys, gy, gx = _block_positions(cfg.width, cfg.height, s)
            nb = xs.shape[0]
            mask = torch.from_numpy(np.ascontiguousarray(
                ref_masks(cfg.width, cfg.height, s).reshape(nb, -1)))
            valid = torch.from_numpy(np.ascontiguousarray(
                avail.valid_block_grid(cfg.width, cfg.height,
                                       s).reshape(nb)))
            self.by_size[s] = (gy, gx, mask.to(device), valid.to(device))
            self.gates[s] = (torch.from_numpy(xs > 0).to(device),
                             torch.from_numpy(ys > 0).to(device))


def _predict(plane: torch.Tensor, s: int, cfg: CodecConfig, tab: Tables,
             geom: _Geometry):
    """Every mode's prediction of every size-aligned block from masked
    original-pixel references: (orig (B, 1, s, s), res = orig - pred
    (B, nm, s, s)) int32.  PDPC blended in under cfg.pdpc: Pass A scores
    the blend, as the reference does by default."""
    gy, gx, mask, _ = geom.by_size[s]
    refs = _mask_refs(_gather_refs(plane, gy, gx, s), mask, cfg)
    preds = kintra.predict_all_modes(tab, refs, s, pdpc=cfg.pdpc,
                                     left_ok=geom.gates[s][0],
                                     top_ok=geom.gates[s][1])
    orig = _block_gather(plane, gy, gx, s)[:, None]
    return orig, orig - preds


def _preselect(sad: torch.Tensor, k: int) -> torch.Tensor:
    """The k modes of least SAD a block, lower index first on ties (the
    order of jax.lax.top_k, which torch.topk does not keep): (B, k)."""
    return torch.sort(sad, dim=1, stable=True).indices[:, :k]


def _rd_chain(tab: Tables, cfg: CodecConfig, res_k: torch.Tensor,
              orig: torch.Tensor, s: int, lam: float, extra: float):
    """D + lam * (R + extra) of residual candidates res_k (B, K, s, s)
    against orig (B, 1, s, s): the forward transform, quantizer, rate
    (rate_nested), dequantizer, inverse and clipped recon, as one fused
    multiply-add (rd_cost); at s = 64 in XLA's order there (rd_cost64).
    (B, K) float32."""
    nb, k = res_k.shape[:2]
    bd = cfg.bit_depth
    coefs = ktx.forward_transform(tab, res_k.reshape(nb * k, s, s), s,
                                  bit_depth=bd)
    levels = kquant.quantize(tab, coefs, cfg.qp, s, bd)
    deq = kquant.dequantize(tab, levels, cfg.qp, s, bd)
    rres = ktx.inverse_transform(tab, deq, s, bit_depth=bd).reshape(
        nb, k, s, s)
    recon = (orig - res_k + rres).clamp(0, cfg.max_val)
    if s == 64:
        return kcost.rd_cost64(tab, levels.reshape(nb, k, s, s),
                               recon - orig, lam, extra)
    rate = kcost.rate_nested(tab, levels).reshape(nb, k)
    return kcost.rd_cost(kcost.sse(recon, orig), lam, rate + extra)


def _eval_size(plane: torch.Tensor, size: int, cfg: CodecConfig,
               tab: Tables, geom: _Geometry, inter_slice: bool = False,
               pred=None):
    """Best mode, its RD cost and its residual for every size-aligned
    block: (cost (gy, gx) f32, mode (gy, gx) i32, res (nb, s, s) i32).
    Blocks partly outside the picture cost +inf.  inter_slice keeps
    RD_MODES_INTER modes after the SAD preselect instead of RD_MODES.
    pred: _predict's (orig, res) of this size, when already made."""
    s = size
    gy, gx, _, valid = geom.by_size[s]
    lam = float(np.float32(cfg.lambda_mode))    # a multiplier: no upload
    orig, res = pred if pred is not None else _predict(plane, s, cfg, tab,
                                                       geom)
    nb, nm = res.shape[:2]
    k = min(RD_MODES_INTER if inter_slice else RD_MODES, nm)
    top = _preselect(res.abs().sum((2, 3)).to(torch.float32), k)
    res_k = torch.gather(res, 1, top[:, :, None, None].expand(-1, -1, s, s))
    if cfg.lossless:
        # no distortion: the rate of the residual itself
        rate = kcost.rate_estimate_residual(tab, res_k)
        cost = lam * (rate + MODE_SIGNAL_BITS)
    else:
        cost = _rd_chain(tab, cfg, res_k, orig, s, lam, MODE_SIGNAL_BITS)
    best_k = torch.argmin(cost, dim=1)
    best_mode = torch.gather(top, 1, best_k[:, None])[:, 0]
    best_cost = torch.gather(cost, 1, best_k[:, None])[:, 0]
    best_cost = torch.where(valid, best_cost,
                            torch.full_like(best_cost, float("inf")))
    res_best = torch.gather(
        res_k, 1, best_k[:, None, None, None].expand(-1, 1, s, s))[:, 0]
    return (best_cost.reshape(gy, gx),
            best_mode.to(torch.int32).reshape(gy, gx), res_best)


def _eval_pair(pred, t: int, cfg: CodecConfig, tab: Tables,
               geom: _Geometry, vertical: bool):
    """Shared-mode RD cost of the rectangular CUs of MTT (C5,
    x266_tpu/engine/mode_decision.py:224-309): each CU is a pair of
    adjacent t-sized TUs coding one intra mode, along x (BT-H halves,
    h = t, w = 2t) or along y (vertical: BT-V halves, h = 2t, w = t).
    pred: _predict's (orig, res) at size t.  The preselect ranks the
    pair's joint SAD; the RD chain runs on both TUs of the K survivors,
    and the cost is rd0 + rd1 + lam * (MODE_SIGNAL_BITS + 2).  A trailing
    odd block pairs with nothing and is dropped.  Returns (cost (py, px)
    f32, mode (py, px) i32) on the pair grid."""
    gy, gx = geom.by_size[t][:2]
    lam = float(np.float32(cfg.lambda_mode))
    orig, res = pred
    nm = res.shape[1]
    sad = res.abs().sum((2, 3)).to(torch.float32).reshape(gy, gx, nm)
    rf = res.reshape(gy, gx, nm, t, t)
    og = orig.reshape(gy, gx, 1, t, t)
    ge_y, ge_x = (gy // 2) * 2, (gx // 2) * 2
    if vertical:
        jsad = sad[0:ge_y:2] + sad[1:ge_y:2]
        halves = [(rf[h:ge_y:2], og[h:ge_y:2]) for h in (0, 1)]
    else:
        jsad = sad[:, 0:ge_x:2] + sad[:, 1:ge_x:2]
        halves = [(rf[:, h:ge_x:2], og[:, h:ge_x:2]) for h in (0, 1)]
    py, px = jsad.shape[:2]
    k = min(RD_MODES, nm)
    top = _preselect(jsad.reshape(py * px, nm), k)
    idx = top[:, :, None, None].expand(-1, -1, t, t)
    rd = [_rd_chain(tab, cfg, torch.gather(r.reshape(py * px, nm, t, t), 1,
                                           idx),
                    o.reshape(py * px, 1, t, t), t, lam, 0.0)
          for r, o in halves]
    cost = (rd[0] + rd[1]) + float(np.float32(lam) * np.float32(
        MODE_SIGNAL_BITS + 2.0))
    best_k = torch.argmin(cost, dim=1)
    best_mode = torch.gather(top, 1, best_k[:, None])[:, 0]
    best_cost = torch.gather(cost, 1, best_k[:, None])[:, 0]
    return (best_cost.reshape(py, px),
            best_mode.to(torch.int32).reshape(py, px))


def _pad_to(a: torch.Tensor, shape, fill: float) -> torch.Tensor:
    return torch.nn.functional.pad(
        a, (0, shape[1] - a.shape[1], 0, shape[0] - a.shape[0]),
        value=fill)


def _sum_children(cost: torch.Tensor, gy2: int, gx2: int) -> torch.Tensor:
    """2x2 window sums of the child grid; missing children count 0."""
    c = torch.where(torch.isfinite(cost), cost,
                    torch.full_like(cost, 1e18))
    c = _pad_to(c, (2 * gy2, 2 * gx2), 0.0)
    return c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]


def _upsample(a: torch.Tensor, f: int, gy: int, gx: int) -> torch.Tensor:
    return a.repeat_interleave(f, 0).repeat_interleave(f, 1)[:gy, :gx]


def _bt_leaves(cost_s, child, pair_h, pair_v, lam: float):
    """MTT's four-way choice at a leaf size s (x266_tpu/engine/
    mode_decision.py:380-405): the square CU, the quadtree children, or
    a binary split into two BT-H or two BT-V rectangular CUs (+ ~2 bins
    of signalling); only leaves fully inside the picture may split
    binary.  pair_h / pair_v: _eval_pair's (cost, mode) grids.  Returns
    (best cost, choice 0 square / 1 children / 2 BT-H / 3 BT-V, the BT-H
    and BT-V mode grids padded to (2 gy, gx) and (gy, 2 gx))."""
    gs = cost_s.shape
    ph_c = _pad_to(pair_h[0], (2 * gs[0], gs[1]), 1e18)
    ph_m = _pad_to(pair_h[1], (2 * gs[0], gs[1]), 0)
    pv_c = _pad_to(pair_v[0], (gs[0], 2 * gs[1]), 1e18)
    pv_m = _pad_to(pair_v[1], (gs[0], 2 * gs[1]), 0)
    valid = torch.isfinite(cost_s)
    bt_bits = float(np.float32(lam) * np.float32(2.0))
    inf = torch.full_like(cost_s, float("inf"))
    bth = torch.where(valid, ph_c[0::2] + ph_c[1::2] + bt_bits, inf)
    btv = torch.where(valid, pv_c[:, 0::2] + pv_c[:, 1::2] + bt_bits, inf)
    best_s = torch.minimum(torch.minimum(cost_s, child),
                           torch.minimum(bth, btv))
    choice = torch.where(
        cost_s <= best_s, 0,
        torch.where(bth <= torch.minimum(child, btv), 2,
                    torch.where(btv <= child, 3, 1)))
    return best_s, choice, ph_m, pv_m


def make_mode_decision_raw(cfg: CodecConfig, tab: Tables,
                           want_res: bool = True):
    """Pass A: padded original luma plane (Hp, Wp) ->
    (size_map, mode_map) int32 (units_y, units_x), plus with want_res
    {size: winner residual (nb, s, s)} for make_mts_select_raw.  With
    cfg.mtt (x266_tpu/engine/mode_decision.py:366-419) each 16 and 32
    leaf also competes against its two binary splits, and the third
    output is bt_map (0 none, 1 BT-H, 2 BT-V a unit) in place of the
    residuals: a BT leaf's units carry the winning half's shared mode.
    With max_cu_size 64 (all-intra VVC without MTT) the 64 size competes
    with its four 32 children as the smaller sizes do
    (x266_tpu/engine/mode_decision.py:356-357)."""
    uy, ux = cfg.units_y, cfg.units_x
    geom = _Geometry(cfg, tab.device)
    lam = np.float32(cfg.lambda_mode)
    split = torch.tensor(lam * np.float32(SPLIT_BITS), device=tab.device)

    def run(plane: torch.Tensor):
        plane = plane.to(torch.int32)
        pred = _predict(plane, 8, cfg, tab, geom)
        best, mode8, res8 = _eval_size(plane, 8, cfg, tab, geom, pred=pred)
        res_by_size = {8: res8}
        size_map = torch.full((uy, ux), 8, dtype=torch.int32,
                              device=plane.device)
        bt_map = torch.zeros_like(size_map)
        mode_map = mode8
        for s in (16, 32, 64):
            if s > cfg.max_cu_size:
                continue
            f = s // 8
            pred_t, pred = pred, _predict(plane, s, cfg, tab, geom)
            cost_s, mode_s, res_by_size[s] = _eval_size(plane, s, cfg, tab,
                                                        geom, pred=pred)
            child = _sum_children(best, *cost_s.shape) + split
            if not cfg.mtt:
                use = cost_s <= child               # inf own -> split
                sel = _upsample(use, f, uy, ux)
                size_map = torch.where(sel, s, size_map)
                mode_map = torch.where(sel, _upsample(mode_s, f, uy, ux),
                                       mode_map)
                best = torch.where(use, cost_s, child)
                continue
            t = s // 2
            best, choice, ph_m, pv_m = _bt_leaves(
                cost_s, child,
                _eval_pair(pred_t, t, cfg, tab, geom, vertical=False),
                _eval_pair(pred_t, t, cfg, tab, geom, vertical=True),
                float(lam))
            sel = _upsample(choice != 1, f, uy, ux)
            chc = _upsample(choice, f, uy, ux)
            size_map = torch.where(sel, s, size_map)
            bt_map = torch.where(sel, torch.where(
                chc == 2, 1, torch.where(chc == 3, 2, 0)), bt_map).to(
                    torch.int32)
            # the pair grids upsample with the split's anisotropy
            m_h = ph_m.repeat_interleave(f // 2, 0).repeat_interleave(
                f, 1)[:uy, :ux]
            m_v = pv_m.repeat_interleave(f, 0).repeat_interleave(
                f // 2, 1)[:uy, :ux]
            m_new = torch.where(chc == 0, _upsample(mode_s, f, uy, ux),
                                torch.where(chc == 2, m_h, m_v))
            mode_map = torch.where(sel, m_new, mode_map)
        if cfg.mtt:
            return size_map, mode_map, bt_map
        if want_res:
            return size_map, mode_map, res_by_size
        return size_map, mode_map

    return run


def make_mts_select_raw(cfg: CodecConfig, tab: Tables):
    """Per-CU transform choice, staged after the mode decision, over the
    5 MTS pairs (cfg.mts, else DCT-II alone), transform skip
    (cfg.transform_skip, map value TS_IDX) and LFNST's two kernels on
    the DCT-II coefficients (cfg.lfnst, map values 1 << 6 and 2 << 6):
    f(plane, size_map, mode_map, res_by_size, bt_map=None) -> mts_map
    (units, int32).  res_by_size are Pass A's winner residuals, so the
    prediction is orig - res (same values by construction).  Under MTT
    (bt_map given, res_by_size None) the choice is made at each unit's
    effective TU size (a BT leaf's TUs are half its side) and every
    block is predicted with mode_map's mode at its origin, as the
    reference does (x266_tpu/engine/mode_decision.py:442-547).  A 64 CU
    takes no choice (the reference's loop stops at 32): its map stays 0,
    DCT-II without LFNST or transform skip."""
    uy, ux = cfg.units_y, cfg.units_x
    lam = float(np.float32(cfg.lambda_mode))
    combos = MTS_COMBOS if cfg.mts else MTS_COMBOS[:1]
    vals = torch.tensor(list(range(len(combos)))
                        + ([TS_IDX] if cfg.transform_skip else [])
                        + ([1 << 6, 2 << 6] if cfg.lfnst else []),
                        dtype=torch.int32, device=tab.device)
    bd = cfg.bit_depth
    geom = _Geometry(cfg, tab.device) if cfg.mtt else None

    def rd(orig, pred, levels, rres, extra):
        recon = (pred + rres).clamp(0, cfg.max_val)
        return kcost.rd_cost(kcost.sse(recon, orig), lam,
                             kcost.rate_nested(tab, levels) + extra)

    def eval_size(plane, s, res, mode_map):
        gy, gx = _block_positions(cfg.width, cfg.height, s)[2:]
        if res is None:
            # each block's prediction by mode_map's mode at its origin
            orig4, res_all = _predict(plane, s, cfg, tab, geom)
            modes = mode_map[0::s // 8, 0::s // 8].reshape(-1).long()
            res = torch.gather(res_all, 1, modes[:, None, None, None].expand(
                -1, 1, s, s))[:, 0]
            orig = orig4[:, 0]
        else:
            orig = _block_gather(plane, gy, gx, s)
        pred = orig - res
        costs = []
        for tv, th in combos:
            coefs = ktx.forward_transform(tab, res, s, tv, th, bd)
            levels = kquant.quantize(tab, coefs, cfg.qp, s, bd)
            deq = kquant.dequantize(tab, levels, cfg.qp, s, bd)
            costs.append(rd(orig, pred, levels,
                            ktx.inverse_transform(tab, deq, s, tv, th, bd),
                            2.0))
        if cfg.transform_skip:
            # the residual scaled up into the coefficient range, one
            # flag bit instead of two
            tsh = transform_shift(s, bd)
            levels = kquant.quantize(tab, res << tsh, cfg.qp, s, bd)
            deq = kquant.dequantize(tab, levels, cfg.qp, s, bd)
            costs.append(rd(orig, pred, levels,
                            (deq + (1 << (tsh - 1))) >> tsh, 1.0))
        if cfg.lfnst:
            modes = mode_map[0::s // 8, 0::s // 8].reshape(-1)
            c0 = ktx.forward_transform(tab, res, s, bit_depth=bd)
            for kk in (1, 2):
                li = torch.full_like(modes, kk)
                c2 = klfnst.lfnst_fwd(c0, modes, li, cfg.n_pred_modes)
                levels = kquant.quantize(tab, c2, cfg.qp, s, bd)
                deq = kquant.dequantize(tab, levels, cfg.qp, s, bd)
                d2 = klfnst.lfnst_inv(deq, modes, li, cfg.n_pred_modes)
                costs.append(rd(orig, pred, levels,
                                ktx.inverse_transform(tab, d2, s,
                                                      bit_depth=bd), 2.0))
        choice = torch.argmin(torch.stack(costs, dim=1), dim=1)
        return vals[choice].reshape(gy, gx)

    def run(plane, size_map, mode_map, res_by_size=None, bt_map=None):
        plane = plane.to(torch.int32)
        mts_map = torch.zeros((uy, ux), dtype=torch.int32,
                              device=plane.device)
        # a BT leaf tiles as square TUs of half its side: the choice is
        # made at the effective TU size
        eff = (torch.where(bt_map > 0, size_map >> 1, size_map)
               if bt_map is not None else size_map)
        for s in (8, 16, 32):
            if s > cfg.max_cu_size:
                continue
            res = res_by_size[s] if res_by_size is not None else None
            up = _upsample(eval_size(plane, s, res, mode_map), s // 8,
                           uy, ux)
            mts_map = torch.where(eff == s, up, mts_map)
        return mts_map

    return run
