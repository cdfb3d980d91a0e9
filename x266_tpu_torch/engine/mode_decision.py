"""Pass A: parallel intra mode decision + quadtree partitioning, and the
MTS transform choice (C5/C8/C9/C10).

Counterpart of x266_tpu/engine/mode_decision.py:143-221, 328-431 and
442-547 (the non-MTT path).  Every block of every CU size is evaluated
for all intra modes at once (MIP's among them, and with PDPC blended in)
from ORIGINAL-pixel references masked by the decode-order availability
rule; an 8-mode SAD preselect feeds the full transform/quant/rate/recon
RD chain, or in lossless mode the rate of the residual alone; the
quadtree is decided bottom-up.  The transform choice follows: the MTS
pairs and transform skip (mts_map value TS_IDX).  Pass B
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
        for s in (8, 16, 32):
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


def _eval_size(plane: torch.Tensor, size: int, cfg: CodecConfig,
               tab: Tables, geom: _Geometry, inter_slice: bool = False):
    """Best mode, its RD cost and its residual for every size-aligned
    block: (cost (gy, gx) f32, mode (gy, gx) i32, res (nb, s, s) i32).
    Blocks partly outside the picture cost +inf.  inter_slice keeps
    RD_MODES_INTER modes after the SAD preselect instead of RD_MODES."""
    s = size
    gy, gx, mask, valid = geom.by_size[s]
    lam = float(np.float32(cfg.lambda_mode))    # a multiplier: no upload
    refs = _mask_refs(_gather_refs(plane, gy, gx, s), mask, cfg)
    # PDPC blended in under cfg.pdpc: Pass A scores the blend, as the
    # reference does by default
    preds = kintra.predict_all_modes(tab, refs, s, pdpc=cfg.pdpc,
                                     left_ok=geom.gates[s][0],
                                     top_ok=geom.gates[s][1])  # (B, nm, s, s)
    orig = _block_gather(plane, gy, gx, s)[:, None]
    res = orig - preds
    nb, nm = preds.shape[:2]
    k = min(RD_MODES_INTER if inter_slice else RD_MODES, nm)
    sad = res.abs().sum((2, 3)).to(torch.float32)
    top = torch.sort(sad, dim=1, stable=True).indices[:, :k]  # (B, K)
    res_k = torch.gather(res, 1, top[:, :, None, None].expand(-1, -1, s, s))
    if cfg.lossless:
        # no distortion: the rate of the residual itself
        rate = kcost.rate_estimate_residual(tab, res_k)
        cost = lam * (rate + MODE_SIGNAL_BITS)
    else:
        pred_k = orig - res_k
        bd = cfg.bit_depth
        coefs = ktx.forward_transform(tab, res_k.reshape(nb * k, s, s), s,
                                      bit_depth=bd)
        levels = kquant.quantize(tab, coefs, cfg.qp, s, bd)
        rate = kcost.rate_nested(tab, levels).reshape(nb, k)
        deq = kquant.dequantize(tab, levels, cfg.qp, s, bd)
        rres = ktx.inverse_transform(tab, deq, s, bit_depth=bd).reshape(
            nb, k, s, s)
        recon = (pred_k + rres).clamp(0, cfg.max_val)
        cost = kcost.rd_cost(kcost.sse(recon, orig), lam,
                             rate + MODE_SIGNAL_BITS)
    best_k = torch.argmin(cost, dim=1)
    best_mode = torch.gather(top, 1, best_k[:, None])[:, 0]
    best_cost = torch.gather(cost, 1, best_k[:, None])[:, 0]
    best_cost = torch.where(valid, best_cost,
                            torch.full_like(best_cost, float("inf")))
    res_best = torch.gather(
        res_k, 1, best_k[:, None, None, None].expand(-1, 1, s, s))[:, 0]
    return (best_cost.reshape(gy, gx),
            best_mode.to(torch.int32).reshape(gy, gx), res_best)


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


def _check_cfg(cfg: CodecConfig) -> None:
    for flag in ("mtt", "lfnst", "cclm"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag} is not in the port's "
                                      "slices")
    if cfg.max_cu_size > 32:
        raise NotImplementedError("max_cu_size 64 is not in the port's "
                                  "slices")


def make_mode_decision_raw(cfg: CodecConfig, tab: Tables,
                           want_res: bool = True):
    """Pass A: padded original luma plane (Hp, Wp) ->
    (size_map, mode_map) int32 (units_y, units_x), plus with want_res
    {size: winner residual (nb, s, s)} for make_mts_select_raw."""
    _check_cfg(cfg)
    uy, ux = cfg.units_y, cfg.units_x
    geom = _Geometry(cfg, tab.device)
    split = torch.tensor(np.float32(cfg.lambda_mode) * np.float32(
        SPLIT_BITS), device=tab.device)

    def run(plane: torch.Tensor):
        plane = plane.to(torch.int32)
        best, mode8, res8 = _eval_size(plane, 8, cfg, tab, geom)
        res_by_size = {8: res8}
        size_map = torch.full((uy, ux), 8, dtype=torch.int32,
                              device=plane.device)
        mode_map = mode8
        for s in (16, 32):
            if s > cfg.max_cu_size:
                continue
            cost_s, mode_s, res_by_size[s] = _eval_size(plane, s, cfg, tab,
                                                        geom)
            child = _sum_children(best, *cost_s.shape) + split
            use = cost_s <= child                   # inf own -> split
            sel = _upsample(use, s // 8, uy, ux)
            size_map = torch.where(sel, s, size_map)
            mode_map = torch.where(sel, _upsample(mode_s, s // 8, uy, ux),
                                   mode_map)
            best = torch.where(use, cost_s, child)
        if want_res:
            return size_map, mode_map, res_by_size
        return size_map, mode_map

    return run


def make_mts_select_raw(cfg: CodecConfig, tab: Tables):
    """Per-CU transform choice, staged after the mode decision, over the
    5 MTS pairs (cfg.mts, else DCT-II alone) and transform skip
    (cfg.transform_skip, map value TS_IDX): f(plane, size_map, mode_map,
    res_by_size) -> mts_map (units, int32).  res_by_size are Pass A's
    winner residuals, so the prediction is orig - res (same values by
    construction)."""
    _check_cfg(cfg)
    uy, ux = cfg.units_y, cfg.units_x
    lam = float(np.float32(cfg.lambda_mode))
    combos = MTS_COMBOS if cfg.mts else MTS_COMBOS[:1]
    vals = torch.tensor(list(range(len(combos)))
                        + ([TS_IDX] if cfg.transform_skip else []),
                        dtype=torch.int32, device=tab.device)
    bd = cfg.bit_depth

    def eval_size(plane, s, res):
        gy, gx = _block_positions(cfg.width, cfg.height, s)[2:]
        orig = _block_gather(plane, gy, gx, s)
        pred = orig - res
        costs = []
        for tv, th in combos:
            coefs = ktx.forward_transform(tab, res, s, tv, th, bd)
            levels = kquant.quantize(tab, coefs, cfg.qp, s, bd)
            rate = kcost.rate_nested(tab, levels)
            deq = kquant.dequantize(tab, levels, cfg.qp, s, bd)
            rres = ktx.inverse_transform(tab, deq, s, tv, th, bd)
            recon = (pred + rres).clamp(0, cfg.max_val)
            costs.append(kcost.rd_cost(kcost.sse(recon, orig), lam,
                                       rate + 2.0))
        if cfg.transform_skip:
            # the residual scaled up into the coefficient range, one
            # flag bit instead of two
            tsh = transform_shift(s, bd)
            levels = kquant.quantize(tab, res << tsh, cfg.qp, s, bd)
            rate = kcost.rate_nested(tab, levels)
            deq = kquant.dequantize(tab, levels, cfg.qp, s, bd)
            rres = (deq + (1 << (tsh - 1))) >> tsh
            recon = (pred + rres).clamp(0, cfg.max_val)
            costs.append(kcost.rd_cost(kcost.sse(recon, orig), lam,
                                       rate + 1.0))
        choice = torch.argmin(torch.stack(costs, dim=1), dim=1)
        return vals[choice].reshape(gy, gx)

    def run(plane, size_map, mode_map, res_by_size):
        plane = plane.to(torch.int32)
        mts_map = torch.zeros((uy, ux), dtype=torch.int32,
                              device=plane.device)
        for s in (8, 16, 32):
            if s > cfg.max_cu_size:
                continue
            up = _upsample(eval_size(plane, s, res_by_size[s]), s // 8,
                           uy, ux)
            mts_map = torch.where(size_map == s, up, mts_map)
        return mts_map

    return run
