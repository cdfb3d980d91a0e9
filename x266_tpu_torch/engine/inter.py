"""The inter engine (C7/C8/C16): P and B Pass A and the P/B recon scan,
as x266_tpu/engine/inter.py:42-573 and 596-877, with the intra tools
(lossless, transform skip, PDPC, MIP) on P and B pictures.

Low-delay P: one reference (the previous decoded picture, on the device
as three interpolation pyramids), one MV per CU, skip (derived MV, no
residual) and quarter-pel MC.

Pass A decides per CU size between the intra candidates
(engine.mode_decision with the inter-slice preselect), an explicit-MV
candidate seeded by the 16x16 ME grid and a skip estimate that takes the
worst case over the derivable shapes {left ME MV, above ME MV, zero}.
Its predictions come from MC frames: K4 (kernels.me_cuda) on CUDA
tensors, its plain version on CPU ones; the reference holds the two
routes identical (tests/test_me_pallas.py).

Pass B is the recon scan with an inter branch per CU: MC from the
pyramids instead of intra prediction, and an MV-state plane from which
skip CUs derive their MV (left coded-MV unit, else the above one inside
the CTU row, else zero; skip CUs' own MVs are never predictors).
``make_recon_inter_raw`` is the plain version of K3;
``recon_inter_pass`` routes CUDA tensors to K3 and CPU tensors to it.

B pictures (random access) add a second reference list.  B Pass A
(``make_mode_decision_b_raw``) runs ME against both references and
ranks three explicit candidates per block -- L0, L1 and their average
``(p0 + p1 + 1) >> 1`` -- by the transform-domain cost of
``_b_candidates``, then competes the winner against intra and skip.
The kinds PRED_L1 (MC from L1 at the primary MV) and PRED_BI (L0 at the
primary MV, L1 at the mv1 maps) are coded-MV kinds, so they feed the
one-hop skip derivation; the B scan (``b_mode``, the plain K3-B) is the
P scan with those two predictions.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from x266_tpu_torch.config import CodecConfig
from x266_tpu_torch.engine import recon, recon_cuda
from x266_tpu_torch.engine.mode_decision import (SPLIT_BITS, _block_gather,
                                                 _block_positions,
                                                 _check_cfg, _eval_size,
                                                 _Geometry, _sum_children,
                                                 _upsample)
from x266_tpu_torch.kernels import cost as kcost
from x266_tpu_torch.kernels import interp
from x266_tpu_torch.kernels import me as kme
from x266_tpu_torch.kernels import me_cuda
from x266_tpu_torch.kernels import quant as kquant
from x266_tpu_torch.kernels import transforms as ktx
from x266_tpu_torch.tables import Tables

PRED_INTRA, PRED_INTER, PRED_SKIP = 0, 1, 2
PRED_L1, PRED_BI = 3, 4          # B slices: L1-only and bi-prediction

# B Pass A's blocks whose float32 transform-domain error sum reached
# 2^24 for one of the three candidates: below it every partial sum is an
# exact integer and any order gives the reference's sum; above it only
# XLA CPU's order does, which kernels.cost.row_vector_sum follows (ROADMAP
# queue 3, F10: closed).  Device counts per (size, device), added to
# without a host read; see f10_blocks.
F10_BLOCKS: dict = {}


def f10_blocks() -> dict[int, int]:
    """The F10_BLOCKS counts per block size, summed over devices."""
    out = {8: 0, 16: 0, 32: 0}
    for (s, _), n in F10_BLOCKS.items():
        out[s] += int(n)
    return out


MVBITS_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "data", "mvbits_f32.npy")


def _coded_mv(kind) -> bool:
    """A predictor-eligible neighbour: a coded-MV inter CU (neither
    intra nor skip), so skip derivation takes one hop at most."""
    return kind != PRED_INTRA and kind != PRED_SKIP


def mv_predictor_np(pred_map, mvx_map, mvy_map, ux, uy):
    """The skip-MV predictor rule on host maps (the entropy walkers
    mirror it)."""
    if ux > 0 and _coded_mv(pred_map[uy, ux - 1]):
        return int(mvx_map[uy, ux - 1]), int(mvy_map[uy, ux - 1])
    if uy > 0 and (uy & 7) != 0 and _coded_mv(pred_map[uy - 1, ux]):
        return int(mvx_map[uy - 1, ux]), int(mvy_map[uy - 1, ux])
    return 0, 0


def _blockify(frame: torch.Tensor, gy: int, gx: int, s: int
              ) -> torch.Tensor:
    """(>=gy*s, >=gx*s) frame -> (gy*gx, s, s), zero-padded when
    smaller."""
    ph, pw = gy * s - frame.shape[0], gx * s - frame.shape[1]
    if ph > 0 or pw > 0:
        frame = torch.nn.functional.pad(frame, (0, max(pw, 0),
                                                0, max(ph, 0)))
    blk = frame[:gy * s, :gx * s].reshape(gy, s, gx, s).permute(0, 2, 1, 3)
    return blk.reshape(gy * gx, s, s)


@functools.lru_cache(maxsize=None)
def _me_cells(w: int, h: int, s: int, device: torch.device):
    """(m_y, m_x): the ME-grid cell of each size-s block of a w x h
    picture, on device, uploaded once."""
    xs, ys, _, _ = _block_positions(w, h, s)
    return (torch.from_numpy(ys // kme.ME_BLOCK).to(device),
            torch.from_numpy(xs // kme.ME_BLOCK).to(device))


def _mv_bits(mvbits: torch.Tensor, mv: torch.Tensor,
             mvl: torch.Tensor) -> torch.Tensor:
    """sum over x, y of 2 + 2*log2(|mv - mvl| + 1), float32, from the
    JAX-evaluated table (torch.log2 differs in the last bit)."""
    d = (mv - mvl).abs().long()
    return mvbits[d[:, 0]] + mvbits[d[:, 1]]


def _inter_cost(cfg: CodecConfig, tab: Tables, mvbits: torch.Tensor,
                plane: torch.Tensor, pyr_y: torch.Tensor,
                mv_grid: torch.Tensor, size: int, warped):
    """Explicit-inter and skip costs of all size-s blocks:
    (cost_inter, mvx, mvy, cost_skip, merge_idx), each (gy, gx).
    warped: the (explicit, skip-left, skip-above) MC frames of this
    size's MV fields.  Lossless: the explicit cost is lam times the rate
    of the residual and the MV bits, skip costs +inf."""
    w, h, s = cfg.width, cfg.height, size
    dev = plane.device
    lam = float(np.float32(cfg.lambda_mode))    # a multiplier: no upload
    _, _, gy, gx = _block_positions(w, h, s)
    m_y, m_x = _me_cells(w, h, s, dev)
    nb = m_y.shape[0]
    mv = mv_grid[m_y, m_x]                        # (B, 2) quarter-pel
    mvl = mv_grid[m_y, (m_x - 1).clamp_min(0)]

    orig = _block_gather(plane, gy, gx, s)        # (B, s, s)
    pred = _blockify(warped[0], gy, gx, s)
    pred_skl = _blockify(warped[1], gy, gx, s)
    pred_ska = _blockify(warped[2], gy, gx, s)
    rp = interp.REF_PAD
    pred_zero = _blockify(pyr_y[0, rp:rp + h, rp:rp + w].to(torch.int32),
                          gy, gx, s)

    res = orig - pred
    mv_bits = _mv_bits(mvbits, mv, mvl)
    sse_l = kcost.sse(pred_skl, orig)
    sse_a = kcost.sse(pred_ska, orig)
    sse_z = kcost.sse(pred_zero, orig)
    d_c0 = torch.maximum(torch.maximum(sse_l, sse_a), sse_z)
    if cfg.merge_cands:
        # merge list: candidate 0 derives left-first (worst case over
        # all three shapes), candidate 1 is the above rule
        d_c1 = torch.maximum(sse_a, sse_z)
        midx = (d_c1 < d_c0).to(torch.int32)
        dist_s = torch.minimum(d_c0, d_c1)
    else:
        midx = torch.zeros(sse_l.shape, dtype=torch.int32, device=dev)
        dist_s = d_c0
    if cfg.lossless:
        # the residual is coded as it is: its rate is the cost; skip has
        # no residual and its MV is derived only in Pass B, so it cannot
        # be shown lossless here and is never chosen
        rate = kcost.rate_inter_residual(tab, res)
        cost_i = lam * ((rate + mv_bits) + 3.0)
        cost_s = torch.full_like(dist_s, float("inf"))
    else:
        bd = cfg.bit_depth
        coefs = ktx.forward_transform(tab, res.reshape(nb, s, s), s,
                                      bit_depth=bd)
        levels = kquant.quantize(tab, coefs, cfg.qp, s, bd)
        # XLA nests the rate sum in the cost's loop fusion and contracts
        # D + lam * R into a fused multiply-add, as in intra Pass A (F12)
        rate = kcost.rate_nested(tab, levels)
        deq = kquant.dequantize(tab, levels, cfg.qp, s, bd)
        rres = ktx.inverse_transform(tab, deq, s, bit_depth=bd)
        rec = (pred + rres).clamp(0, cfg.max_val)
        cost_i = kcost.rd_cost(kcost.sse(rec, orig), lam,
                               (rate + mv_bits) + 3.0)
        cost_s = dist_s + lam * 2.0
    g = lambda v: v.reshape(gy, gx)              # noqa: E731
    return g(cost_i), g(mv[:, 0]), g(mv[:, 1]), g(cost_s), g(midx)


def _rep2(g: torch.Tensor, by: int, bx: int) -> torch.Tensor:
    """2x2-replicate the even-index subgrid back to (by, bx)."""
    r = g[0::2, 0::2].repeat_interleave(2, 0).repeat_interleave(2, 1)
    return r[:by, :bx]


def warp_fields(mv_grid: torch.Tensor, max_cu_size: int) -> torch.Tensor:
    """The MV fields P Pass A warps with K4: the ME grid, its left and
    above neighbours' MVs, and with 32x32 CUs the same three 2x2
    replicated -> (T, By, Bx, 2) int32, T = 3 or 6."""
    by, bx = mv_grid.shape[:2]
    dev = mv_grid.device
    left = (torch.arange(bx, device=dev) - 1).clamp_min(0)
    above = (torch.arange(by, device=dev) - 1).clamp_min(0)
    fields = [mv_grid, mv_grid[:, left], mv_grid[above, :]]
    if max_cu_size >= 32:
        fields += [_rep2(f, by, bx) for f in fields]
    return torch.stack(fields).contiguous()


def make_mode_decision_p_raw(cfg: CodecConfig, tab: Tables):
    """P Pass A: padded luma plane (1+H+PAD, 1+W+PAD) and the reference's
    luma pyramid -> (size_map, mode_map, pred_map, mvx_map, mvy_map),
    each (H/8, W/8) int32.  With cfg.merge_cands skip CUs carry their
    merge index in the mvx map."""
    _check_cfg(cfg)
    uy, ux = cfg.units_y, cfg.units_x
    geom = _Geometry(cfg, tab.device)
    mvbits = torch.from_numpy(np.load(MVBITS_PATH)).to(tab.device)
    split = torch.tensor(np.float32(cfg.lambda_mode) * np.float32(
        SPLIT_BITS), device=tab.device)
    sizes = [s for s in (8, 16, 32) if s <= cfg.max_cu_size]

    def run(plane: torch.Tensor, pyr_y: torch.Tensor):
        plane = plane.to(torch.int32)
        dev = plane.device
        mv_grid = kme.me_search(plane[1:1 + cfg.height, 1:1 + cfg.width],
                                pyr_y, cfg, float(cfg.lambda_mode))
        frames = me_cuda.warp_frames(pyr_y,
                                     warp_fields(mv_grid, cfg.max_cu_size))
        warp = {8: frames[0:3], 16: frames[0:3], 32: frames[3:6]}

        per_size = {}
        for s in sizes:
            cost_intra, mode_intra, _ = _eval_size(plane, s, cfg, tab, geom,
                                                   inter_slice=True)
            c_int, mvx, mvy, c_skip, midx = _inter_cost(
                cfg, tab, mvbits, plane, pyr_y, mv_grid, s, warp[s])
            inf = torch.full_like(c_int, float("inf"))
            valid = torch.isfinite(cost_intra)
            c_int = torch.where(valid, c_int, inf)
            c_skip = torch.where(valid, c_skip, inf)
            best = torch.minimum(torch.minimum(cost_intra, c_int), c_skip)
            kind = torch.where(
                c_skip <= torch.minimum(cost_intra, c_int), PRED_SKIP,
                torch.where(c_int < cost_intra, PRED_INTER, PRED_INTRA)
            ).to(torch.int32)
            if cfg.merge_cands:
                # skip CUs carry merge_idx in the mvx slot
                mvx = torch.where(kind == PRED_SKIP, midx, mvx)
                mvy = torch.where(kind == PRED_SKIP, 0, mvy)
            per_size[s] = (best, mode_intra, kind, mvx, mvy)

        best, *maps = per_size[8]
        maps = [m.to(torch.int32) for m in maps]
        size_map = torch.full((uy, ux), 8, dtype=torch.int32, device=dev)
        for s in sizes[1:]:
            bs, *ms = per_size[s]
            child = _sum_children(best, *bs.shape) + split
            use = bs <= child
            sel = _upsample(use, s // 8, uy, ux)
            size_map = torch.where(sel, s, size_map)
            maps = [torch.where(sel, _upsample(m, s // 8, uy, ux), mp)
                    for m, mp in zip(ms, maps)]
            best = torch.where(use, bs, child)
        return tuple(m.contiguous() for m in (size_map, *maps))

    return run


def _fwd_gain2(tab: Tables, s: int, bit_depth: int) -> float:
    """||T(r)||^2 / ||r||^2 of the exact forward DCT-II on the reference's
    fixed random residuals (numpy default_rng(7)): the factor that puts
    B Pass A's transform-domain quantization error on the spatial SSE
    scale.  The transform is exact, so this equals the reference's."""
    r = np.random.default_rng(7).integers(-64, 64, (64, s, s)).astype(
        np.int32)
    c = ktx.forward_transform(tab, torch.from_numpy(r).to(tab.device), s,
                              bit_depth=bit_depth).cpu().numpy()
    return float(np.sum(c.astype(np.float64) ** 2)
                 / np.sum(r.astype(np.float64) ** 2))


def _b_candidates(cfg: CodecConfig, tab: Tables, mvbits: torch.Tensor,
                  plane: torch.Tensor, pyr0_y: torch.Tensor,
                  g0: torch.Tensor, g1: torch.Tensor, size: int, warp0,
                  warp1, g2_inv: torch.Tensor):
    """The explicit B candidates (L0, L1, bi) and skip of all size-s
    blocks: the three MC predictions are ranked by the transform-domain
    cost (quantization error / g2 + lambda * bits) and only the winner
    runs the inverse transform.  warp0: this size's (explicit, skip-left,
    skip-above) L0 MC frames, warp1 its L1 frame; g2_inv: the float32
    reciprocal of the size's _fwd_gain2, on the device (XLA multiplies
    by it where the reference divides by the constant).

    Lossless ranks the candidates by lam times the rate of their
    residuals and the MV bits, which is also their cost; skip costs +inf.

    Returns (cost_expl, kind_expl, pmx, pmy, smx, smy, cost_skip, midx),
    each (gy, gx): kind_expl in {PRED_INTER, PRED_L1, PRED_BI}; the
    primary MV (L1's for PRED_L1, else L0's) and, for PRED_BI, the L1
    MV."""
    w, h, s = cfg.width, cfg.height, size
    dev = plane.device
    lam = float(np.float32(cfg.lambda_mode))    # a multiplier: no upload
    _, _, gy, gx = _block_positions(w, h, s)
    m_y, m_x = _me_cells(w, h, s, dev)
    nb = m_y.shape[0]
    m_xl = (m_x - 1).clamp_min(0)
    mv0, mv1 = g0[m_y, m_x], g1[m_y, m_x]
    mvl0, mvl1 = g0[m_y, m_xl], g1[m_y, m_xl]

    orig = _block_gather(plane, gy, gx, s)
    p0 = _blockify(warp0[0], gy, gx, s)
    p_skl = _blockify(warp0[1], gy, gx, s)
    p_ska = _blockify(warp0[2], gy, gx, s)
    p1 = _blockify(warp1, gy, gx, s)
    pbi = (p0 + p1 + 1) >> 1
    rp = interp.REF_PAD
    p_zero = _blockify(pyr0_y[0, rp:rp + h, rp:rp + w].to(torch.int32),
                       gy, gx, s)

    b0 = _mv_bits(mvbits, mv0, mvl0)
    b1 = _mv_bits(mvbits, mv1, mvl1)
    bits = (b0 + 3.0, b1 + 3.0, (b0 + b1) + 6.0)

    sse_l = kcost.sse(p_skl, orig)
    sse_a = kcost.sse(p_ska, orig)
    sse_z = kcost.sse(p_zero, orig)
    d_c0 = torch.maximum(torch.maximum(sse_l, sse_a), sse_z)
    if cfg.merge_cands:
        d_c1 = torch.maximum(sse_a, sse_z)
        midx = (d_c1 < d_c0).to(torch.int32)
        dist_s = torch.minimum(d_c0, d_c1)
    else:
        midx = torch.zeros(sse_l.shape, dtype=torch.int32, device=dev)
        dist_s = d_c0

    if cfg.lossless:
        # each candidate's residual is coded as it is: its rate is the
        # cost, so the ranking is exact; skip is never chosen (as in
        # _inter_cost)
        pre = torch.stack([
            lam * (kcost.rate_inter_residual(tab, orig - p, bi=k == 2) + b)
            for k, (p, b) in enumerate(zip((p0, p1, pbi), bits))], dim=1)
        kind_pre = torch.argmin(pre, dim=1)
        cost = torch.gather(pre, 1, kind_pre[:, None])[:, 0]
        cost_s = torch.full_like(dist_s, float("inf"))
    else:
        bd = cfg.bit_depth
        coefs, deqs, rbs = [], [], []
        for p, b in zip((p0, p1, pbi), bits):
            coefs.append(ktx.forward_transform(
                tab, (orig - p).reshape(nb, s, s), s, bit_depth=bd))
            levels = kquant.quantize(tab, coefs[-1], cfg.qp, s, bd)
            deqs.append(kquant.dequantize(tab, levels, cfg.qp, s, bd))
            rbs.append(kcost.rate_nested(tab, levels) + b)
        # the reference's float32 block sums, in the order XLA CPU gives a
        # reduction fused into the candidates' argmin (F10, and the rate
        # sums with them), then its division by g2, which XLA makes a
        # product with the reciprocal, contracted with the sum into a
        # fused multiply-add: err * (1 / g2) + fl(lam * rb)
        err = kcost.row_vector_sum(
            (torch.stack(coefs) - torch.stack(deqs)).to(torch.float32) ** 2)
        key = (s, str(dev))
        F10_BLOCKS[key] = F10_BLOCKS.get(key, 0) + (
            err >= 2.0 ** 24).any(0).sum()
        cands = [(deq, kcost.fma_f32(err[k], g2_inv, lam * rb), rb)
                 for k, (deq, rb) in enumerate(zip(deqs, rbs))]
        kind_pre = torch.argmin(torch.stack([c[1] for c in cands], dim=1),
                                dim=1)
        sel3 = kind_pre[:, None, None]
        deq = torch.where(sel3 == 0, cands[0][0],
                          torch.where(sel3 == 1, cands[1][0], cands[2][0]))
        rb = torch.where(kind_pre == 0, cands[0][2],
                         torch.where(kind_pre == 1, cands[1][2], cands[2][2]))
        pred = torch.where(sel3 == 0, p0, torch.where(sel3 == 1, p1, pbi))
        rres = ktx.inverse_transform(tab, deq, s, bit_depth=bd)
        rec = (pred + rres).clamp(0, cfg.max_val)
        cost = kcost.rd_cost(kcost.sse(rec, orig), lam, rb)
        cost_s = dist_s + lam * 2.0

    kind_expl = torch.where(kind_pre == 0, PRED_INTER,
                            torch.where(kind_pre == 1, PRED_L1, PRED_BI))
    pmx = torch.where(kind_pre == 1, mv1[:, 0], mv0[:, 0])
    pmy = torch.where(kind_pre == 1, mv1[:, 1], mv0[:, 1])
    smx = torch.where(kind_pre == 2, mv1[:, 0], 0)
    smy = torch.where(kind_pre == 2, mv1[:, 1], 0)
    g = lambda v: v.reshape(gy, gx)              # noqa: E731
    return (g(cost), g(kind_expl), g(pmx), g(pmy), g(smx), g(smy),
            g(cost_s), g(midx))


def make_mode_decision_b_raw(cfg: CodecConfig, tab: Tables):
    """B Pass A: padded luma plane and the L0 / L1 luma pyramids ->
    (size_map, mode_map, pred_map, mvx_map, mvy_map, mvx1_map,
    mvy1_map), each (H/8, W/8) int32.  The primary MV maps carry L0's MV
    for INTER, SKIP and BI and L1's for PRED_L1 (skip CUs the merge index
    with cfg.merge_cands); the mv1 maps carry BI's L1 MV, else 0.  K4
    warps T = 6 fields on L0 and T = 2 on L1, K5 refines once per list."""
    _check_cfg(cfg)
    uy, ux = cfg.units_y, cfg.units_x
    geom = _Geometry(cfg, tab.device)
    mvbits = torch.from_numpy(np.load(MVBITS_PATH)).to(tab.device)
    split = torch.tensor(np.float32(cfg.lambda_mode) * np.float32(
        SPLIT_BITS), device=tab.device)
    sizes = [s for s in (8, 16, 32) if s <= cfg.max_cu_size]
    gain2_inv = {s: torch.tensor(np.float32(1) / np.float32(
        _fwd_gain2(tab, s, cfg.bit_depth)), device=tab.device)
        for s in sizes}

    def run(plane: torch.Tensor, pyr0_y: torch.Tensor, pyr1_y: torch.Tensor):
        plane = plane.to(torch.int32)
        dev = plane.device
        cur = plane[1:1 + cfg.height, 1:1 + cfg.width]
        lam = float(cfg.lambda_mode)
        g0 = kme.me_search(cur, pyr0_y, cfg, lam)
        g1 = kme.me_search(cur, pyr1_y, cfg, lam)
        fr0 = me_cuda.warp_frames(pyr0_y, warp_fields(g0, cfg.max_cu_size))
        f1 = [g1]
        if cfg.max_cu_size >= 32:
            f1.append(_rep2(g1, *g1.shape[:2]))
        fr1 = me_cuda.warp_frames(pyr1_y, torch.stack(f1).contiguous())
        warp = {8: (fr0[0:3], fr1[0]), 16: (fr0[0:3], fr1[0]),
                32: (fr0[3:6], fr1[-1])}

        per_size = {}
        for s in sizes:
            cost_intra, mode_intra, _ = _eval_size(plane, s, cfg, tab, geom,
                                                   inter_slice=True)
            (c_expl, kind_expl, pmx, pmy, smx, smy, c_skip,
             midx) = _b_candidates(cfg, tab, mvbits, plane, pyr0_y, g0, g1,
                                   s, *warp[s], gain2_inv[s])
            inf = torch.full_like(c_expl, float("inf"))
            valid = torch.isfinite(cost_intra)
            c_expl = torch.where(valid, c_expl, inf)
            c_skip = torch.where(valid, c_skip, inf)
            kind = torch.where(
                c_skip <= torch.minimum(cost_intra, c_expl), PRED_SKIP,
                torch.where(c_expl < cost_intra, kind_expl, PRED_INTRA)
            ).to(torch.int32)
            best = torch.minimum(torch.minimum(cost_intra, c_expl), c_skip)
            if cfg.merge_cands:
                pmx = torch.where(kind == PRED_SKIP, midx, pmx)
                pmy = torch.where(kind == PRED_SKIP, 0, pmy)
            smx = torch.where(kind == PRED_BI, smx, 0)
            smy = torch.where(kind == PRED_BI, smy, 0)
            per_size[s] = (best, mode_intra, kind, pmx, pmy, smx, smy)

        best, *maps = per_size[8]
        maps = [m.to(torch.int32) for m in maps]
        size_map = torch.full((uy, ux), 8, dtype=torch.int32, device=dev)
        for s in sizes[1:]:
            bs, *ms = per_size[s]
            child = _sum_children(best, *bs.shape) + split
            use = bs <= child
            sel = _upsample(use, s // 8, uy, ux)
            size_map = torch.where(sel, s, size_map)
            maps = [torch.where(sel, _upsample(m, s // 8, uy, ux), mp)
                    for m, mp in zip(ms, maps)]
            best = torch.where(use, bs, child)
        return tuple(m.contiguous() for m in (size_map, *maps))

    return run


class InterScan:
    """The inter state of one P or B picture's recon scan (the plain K3):
    hands recon._scan_frame each inter CU's MC predictions and keeps the
    unit MV-state plane the skip derivation reads, which is also the
    final-MV output.  Maps are host numpy; pyramids are on the scan's
    device.  A B picture adds the L1 pyramids and the mv1 maps.  Intra
    CUs take recon._tu as in an I picture (PDPC on luma, MIP with planar
    chroma); every CU's residual goes through recon.residual_path, so
    lossless holds for inter CUs too (a skip CU: level 0, recon =
    clip(prediction))."""

    def __init__(self, cfg, encode, pred_map, mvx_map, mvy_map, pyrs,
                 pyrs1=None, mvx1_map=None, mvy1_map=None):
        self.cfg, self.encode = cfg, encode
        self.pred, self.mvx, self.mvy = pred_map, mvx_map, mvy_map
        self.pyrs, self.pyrs1 = pyrs, pyrs1
        self.mvx1, self.mvy1 = mvx1_map, mvy1_map
        self.st_x = np.zeros(pred_map.shape, np.int32)
        self.st_y = np.zeros(pred_map.shape, np.int32)

    def _above(self, ux, uy):
        if uy > 0 and (uy & 7) != 0 and _coded_mv(self.pred[uy - 1, ux]):
            return int(self.st_x[uy - 1, ux]), int(self.st_y[uy - 1, ux])
        return None

    def predict(self, ux, uy, s):
        kind = int(self.pred[uy, ux])
        skip = kind == PRED_SKIP
        if not skip:
            mvx, mvy = int(self.mvx[uy, ux]), int(self.mvy[uy, ux])
        elif not self.cfg.merge_cands:
            mvx, mvy = mv_predictor_np(self.pred, self.st_x, self.st_y, ux,
                                       uy)
        elif self.encode:
            # candidate 1 (merge index 1 in the mvx slot): the above rule
            use1 = int(self.mvx[uy, ux]) == 1
            mvx, mvy = ((self._above(ux, uy) or (0, 0)) if use1
                        else mv_predictor_np(self.pred, self.st_x,
                                             self.st_y, ux, uy))
        else:
            # decode: the entropy walker resolved the candidate
            mvx, mvy = int(self.mvx[uy, ux]), int(self.mvy[uy, ux])
        u = s // 8
        self.st_x[uy:uy + u, ux:ux + u] = mvx
        self.st_y[uy:uy + u, ux:ux + u] = mvy
        if kind == PRED_INTRA:
            return None
        x, y = ux * 8, uy * 8

        def mc(pyrs, mx, my):
            py, pcb, pcr = pyrs
            cmx, cmy = mx >> 1, my >> 1
            return (interp.mc_block(py, x, y, mx, my, s),
                    interp.mc_block(pcb, x // 2, y // 2, cmx, cmy, s // 2),
                    interp.mc_block(pcr, x // 2, y // 2, cmx, cmy, s // 2))

        if kind == PRED_L1:
            return mc(self.pyrs1, mvx, mvy), False
        if kind == PRED_BI:
            p0 = mc(self.pyrs, mvx, mvy)
            p1 = mc(self.pyrs1, int(self.mvx1[uy, ux]),
                    int(self.mvy1[uy, ux]))
            return tuple((a + b + 1) >> 1 for a, b in zip(p0, p1)), False
        return mc(self.pyrs, mvx, mvy), skip

    def final_mvs(self):
        dev = self.pyrs[0].device
        return tuple(torch.from_numpy(m.astype(np.int16)).to(dev)
                     for m in (self.st_x, self.st_y))


def make_recon_inter_raw(cfg: CodecConfig, tab: Tables, encode: bool,
                         b_mode: bool = False):
    """The plain P or B recon scan (the plain version of K3-P, K3-B) over
    one frame.

    encode: f(srcY_pad, srcCb_pad, srcCr_pad, size_map, mode_map,
              mts_map, pred_map, mvx_map, mvy_map, pyr_y, pyr_cb, pyr_cr
              [, pyr1_y, pyr1_cb, pyr1_cr, mvx1_map, mvy1_map])
    decode: f(coefY, coefCb, coefCr, ...same maps and pyramids...)
    The bracketed L1 arguments are those of b_mode.  Planes and maps
    carry a leading frame dim of 1, as engine.recon.make_recon_pass_raw;
    pyramids are (16, Hp, Wp) uint8.  Returns (reconY, reconCb, reconCr)
    uint8, (coefY, coefCb, coefCr) int16 and the final (primary) MV maps
    (mvx, mvy) int16 (H/8, W/8) with the frame dim, derived skip MVs
    included.

    It carries the intra tools as K3 does: lossless (inter and intra
    CUs; a skip CU codes level 0), PDPC and MIP on intra CUs, and
    transform skip wherever the mts map holds it, which on P and B
    pictures it never does (their mts map is 0, as the reference's)."""
    recon.check_slice(cfg)
    masks = {}

    def run(a, b, c, size_map, mode_map, mts_map, pred_map, mvx_map,
            mvy_map, pyr_y, pyr_cb, pyr_cr, *l1):
        if a.shape[0] != 1:
            raise ValueError("inter pictures are scanned one at a time")
        if len(l1) != (5 if b_mode else 0):
            raise ValueError("the B scan takes the L1 pyramids and mv1 "
                             "maps, the P scan neither")
        if a.device not in masks:
            masks[a.device] = recon._subst_tables(cfg, a.device)
        maps = [m[0].cpu().numpy() for m in (size_map, mode_map, mts_map,
                                             pred_map, mvx_map, mvy_map)]
        extra = ((l1[:3], l1[3][0].cpu().numpy(), l1[4][0].cpu().numpy())
                 if b_mode else ())
        inter = InterScan(cfg, encode, *maps[3:],
                          (pyr_y, pyr_cb, pyr_cr), *extra)
        out = recon._scan_frame(cfg, tab, encode, a[0].to(torch.int32),
                                b[0].to(torch.int32), c[0].to(torch.int32),
                                *maps[:3], masks[a.device], inter)
        return tuple(o[None] for o in out)

    return run


def recon_inter_pass(cfg: CodecConfig, tab: Tables, encode: bool,
                     b_mode: bool = False):
    """P or B Pass B: CPU tensors take the plain scan, CUDA tensors kernel
    K3-P or K3-B (encode or decode form) and nothing else."""
    plain = make_recon_inter_raw(cfg, tab, encode, b_mode)

    def run(*args):
        dev = args[0].device
        if dev.type == "cuda":
            return recon_cuda.recon_inter(cfg, tab, encode, *args)
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return plain(*args)

    return run
