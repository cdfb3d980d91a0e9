"""The P half of the inter engine (C7/C8/C16): P Pass A and the P recon
scan, as x266_tpu/engine/inter.py:42-256 and 596-877 (b_mode=False).

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
"""

from __future__ import annotations

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
    size's MV fields."""
    w, h, s = cfg.width, cfg.height, size
    dev = plane.device
    lam = torch.tensor(np.float32(cfg.lambda_mode), device=dev)
    xs_np, ys_np, gy, gx = _block_positions(w, h, s)
    nb = xs_np.shape[0]
    m_y = torch.from_numpy(ys_np // kme.ME_BLOCK).to(dev)
    m_x = torch.from_numpy(xs_np // kme.ME_BLOCK).to(dev)
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
    bd = cfg.bit_depth
    coefs = ktx.forward_transform(tab, res.reshape(nb, s, s), s,
                                  bit_depth=bd)
    levels = kquant.quantize(tab, coefs, cfg.qp, s, bd)
    rate = kcost.rate_estimate_levels(tab, levels)
    deq = kquant.dequantize(tab, levels, cfg.qp, s, bd)
    rres = ktx.inverse_transform(tab, deq, s, bit_depth=bd)
    rec = (pred + rres).clamp(0, cfg.max_val)
    cost_i = kcost.sse(rec, orig) + lam * ((rate + mv_bits) + 3.0)
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
    left = torch.from_numpy(np.maximum(np.arange(bx) - 1, 0)).to(dev)
    above = torch.from_numpy(np.maximum(np.arange(by) - 1, 0)).to(dev)
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


class InterScan:
    """The inter state of one P picture's recon scan (the plain K3):
    hands recon._scan_frame each inter CU's MC predictions and keeps the
    unit MV-state plane the skip derivation reads, which is also the
    final-MV output.  Maps are host numpy; pyramids are on the scan's
    device."""

    def __init__(self, cfg, encode, pred_map, mvx_map, mvy_map, pyrs):
        self.cfg, self.encode = cfg, encode
        self.pred, self.mvx, self.mvy = pred_map, mvx_map, mvy_map
        self.pyrs = pyrs
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
        py, pcb, pcr = self.pyrs
        cmx, cmy = mvx >> 1, mvy >> 1
        return ((interp.mc_block(py, x, y, mvx, mvy, s),
                 interp.mc_block(pcb, x // 2, y // 2, cmx, cmy, s // 2),
                 interp.mc_block(pcr, x // 2, y // 2, cmx, cmy, s // 2)),
                skip)

    def final_mvs(self):
        dev = self.pyrs[0].device
        return tuple(torch.from_numpy(m.astype(np.int16)).to(dev)
                     for m in (self.st_x, self.st_y))


def make_recon_inter_raw(cfg: CodecConfig, tab: Tables, encode: bool):
    """The plain P recon scan (the plain version of K3) over one frame.

    encode: f(srcY_pad, srcCb_pad, srcCr_pad, size_map, mode_map,
              mts_map, pred_map, mvx_map, mvy_map, pyr_y, pyr_cb, pyr_cr)
    decode: f(coefY, coefCb, coefCr, ...same maps and pyramids...)
    Planes and maps carry a leading frame dim of 1, as
    engine.recon.make_recon_pass_raw; pyramids are (16, Hp, Wp) uint8.
    Returns (reconY, reconCb, reconCr) uint8, (coefY, coefCb, coefCr)
    int16 and the final MV maps (mvx, mvy) int16 (H/8, W/8) with the
    frame dim, derived skip MVs included."""
    recon.check_slice(cfg)
    masks = {}

    def run(a, b, c, size_map, mode_map, mts_map, pred_map, mvx_map,
            mvy_map, pyr_y, pyr_cb, pyr_cr):
        if a.shape[0] != 1:
            raise ValueError("P pictures are scanned one at a time")
        if a.device not in masks:
            masks[a.device] = recon._subst_tables(cfg, a.device)
        maps = [m[0].cpu().numpy() for m in (size_map, mode_map, mts_map,
                                             pred_map, mvx_map, mvy_map)]
        inter = InterScan(cfg, encode, *maps[3:],
                          (pyr_y, pyr_cb, pyr_cr))
        out = recon._scan_frame(cfg, tab, encode, a[0].to(torch.int32),
                                b[0].to(torch.int32), c[0].to(torch.int32),
                                *maps[:3], masks[a.device], inter)
        return tuple(o[None] for o in out)

    return run


def recon_inter_pass(cfg: CodecConfig, tab: Tables, encode: bool):
    """P Pass B: CPU tensors take the plain scan, CUDA tensors kernel K3
    (encode or decode form) and nothing else."""
    plain = make_recon_inter_raw(cfg, tab, encode)

    def run(*args):
        dev = args[0].device
        if dev.type == "cuda":
            return recon_cuda.recon_inter(cfg, tab, encode, *args)
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return plain(*args)

    return run
