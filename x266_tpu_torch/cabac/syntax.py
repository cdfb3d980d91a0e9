"""Picture-level syntax coding: quadtree, modes, residuals (C4) [STD-shaped].

Pure-Python reference implementation of the x266t entropy syntax; the
native C++ engine in ``native/`` mirrors it bit-for-bit (differential
tests).  Structure follows HEVC's coding-tree / coefficient-coding design:
z-order quadtree with context-coded split flags, MPM-based luma mode
coding, per-TU coefficient coding in 4x4 coefficient groups with
reverse-diagonal scan, last-significant-position prefix/suffix, csbf,
significance, >1/>2 flags and Golomb-Rice remainders [STD]; sign-data
hiding per 4x4 CG when cfg.sign_data_hiding (C11).  Deviations
(documented, self-consistent): fresh contexts per segment, no
inferred-sig shortcut, per-coefficient inline signs.

The walker is deterministic given (size_map, mode_map, coef planes) — the
decoder reconstructs exactly these arrays, which then drive the same
Pass-B reconstruction the encoder ran.
"""

from __future__ import annotations

import functools

import numpy as np

from x266_tpu_torch.cabac import contexts as cx
from x266_tpu_torch.cabac import ctx_init
from x266_tpu_torch.cabac.engine import ContextSet, RangeDecoder, RangeEncoder
from x266_tpu_torch.config import CodecConfig
from x266_tpu_torch.specmodel.intra import DC, PLANAR

PRED_INTRA, PRED_INTER, PRED_SKIP = 0, 1, 2
PRED_L1, PRED_BI = 3, 4


@functools.cache
def diag_scan(n: int) -> np.ndarray:
    """(n*n, 2) array of (x, y), up-right diagonal scan order [STD]."""
    pos = []
    for d in range(2 * n - 1):
        y = min(d, n - 1)
        while y >= 0 and d - y < n:
            x = d - y
            pos.append((x, y))
            y -= 1
    return np.array(pos, dtype=np.int32)


@functools.cache
def tu_scan(size: int) -> np.ndarray:
    """(size*size, 2) full-TU scan: CGs diagonally, 16 positions per CG."""
    ncg = size // 4
    cgs = diag_scan(ncg)
    inner = diag_scan(4)
    out = []
    for cgx, cgy in cgs:
        for px, py in inner:
            out.append((cgx * 4 + px, cgy * 4 + py))
    return np.array(out, dtype=np.int32)


def mpm_list(left: int, above: int, n_modes: int = 35) -> list[int]:
    """Most-probable-mode list from neighbor modes [STD-shaped].
    Works for both the 35-mode (wrap over 33 angulars, vertical=26) and
    the 67-mode family (wrap over 65 angulars, vertical=50)."""
    vert = 26 if n_modes == 35 else 50
    n_ang = n_modes - 2
    if left == above:
        if left < 2:
            return [PLANAR, DC, vert]
        return [left, 2 + ((left - 2 + n_ang - 1) % n_ang),
                2 + ((left - 2 + 1) % n_ang)]
    third = next(m for m in (PLANAR, DC, vert)
                 if m not in (left, above))
    return [left, above, third]


class _Walker:
    """Shared geometry walk for encode and decode."""

    def __init__(self, cfg: CodecConfig):
        self.cfg = cfg
        self.w, self.h = cfg.width, cfg.height
        self.n_modes = cfg.n_intra_modes
        self.mode_bits = 5 if self.n_modes == 35 else 6

    @staticmethod
    def _coded_mv(kind) -> bool:
        """Predictor-eligible neighbor: coded-MV inter, NOT skip (the
        one-hop derivation rule; engine.inter._coded_mv)."""
        return kind != PRED_INTRA and kind != PRED_SKIP

    def _mv_predictor(self, ux, uy):
        """Skip/MVD predictor; mirrors engine.inter.mv_predictor_np and
        the device rule in the recon scan exactly."""
        pm, mx, my = self.pred_map, self.mvx_map, self.mvy_map
        if ux > 0 and self._coded_mv(pm[uy, ux - 1]):
            return int(mx[uy, ux - 1]), int(my[uy, ux - 1])
        if uy > 0 and (uy & 7) != 0 and self._coded_mv(pm[uy - 1, ux]):
            return int(mx[uy - 1, ux]), int(my[uy - 1, ux])
        return 0, 0

    def _mv_above(self, ux, uy):
        """Merge candidate 1 (C7): the above rule alone."""
        pm, mx, my = self.pred_map, self.mvx_map, self.mvy_map
        if uy > 0 and (uy & 7) != 0 and self._coded_mv(pm[uy - 1, ux]):
            return int(mx[uy - 1, ux]), int(my[uy - 1, ux])
        return 0, 0

    # -- neighbor mode derivation (line-buffer-free rule [STD-shaped]) -----
    def _neighbor_modes(self, mode_map, ux, uy):
        """Non-intra neighbors count as DC [STD]: in P slices the
        decoder has no intra mode for inter CUs, so both sides must
        ignore mode_map there."""
        left = above = DC
        if ux > 0 and (not self.is_p
                       or self.pred_map[uy, ux - 1] == PRED_INTRA):
            left = int(mode_map[uy, ux - 1])
        if uy > 0 and (uy & 7) != 0 and (
                not self.is_p
                or self.pred_map[uy - 1, ux] == PRED_INTRA):
            above = int(mode_map[uy - 1, ux])
        # MIP neighbors derive MPMs as planar (C6, VVC-shaped rule)
        if left >= self.n_modes:
            left = PLANAR
        if above >= self.n_modes:
            above = PLANAR
        return left, above


def flat_states(ctxs: "ContextSet") -> np.ndarray:
    """Context states -> flat int32 [pf(n), ps(n)] (the native load()
    layout, shared by the WPP-inheritance snapshots)."""
    return np.concatenate([ctxs.p[:, 0], ctxs.p[:, 1]]).astype(np.int32)


def states_init(flat: np.ndarray) -> np.ndarray:
    """Flat [pf, ps] -> the (n, 2) uint16 ContextSet init layout."""
    n = flat.shape[0] // 2
    return np.stack([flat[:n], flat[n:]], axis=1).astype(np.uint16)


class SyntaxEncoder(_Walker):
    def __init__(self, cfg: CodecConfig, size_map, mode_map,
                 coef_y, coef_cb, coef_cr, sao_params=None,
                 mts_map=None, is_p=False, pred_map=None,
                 mvx_map=None, mvy_map=None, is_b=False,
                 mvx1_map=None, mvy1_map=None):
        super().__init__(cfg)
        self.size_map = np.asarray(size_map)
        self.mode_map = np.asarray(mode_map)
        self.mts_map = (np.asarray(mts_map) if mts_map is not None
                        else np.zeros_like(self.size_map))
        self.is_p = is_p or is_b
        self.is_b = is_b
        z = np.zeros_like(self.size_map)
        self.pred_map = (np.asarray(pred_map) if pred_map is not None
                         else z)
        self.mvx_map = (np.asarray(mvx_map) if mvx_map is not None
                        else z)
        self.mvy_map = (np.asarray(mvy_map) if mvy_map is not None
                        else z)
        self.mvx1_map = (np.asarray(mvx1_map) if mvx1_map is not None
                         else z)
        self.mvy1_map = (np.asarray(mvy1_map) if mvy1_map is not None
                         else z)
        self.coef = {"y": np.asarray(coef_y), "cb": np.asarray(coef_cb),
                     "cr": np.asarray(coef_cr)}
        if sao_params is not None:
            st, sb, so = (np.asarray(a) for a in sao_params)
            if st.ndim == 2:           # legacy luma-only params
                st = np.stack([st, np.zeros_like(st),
                               np.zeros_like(st)])
                sb = np.stack([sb, np.zeros_like(sb),
                               np.zeros_like(sb)])
                so = np.stack([so, np.zeros_like(so),
                               np.zeros_like(so)])
            self.sao = (st, sb, so)
        else:
            self.sao = None

    def encode_segment(self, ctu_row0: int, ctu_row1: int,
                       init_states=None, snapshot: bool = False
                       ) -> bytes:
        """init_states: flat [pf, ps] int32 overriding the trained
        init (WPP context inheritance, P6 round-5); snapshot=True
        captures self.snapshot (same layout) after the segment's
        first min(2, ctus_x) CTUs — the next segment inits there."""
        self.enc = RangeEncoder()
        self.ctxs = ContextSet(
            cx.NUM_CONTEXTS,
            states_init(init_states) if init_states is not None
            else ctx_init.table(self.cfg, self.is_p, self.is_b))
        self.snapshot = None
        snap_after = min(2, self.cfg.ctus_x) if snapshot else 0
        coded = 0
        for cy in range(ctu_row0, ctu_row1):
            for cxi in range(self.cfg.ctus_x):
                if self.cfg.sao:
                    self._sao_params(cy, cxi)
                self._node(cxi * 64, cy * 64, 64)
                coded += 1
                if coded == snap_after:
                    self.snapshot = flat_states(self.ctxs)
        return self.enc.finish()

    def _sao_params(self, cy, cxi):
        """Per-CTB SAO signalling [STD-shaped]: on flag, band/edge kind,
        class or band position, 4 offsets (edge: magnitudes only).
        Luma params, then Cb and Cr iff SPS.sao_chroma (same syntax)."""
        planes = 3 if self.cfg.sao_chroma else 1
        for p in range(planes):
            stype = int(self.sao[0][p, cy, cxi])
            self.enc.encode_bin(self.ctxs, cx.SAO_ON, int(stype != 0))
            if stype == 0:
                continue
            is_band = stype == 5
            self.enc.encode_bin(self.ctxs, cx.SAO_KIND, int(is_band))
            if is_band:
                self.enc.encode_bypass_bits(
                    int(self.sao[1][p, cy, cxi]), 5)
            else:
                self.enc.encode_bypass_bits(stype - 1, 2)
            for i in range(4):
                off = int(self.sao[2][p, cy, cxi, i])
                mag = abs(off)
                for _ in range(mag):
                    self.enc.encode_bypass(1)
                if mag < 7:
                    self.enc.encode_bypass(0)
                if is_band and mag:
                    self.enc.encode_bypass(int(off < 0))

    def _node(self, x, y, s):
        if x >= self.w or y >= self.h:
            return
        if s > self.cfg.max_cu_size or x + s > self.w or y + s > self.h:
            half = s // 2
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                self._node(x + dx, y + dy, half)
            return
        ux, uy = x // 8, y // 8
        actual = int(self.size_map[uy, ux])
        if s > 8:
            split = actual < s
            self.enc.encode_bin(self.ctxs,
                                cx.SPLIT + (0 if s == 32 else 1),
                                int(split))
            if split:
                half = s // 2
                for (dx, dy) in ((0, 0), (half, 0), (0, half),
                                 (half, half)):
                    self._node(x + dx, y + dy, half)
                return
        assert actual == s, (x, y, s, actual)
        if self.cfg.mtt and s > 8 and not self.is_p:
            bt = (int(self.mts_map[uy, ux]) >> 4) & 3
            self.enc.encode_bin(self.ctxs,
                                cx.BT_FLAG + (0 if s == 32 else 1),
                                int(bt != 0))
            if bt:
                self.enc.encode_bin(self.ctxs, cx.BT_DIR,
                                    int(bt == 2))
                self._leaf_rect(x, y, s, bt)
                return
        self._leaf(x, y, s)

    def _leaf_rect(self, x, y, s, bt):
        """Two rectangular MTT CUs (C5): bt=1 BT-H (h=s/2, w=s,
        stacked), bt=2 BT-V (h=s, w=s/2, side by side); each codes one
        intra mode + its two square s/2 TUs in scan order."""
        t = s // 2
        for k in range(2):
            cux = x + (t * k if bt == 2 else 0)
            cuy = y + (t * k if bt == 1 else 0)
            ux, uy = cux // 8, cuy // 8
            self._code_intra_mode(ux, uy)
            for j in range(2):
                tx = cux + (t * j if bt == 1 else 0)
                ty = cuy + (t * j if bt == 2 else 0)
                self._leaf_residuals(tx, ty, t)

    def _code_intra_mode(self, ux, uy):
        """Luma mode: [mip_flag +3-bit idx (cfg.mip)] | MPM scheme."""
        mode = int(self.mode_map[uy, ux])
        if self.cfg.mip:
            is_mip = mode >= self.n_modes
            self.enc.encode_bin(self.ctxs, cx.MIP_FLAG, int(is_mip))
            if is_mip:
                self.enc.encode_bypass_bits(mode - self.n_modes, 3)
                return
        left, above = self._neighbor_modes(self.mode_map, ux, uy)
        mpms = mpm_list(left, above, self.n_modes)
        if mode in mpms:
            self.enc.encode_bin(self.ctxs, cx.MPM_FLAG, 1)
            idx = mpms.index(mode)
            self.enc.encode_bypass(int(idx == 0))
            if idx > 0:
                self.enc.encode_bypass(int(idx == 1))
        else:
            self.enc.encode_bin(self.ctxs, cx.MPM_FLAG, 0)
            rank = mode - sum(1 for m in mpms if m < mode)
            self.enc.encode_bypass_bits(rank, self.mode_bits)

    def _code_mvd(self, v, comp):
        self.enc.encode_bin(self.ctxs, cx.MVD_GT0 + comp, int(v != 0))
        if v:
            self.enc.encode_bypass(int(v < 0))
            val = abs(v) - 1
            m = 1
            while val >= (1 << m):
                self.enc.encode_bypass(1)
                val -= 1 << m
                m += 1
            self.enc.encode_bypass(0)
            self.enc.encode_bypass_bits(val, m)

    @staticmethod
    def _mvd_bits(v: int) -> int:
        """Exact bin count _code_mvd would emit for one component."""
        if v == 0:
            return 1
        val = abs(v) - 1
        m = 1
        bits = 2                      # gt0 + sign
        while val >= (1 << m):
            bits += 1
            val -= 1 << m
            m += 1
        return bits + 1 + m           # stop bit + suffix

    def _amvp_choose(self, mv, c0, c1):
        """(idx, predictor): the candidate with the cheaper MVD; ties
        resolve to 0.  idx is SIGNALLED, so any deterministic encoder
        rule is valid — the decoder just reads it."""
        if c0 == c1:
            return 0, c0
        b0 = self._mvd_bits(mv[0] - c0[0]) + self._mvd_bits(mv[1] - c0[1])
        b1 = self._mvd_bits(mv[0] - c1[0]) + self._mvd_bits(mv[1] - c1[1])
        return (1, c1) if b1 < b0 else (0, c0)

    def _leaf(self, x, y, s):
        ux, uy = x // 8, y // 8
        if self.is_p:
            kind = int(self.pred_map[uy, ux])
            self.enc.encode_bin(self.ctxs, cx.SKIP,
                                int(kind == PRED_SKIP))
            if kind == PRED_SKIP:
                if self.cfg.merge_cands:
                    # merge_idx derived by comparing the scan's FINAL
                    # MV against candidate 0 (identical rule both
                    # sides; equal candidates resolve to index 0)
                    c0 = self._mv_predictor(ux, uy)
                    mv = (int(self.mvx_map[uy, ux]),
                          int(self.mvy_map[uy, ux]))
                    self.enc.encode_bin(self.ctxs, cx.MERGE_IDX,
                                        int(mv != c0))
                return   # derived MV, no residual, nothing else coded
            self.enc.encode_bin(self.ctxs, cx.PRED_MODE,
                                int(kind == PRED_INTRA))
            if kind != PRED_INTRA:
                if self.is_b:
                    self.enc.encode_bin(self.ctxs, cx.BLIST,
                                        int(kind == PRED_BI))
                    if kind != PRED_BI:
                        self.enc.encode_bin(self.ctxs, cx.BLIST + 1,
                                            int(kind == PRED_L1))
                px, py = self._mv_predictor(ux, uy)
                mv = (int(self.mvx_map[uy, ux]),
                      int(self.mvy_map[uy, ux]))
                if self.cfg.amvp:
                    c0, c1 = (px, py), self._mv_above(ux, uy)
                    if kind != PRED_BI:
                        # merge-with-residual: MV == a candidate, no MVD
                        merge = mv == c0 or mv == c1
                        self.enc.encode_bin(self.ctxs, cx.AMVP_MERGE,
                                            int(merge))
                        if merge:
                            if c0 != c1:
                                self.enc.encode_bin(
                                    self.ctxs, cx.MERGE_IDX,
                                    int(mv != c0))
                            self._leaf_residuals(x, y, s)
                            return
                    idx, (px, py) = self._amvp_choose(mv, c0, c1)
                    if c0 != c1:
                        self.enc.encode_bin(self.ctxs, cx.AMVP_IDX,
                                            idx)
                self._code_mvd(mv[0] - px, 0)
                self._code_mvd(mv[1] - py, 1)
                if kind == PRED_BI:
                    self._code_mvd(int(self.mvx1_map[uy, ux]) - px, 0)
                    self._code_mvd(int(self.mvy1_map[uy, ux]) - py, 1)
                self._leaf_residuals(x, y, s)
                return
        self._code_intra_mode(ux, uy)
        if self.cfg.cclm and not self.is_p:
            # chroma CCLM vs DM (C6); the in-scan decision rides mts
            # bit 3 (engine.recon)
            self.enc.encode_bin(
                self.ctxs, cx.CCLM_FLAG,
                (int(self.mts_map[uy, ux]) >> 3) & 1)
        self._leaf_residuals(x, y, s)

    def _leaf_residuals(self, x, y, s):
        ux, uy = x // 8, y // 8
        # a 64-TU codes only its low 32x32 band (DCT-II zero-out,
        # C10 round-5); MTS/TS/LFNST are implicitly off at 64
        ls = 32 if s == 64 else s
        by = self.coef["y"][y:y + ls, x:x + ls]
        bcb = self.coef["cb"][y // 2:(y + s) // 2, x // 2:(x + s) // 2]
        bcr = self.coef["cr"][y // 2:(y + s) // 2, x // 2:(x + s) // 2]
        cbf_y = int(by.any())
        cbf_cb = int(bcb.any())
        cbf_cr = int(bcr.any())
        self.enc.encode_bin(self.ctxs, cx.CBF_Y + (0 if s >= 16 else 1),
                            cbf_y)
        self.enc.encode_bin(self.ctxs, cx.CBF_C + 0, cbf_cb)
        self.enc.encode_bin(self.ctxs, cx.CBF_C + 1, cbf_cr)
        mts = int(self.mts_map[uy, ux]) & 7     # bit 3 is CCLM
        if self.cfg.transform_skip and cbf_y and s < 64:
            self.enc.encode_bin(self.ctxs, cx.TS_FLAG, int(mts == 5))
        if self.cfg.mts and cbf_y and mts != 5 and s < 64:
            self.enc.encode_bin(self.ctxs, cx.MTS, int(mts > 0))
            if mts > 0:
                self.enc.encode_bypass_bits(mts - 1, 2)
        if (self.cfg.lfnst and not self.is_p and cbf_y and mts == 0
                and s < 64):
            lf = (int(self.mts_map[uy, ux]) >> 6) & 3
            self.enc.encode_bin(self.ctxs, cx.LFNST, int(lf > 0))
            if lf:
                self.enc.encode_bypass(int(lf == 2))
        if cbf_y:
            self._residual(by, ls, chroma=False)
        if cbf_cb:
            self._residual(bcb, s // 2, chroma=True)
        if cbf_cr:
            self._residual(bcr, s // 2, chroma=True)

    # -- residual ----------------------------------------------------------
    def _residual(self, block, s, chroma):
        enc, ctxs = self.enc, self.ctxs
        scan = tu_scan(s)
        n = s * s
        coefs = block[scan[:, 1], scan[:, 0]]       # in scan order
        nz = np.nonzero(coefs)[0]
        last = int(nz[-1])
        lx, ly = int(scan[last, 0]), int(scan[last, 1])
        coff = 10 if chroma else 0
        _code_last(enc, ctxs, cx.LAST_X + coff, lx, s)
        _code_last(enc, ctxs, cx.LAST_Y + coff, ly, s)

        ncg = s // 4
        last_cg = last // 16
        csbf = np.zeros(ncg * ncg, dtype=bool)
        cg_of_scan = np.arange(n) // 16
        for cg in range(last_cg + 1):
            csbf[cg] = coefs[cg * 16:min((cg + 1) * 16, last + 1)].any()
        # CG0 and the last CG have *inferred* coded flags [STD]; the
        # decoder always parses their significance bins, so the encoder
        # must emit them even when CG0 happens to be all zero.
        csbf[0] = True
        cg_list = diag_scan(ncg)
        for cg in range(last_cg, -1, -1):
            cgx, cgy = int(cg_list[cg, 0]), int(cg_list[cg, 1])
            inferred = (cg == last_cg) or (cg == 0)
            if not inferred:
                nb = _csbf_neighbor(csbf, cg_list, ncg, cgx, cgy)
                enc.encode_bin(ctxs, cx.CSBF + nb + 2 * chroma,
                               int(csbf[cg]))
            if not csbf[cg]:
                continue
            # significance
            hi = min((cg + 1) * 16 - 1, last)
            rice_k = 0
            sigs = []
            for i in range(hi, cg * 16 - 1, -1):
                level = int(coefs[i])
                sig = int(level != 0)
                if i != last:
                    px, py = int(scan[i, 0]) & 3, int(scan[i, 1]) & 3
                    ctx = _sig_ctx(px, py, cg, chroma)
                    enc.encode_bin(ctxs, ctx, sig)
                if sig:
                    sigs.append(i)
            # levels; SDH (C11): the CG's first significant sign is
            # hidden when the sig span reaches SDH_SPAN — the device
            # quantizer enforced the parity (kernels.quant.sdh_adjust)
            sdh_hide = (self.cfg.sign_data_hiding and sigs
                        and sigs[0] - sigs[-1] >= 4)
            for i in sigs:
                level = int(coefs[i])
                al = abs(level)
                g1 = int(al > 1)
                ctx1 = cx.GT1 + (2 if chroma else 0) + (0 if cg == 0 else 1)
                enc.encode_bin(ctxs, ctx1, g1)
                if g1:
                    g2 = int(al > 2)
                    enc.encode_bin(ctxs, cx.GT2 + (1 if chroma else 0), g2)
                    if g2:
                        rice_k = _code_remainder(enc, al - 3, rice_k)
                if not (sdh_hide and i == sigs[-1]):
                    enc.encode_bypass(int(level < 0))


class SyntaxDecoder(_Walker):
    def __init__(self, cfg: CodecConfig):
        super().__init__(cfg)
        u = (cfg.units_y, cfg.units_x)
        self.size_map = np.zeros(u, dtype=np.int32)
        self.mode_map = np.zeros(u, dtype=np.int32)
        self.coef = {
            "y": np.zeros((cfg.height, cfg.width), dtype=np.int32),
            "cb": np.zeros((cfg.height // 2, cfg.width // 2),
                           dtype=np.int32),
            "cr": np.zeros((cfg.height // 2, cfg.width // 2),
                           dtype=np.int32),
        }
        c = (3, cfg.ctus_y, cfg.ctus_x)
        self.sao = (np.zeros(c, np.int32), np.zeros(c, np.int32),
                    np.zeros(c + (4,), np.int32))
        self.mts_map = np.zeros(u, dtype=np.int32)
        self.is_p = False
        self.is_b = False
        self.pred_map = np.zeros(u, dtype=np.int32)
        self.mvx_map = np.zeros(u, dtype=np.int32)
        self.mvy_map = np.zeros(u, dtype=np.int32)
        self.mvx1_map = np.zeros(u, dtype=np.int32)
        self.mvy1_map = np.zeros(u, dtype=np.int32)

    def decode_segment(self, data: bytes, ctu_row0: int,
                       ctu_row1: int, init_states=None,
                       snapshot: bool = False) -> None:
        self.dec = RangeDecoder(data)
        self.ctxs = ContextSet(
            cx.NUM_CONTEXTS,
            states_init(init_states) if init_states is not None
            else ctx_init.table(self.cfg, self.is_p, self.is_b))
        self.snapshot = None
        snap_after = min(2, self.cfg.ctus_x) if snapshot else 0
        coded = 0
        for cy in range(ctu_row0, ctu_row1):
            for cxi in range(self.cfg.ctus_x):
                if self.cfg.sao:
                    self._sao_params(cy, cxi)
                self._node(cxi * 64, cy * 64, 64)
                coded += 1
                if coded == snap_after:
                    self.snapshot = flat_states(self.ctxs)

    def _sao_params(self, cy, cxi):
        planes = 3 if self.cfg.sao_chroma else 1
        for p in range(planes):
            if not self.dec.decode_bin(self.ctxs, cx.SAO_ON):
                self.sao[0][p, cy, cxi] = 0
                continue
            is_band = self.dec.decode_bin(self.ctxs, cx.SAO_KIND)
            if is_band:
                self.sao[0][p, cy, cxi] = 5
                self.sao[1][p, cy, cxi] = self.dec.decode_bypass_bits(5)
            else:
                self.sao[0][p, cy, cxi] = 1 + self.dec.decode_bypass_bits(2)
            for i in range(4):
                mag = 0
                while mag < 7 and self.dec.decode_bypass():
                    mag += 1
                if is_band:
                    neg = mag and self.dec.decode_bypass()
                    self.sao[2][p, cy, cxi, i] = -mag if neg else mag
                else:
                    # inferred signs: + for cats 1,2; - for 3,4 [STD]
                    self.sao[2][p, cy, cxi, i] = mag if i < 2 else -mag

    def _node(self, x, y, s):
        if x >= self.w or y >= self.h:
            return
        if s > self.cfg.max_cu_size or x + s > self.w or y + s > self.h:
            half = s // 2
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                self._node(x + dx, y + dy, half)
            return
        if s > 8:
            split = self.dec.decode_bin(
                self.ctxs, cx.SPLIT + (0 if s == 32 else 1))
            if split:
                half = s // 2
                for (dx, dy) in ((0, 0), (half, 0), (0, half),
                                 (half, half)):
                    self._node(x + dx, y + dy, half)
                return
        if self.cfg.mtt and s > 8 and not self.is_p:
            if self.dec.decode_bin(self.ctxs,
                                   cx.BT_FLAG + (0 if s == 32 else 1)):
                bt = 2 if self.dec.decode_bin(self.ctxs, cx.BT_DIR) \
                    else 1
                self._leaf_rect(x, y, s, bt)
                return
        self._leaf(x, y, s)

    def _leaf_rect(self, x, y, s, bt):
        """Decode mirror of SyntaxEncoder._leaf_rect."""
        t = s // 2
        us = s // 8
        ut = t // 8
        uy0, ux0 = y // 8, x // 8
        self.size_map[uy0:uy0 + us, ux0:ux0 + us] = s
        self.mts_map[uy0:uy0 + us, ux0:ux0 + us] |= bt << 4
        for k in range(2):
            cux = x + (t * k if bt == 2 else 0)
            cuy = y + (t * k if bt == 1 else 0)
            ux, uy = cux // 8, cuy // 8
            mode = self._parse_intra_mode(ux, uy)
            cu_h = ut if bt == 1 else us
            cu_w = us if bt == 1 else ut
            self.mode_map[uy:uy + cu_h, ux:ux + cu_w] = mode
            for j in range(2):
                tx = cux + (t * j if bt == 1 else 0)
                ty = cuy + (t * j if bt == 2 else 0)
                self._leaf_residuals(tx, ty, t, ut, tx // 8, ty // 8)

    def _parse_intra_mode(self, ux, uy):
        """Mirror of SyntaxEncoder._code_intra_mode."""
        if self.cfg.mip and self.dec.decode_bin(self.ctxs,
                                                cx.MIP_FLAG):
            return self.n_modes + self.dec.decode_bypass_bits(3)
        left, above = self._neighbor_modes(self.mode_map, ux, uy)
        mpms = mpm_list(left, above, self.n_modes)
        if self.dec.decode_bin(self.ctxs, cx.MPM_FLAG):
            if self.dec.decode_bypass():
                return mpms[0]
            if self.dec.decode_bypass():
                return mpms[1]
            return mpms[2]
        rank = self.dec.decode_bypass_bits(self.mode_bits)
        mode = rank
        for m in sorted(mpms):
            if mode >= m:
                mode += 1
        return mode

    def _decode_mvd(self, comp):
        if not self.dec.decode_bin(self.ctxs, cx.MVD_GT0 + comp):
            return 0
        neg = self.dec.decode_bypass()
        m = 1
        base = 1
        while self.dec.decode_bypass():
            base += 1 << m
            m += 1
            if m > 20:
                raise ValueError("corrupt mvd")
        v = base + self.dec.decode_bypass_bits(m)
        return -v if neg else v

    def _leaf(self, x, y, s):
        ux, uy = x // 8, y // 8
        u = s // 8
        if self.is_p:
            self.size_map[uy:uy + u, ux:ux + u] = s
            if self.dec.decode_bin(self.ctxs, cx.SKIP):
                px, py = self._mv_predictor(ux, uy)
                if self.cfg.merge_cands and self.dec.decode_bin(
                        self.ctxs, cx.MERGE_IDX):
                    px, py = self._mv_above(ux, uy)
                self.pred_map[uy:uy + u, ux:ux + u] = PRED_SKIP
                self.mvx_map[uy:uy + u, ux:ux + u] = px
                self.mvy_map[uy:uy + u, ux:ux + u] = py
                return
            if not self.dec.decode_bin(self.ctxs, cx.PRED_MODE):
                kind = PRED_INTER
                if self.is_b:
                    if self.dec.decode_bin(self.ctxs, cx.BLIST):
                        kind = PRED_BI
                    elif self.dec.decode_bin(self.ctxs, cx.BLIST + 1):
                        kind = PRED_L1
                px, py = self._mv_predictor(ux, uy)
                if self.cfg.amvp:
                    c0, c1 = (px, py), self._mv_above(ux, uy)
                    if kind != PRED_BI and self.dec.decode_bin(
                            self.ctxs, cx.AMVP_MERGE):
                        # merge-with-residual: MV = candidate, no MVD
                        mvx, mvy = c0
                        if c0 != c1 and self.dec.decode_bin(
                                self.ctxs, cx.MERGE_IDX):
                            mvx, mvy = c1
                        self.pred_map[uy:uy + u, ux:ux + u] = kind
                        self.mvx_map[uy:uy + u, ux:ux + u] = mvx
                        self.mvy_map[uy:uy + u, ux:ux + u] = mvy
                        self._leaf_residuals(x, y, s, u, ux, uy)
                        return
                    if c0 != c1 and self.dec.decode_bin(
                            self.ctxs, cx.AMVP_IDX):
                        px, py = c1
                mvx = px + self._decode_mvd(0)
                mvy = py + self._decode_mvd(1)
                self.pred_map[uy:uy + u, ux:ux + u] = kind
                self.mvx_map[uy:uy + u, ux:ux + u] = mvx
                self.mvy_map[uy:uy + u, ux:ux + u] = mvy
                if kind == PRED_BI:
                    m1x = px + self._decode_mvd(0)
                    m1y = py + self._decode_mvd(1)
                    self.mvx1_map[uy:uy + u, ux:ux + u] = m1x
                    self.mvy1_map[uy:uy + u, ux:ux + u] = m1y
                self._leaf_residuals(x, y, s, u, ux, uy)
                return
            # else fall through to intra coding below
        mode = self._parse_intra_mode(ux, uy)
        self.size_map[uy:uy + u, ux:ux + u] = s
        self.mode_map[uy:uy + u, ux:ux + u] = mode
        if self.cfg.cclm and not self.is_p:
            cc = self.dec.decode_bin(self.ctxs, cx.CCLM_FLAG)
            self.mts_map[uy:uy + u, ux:ux + u] |= cc << 3
        self._leaf_residuals(x, y, s, u, ux, uy)

    def _leaf_residuals(self, x, y, s, u, ux, uy):
        cbf_y = self.dec.decode_bin(self.ctxs,
                                    cx.CBF_Y + (0 if s >= 16 else 1))
        cbf_cb = self.dec.decode_bin(self.ctxs, cx.CBF_C + 0)
        cbf_cr = self.dec.decode_bin(self.ctxs, cx.CBF_C + 1)
        ls = 32 if s == 64 else s    # 64-TU: low-band coding, no
        mts = 0                      # MTS/TS/LFNST flags (zero-out)
        if (self.cfg.mts or self.cfg.transform_skip) and cbf_y \
                and s < 64:
            ts = (self.cfg.transform_skip
                  and self.dec.decode_bin(self.ctxs, cx.TS_FLAG))
            if ts:
                mts = 5
            elif self.cfg.mts:
                if self.dec.decode_bin(self.ctxs, cx.MTS):
                    mts = 1 + self.dec.decode_bypass_bits(2)
            self.mts_map[uy:uy + u, ux:ux + u] |= mts
        if (self.cfg.lfnst and not self.is_p and cbf_y and mts == 0
                and s < 64):
            if self.dec.decode_bin(self.ctxs, cx.LFNST):
                lf = 2 if self.dec.decode_bypass() else 1
                self.mts_map[uy:uy + u, ux:ux + u] |= lf << 6
        if cbf_y:
            self.coef["y"][y:y + ls, x:x + ls] = self._residual(
                ls, False)
        if cbf_cb:
            self.coef["cb"][y // 2:(y + s) // 2,
                            x // 2:(x + s) // 2] = self._residual(
                                s // 2, True)
        if cbf_cr:
            self.coef["cr"][y // 2:(y + s) // 2,
                            x // 2:(x + s) // 2] = self._residual(
                                s // 2, True)

    def _residual(self, s, chroma):
        dec, ctxs = self.dec, self.ctxs
        scan = tu_scan(s)
        n = s * s
        coefs = np.zeros(n, dtype=np.int32)
        coff = 10 if chroma else 0
        lx = _decode_last(dec, ctxs, cx.LAST_X + coff, s)
        ly = _decode_last(dec, ctxs, cx.LAST_Y + coff, s)
        pos_of = {(int(scan[i, 0]), int(scan[i, 1])): i for i in range(n)}
        last = pos_of[(lx, ly)]

        ncg = s // 4
        last_cg = last // 16
        csbf = np.zeros(ncg * ncg, dtype=bool)
        cg_list = diag_scan(ncg)
        for cg in range(last_cg, -1, -1):
            cgx, cgy = int(cg_list[cg, 0]), int(cg_list[cg, 1])
            if (cg == last_cg) or (cg == 0):
                csbf[cg] = True
            else:
                nb = _csbf_neighbor(csbf, cg_list, ncg, cgx, cgy)
                csbf[cg] = bool(dec.decode_bin(
                    ctxs, cx.CSBF + nb + 2 * chroma))
            if not csbf[cg]:
                continue
            hi = min((cg + 1) * 16 - 1, last)
            rice_k = 0
            sigs = []
            for i in range(hi, cg * 16 - 1, -1):
                if i == last:
                    sig = 1
                else:
                    px, py = int(scan[i, 0]) & 3, int(scan[i, 1]) & 3
                    sig = dec.decode_bin(ctxs, _sig_ctx(px, py, cg, chroma))
                if sig:
                    sigs.append(i)
            sdh_hide = (self.cfg.sign_data_hiding and sigs
                        and sigs[0] - sigs[-1] >= 4)
            for i in sigs:
                ctx1 = cx.GT1 + (2 if chroma else 0) + (0 if cg == 0 else 1)
                al = 1
                if dec.decode_bin(ctxs, ctx1):
                    al = 2
                    if dec.decode_bin(ctxs, cx.GT2 + (1 if chroma else 0)):
                        rem, rice_k = _decode_remainder(dec, rice_k)
                        al = 3 + rem
                if sdh_hide and i == sigs[-1]:
                    # SDH: sign from the CG's abs-level-sum parity
                    par = int(np.sum(np.abs(coefs[cg * 16:hi + 1]))
                              + al) & 1
                    coefs[i] = -al if par else al
                else:
                    if dec.decode_bypass():
                        al = -al
                    coefs[i] = al
        out = np.zeros((s, s), dtype=np.int32)
        out[scan[:, 1], scan[:, 0]] = coefs
        return out


# -- shared helpers ---------------------------------------------------------

def _sig_ctx(px: int, py: int, cg: int, chroma: bool) -> int:
    d = min(px + py, 5)
    if chroma:
        return cx.SIG + 12 + d
    return cx.SIG + d + (0 if cg == 0 else 6)


def _csbf_neighbor(csbf, cg_list, ncg, cgx, cgy) -> int:
    """1 if the right or below CG (already coded in reverse scan) has
    csbf set."""
    idx = {(int(cg_list[i, 0]), int(cg_list[i, 1])): i
           for i in range(len(cg_list))}
    nb = 0
    if cgx + 1 < ncg and csbf[idx[(cgx + 1, cgy)]]:
        nb = 1
    if cgy + 1 < ncg and csbf[idx[(cgx, cgy + 1)]]:
        nb = 1
    return nb


def _code_last(enc, ctxs, base, v, size):
    g = cx.group_idx(v)
    gmax = cx.max_group(size)
    for b in range(g):
        enc.encode_bin(ctxs, base + min(b, 9), 1)
    if g < gmax:
        enc.encode_bin(ctxs, base + min(g, 9), 0)
    nbits = cx.group_suffix_bits(g)
    if nbits:
        enc.encode_bypass_bits(v - cx.MIN_IN_GROUP[g], nbits)


def _decode_last(dec, ctxs, base, size):
    gmax = cx.max_group(size)
    g = 0
    while g < gmax and dec.decode_bin(ctxs, base + min(g, 9)):
        g += 1
    v = cx.MIN_IN_GROUP[g]
    nbits = cx.group_suffix_bits(g)
    if nbits:
        v += dec.decode_bypass_bits(nbits)
    return v


def _code_remainder(enc, r, k) -> int:
    """Golomb-Rice with exp-golomb escape; returns updated rice param."""
    q = r >> k
    if q < 4:
        for _ in range(q):
            enc.encode_bypass(1)
        enc.encode_bypass(0)
        if k:
            enc.encode_bypass_bits(r & ((1 << k) - 1), k)
    else:
        for _ in range(4):
            enc.encode_bypass(1)
        v = r - (4 << k)
        m = k + 1
        while v >= (1 << m):
            enc.encode_bypass(1)
            v -= 1 << m
            m += 1
        enc.encode_bypass(0)
        enc.encode_bypass_bits(v, m)
    if r > (3 << k) and k < 4:
        k += 1
    return k


def _decode_remainder(dec, k) -> tuple[int, int]:
    q = 0
    while q < 4 and dec.decode_bypass():
        q += 1
    if q < 4:
        r = q << k
        if k:
            r += dec.decode_bypass_bits(k)
    else:
        m = k + 1
        base = 4 << k
        while dec.decode_bypass():
            base += 1 << m
            m += 1
            if m > 24:   # corrupt stream guard: levels are < 2^16
                raise ValueError("corrupt coefficient remainder")
        r = base + dec.decode_bypass_bits(m)
    if r > (3 << k) and k < 4:
        k += 1
    return r, k
