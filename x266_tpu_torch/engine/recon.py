"""Pass B: the normative reconstruction scan (C6/C10/C11/C12, decode
C18) -- the plain PyTorch version of kernels K1/K2.

Counterpart of x266_tpu/engine/recon.py:43-87 (``cclm_pred``) and
125-541 (the intra branches): a loop over CTUs in raster order and 8x8
units in z-order; at each TU origin predict -> [transform -> quantize] ->
dequantize -> inverse -> clip, written back into the padded plane that
later TUs read their references from.  The intra tools: PDPC on luma
TUs, MIP modes (a chroma TU of a MIP CU predicts planar), transform skip
on luma TUs whose mts_map value is TS_IDX (coefficients = residual <<
transform_shift, inverse (dequantized + round) >> transform_shift), and
lossless coding (levels = source - prediction, recon = source; decode
clip(prediction + levels)); on every plane and TU branch, dependent
quantization (the trellis and the state-dependent dequantizer) and
sign-data hiding (the parity move after the quantizer).  MTT: a BT leaf
(bits 4-5 of the mts map) codes as two rectangular CUs of one mode each,
each tiled as two square TUs of half the leaf's side, coded in turn
(BT-V: the left CU's two, top to bottom, then the right CU's), each
with the mts value at its own origin; LFNST (bits 6-7, on luma TUs of
the DCT-II pair) sits between the primary transform and the quantizer
and between the dequantizer and the primary inverse.  CCLM (I
pictures, square CUs): each CU's chroma TUs predict either by the chroma
mode (DM) or by the linear model of cclm_pred from the CU's luma, just
reconstructed; the encoder takes CCLM where its joint Cb + Cr SSE
against the source is strictly below DM's and returns the mts map with
that choice in bit 3 of every unit of the CU (over the map's bits 0-2,
as the reference's seventh output), the decoder reads bit 3.  Planes start
at mid-gray and are written in coding order, so a reference to a sample
not yet coded reads mid-gray; with cfg.ref_substitute the decode-order
availability masks (engine.availability) drive the substitution fill
instead.

This is the oracle the CUDA kernel (engine.recon_cuda) is held against
and the path CPU tensors take (``recon_pass``).  Control flow reads the
maps on the host; the math runs on whatever device the planes are on.
"""

from __future__ import annotations

import numpy as np
import torch

from x266_tpu_torch.config import CodecConfig
from x266_tpu_torch.engine import availability as avail

from x266_tpu_torch.engine import recon_cuda
from x266_tpu_torch.engine.availability import ref_masks
from x266_tpu_torch.engine.mode_decision import PAD, TS_IDX, _check_cfg
from x266_tpu_torch.kernels import intra as kintra
from x266_tpu_torch.kernels import lfnst as klfnst
from x266_tpu_torch.kernels import quant as kquant
from x266_tpu_torch.kernels import transforms as ktx
from x266_tpu_torch.specmodel.quant import transform_shift
from x266_tpu_torch.tables import MTS_COMBOS, Tables


def _gather_ref(plane: torch.Tensor, x: int, y: int, s: int):
    return torch.cat([plane[y, x:x + 2 * s + 1],
                      plane[y + 1:y + 1 + 2 * s, x]])


def _subst_tables(cfg: CodecConfig, device: torch.device):
    """{s: (gy, gx, 4s+1) bool} luma and {s/2: ...} chroma masks, and
    under MTT the BT-V-order masks of the leaves' t-TUs, luma {t: ...}
    and chroma {t/2: ...} (x266_tpu/engine/recon.py:278-295)."""
    if not cfg.ref_substitute:
        return None, None, None, None
    w, h = cfg.width, cfg.height
    sizes = [s for s in (8, 16, 32) if s <= cfg.max_cu_size]

    def dev(m):
        return torch.from_numpy(np.ascontiguousarray(m)).to(device)

    lum = {s: dev(ref_masks(w, h, s)) for s in sizes}
    chro = {s // 2: dev(ref_masks(w, h, s // 2, scale=2))
            for s in sizes}
    lum_v = chro_v = None
    if cfg.mtt:
        leaves = [s for s in (16, 32) if s <= cfg.max_cu_size]
        lum_v = {s // 2: dev(ref_masks(w, h, s // 2, btv_leaf=s))
                 for s in leaves}
        chro_v = {s // 4: dev(ref_masks(w, h, s // 4, scale=2,
                                        btv_leaf=s // 2))
                  for s in leaves}
    return lum, chro, lum_v, chro_v


def _ds2(lum: torch.Tensor) -> torch.Tensor:
    """The 2x2 means of a luma block, rounded: (2n, 2m) -> (n, m)."""
    return (lum[0::2, 0::2] + lum[1::2, 0::2] + lum[0::2, 1::2]
            + lum[1::2, 1::2] + 2) >> 2


def cclm_pred(yP: torch.Tensor, cP: torch.Tensor, xc: int, yc: int,
              cs: int, maxv: int) -> torch.Tensor:
    """CCLM's chroma prediction (cs, cs) int32 of the chroma TU at (xc,
    yc), side cs (x266_tpu/engine/recon.py:43-87).  yP: the padded luma
    recon with this CU's luma written; cP: the padded chroma recon.  The
    CU's luma downsampled 2x2; four boundary pairs, two above at 1/4 and
    3/4 of the width and two to the left at the same fractions, each the
    2x2 mean of the luma two rows above (two columns left) and the
    chroma sample one row above (one column left); alpha =
    clip(((cmax - cmin) << 6) // max(lmax - lmin, 1), -512, 511) from the
    pairs of least and greatest luma (the first on ties; // floors), beta
    = cmin - ((alpha * lmin + 32) >> 6), prediction clip(((alpha * ds +
    32) >> 6) + beta, 0, maxv).  At the picture's top row (left column)
    the luma pair's start is -1, which the reference's dynamic_slice
    counts from the end of the axis and then clamps into it: the pair is
    the plane's last two rows (columns), the bottom (right) padding,
    mid-gray in the scan."""
    ds = _ds2(yP[2 * yc + 1:2 * yc + 1 + 2 * cs,
                 2 * xc + 1:2 * xc + 1 + 2 * cs])

    def start(i, n):
        return min(i + n if i < 0 else i, n - 2)

    def l_ds_at(py, px):
        r, c = start(py + 1, yP.shape[0]), start(px + 1, yP.shape[1])
        return _ds2(yP[r:r + 2, c:c + 2])[0, 0]

    d0, d1 = cs // 4, (3 * cs) // 4
    cands_c = torch.stack([cP[yc, xc + 1 + d0], cP[yc, xc + 1 + d1],
                           cP[yc + 1 + d0, xc], cP[yc + 1 + d1, xc]])
    cands_l = torch.stack([l_ds_at(2 * yc - 2, 2 * (xc + d0)),
                           l_ds_at(2 * yc - 2, 2 * (xc + d1)),
                           l_ds_at(2 * (yc + d0), 2 * xc - 2),
                           l_ds_at(2 * (yc + d1), 2 * xc - 2)])
    imin, imax = torch.argmin(cands_l), torch.argmax(cands_l)
    lmin, lmax = cands_l[imin], cands_l[imax]
    cmin, cmax = cands_c[imin], cands_c[imax]
    alpha = torch.div((cmax - cmin) * 64, (lmax - lmin).clamp(min=1),
                      rounding_mode="floor").clamp(-512, 511)
    beta = cmin - ((alpha * lmin + 32) >> 6)
    return (((alpha * ds + 32) >> 6) + beta).clamp(0, maxv)


def _intra_pred(tab, cfg, plane, x, y, mode, s, mask, luma):
    """An intra TU's prediction (s, s) int32 from its substituted (mask)
    references; PDPC blends luma TUs only (its gates: the TU's plane x >
    0 and y > 0)."""
    ref = _gather_ref(plane, x, y, s)
    if mask is not None:
        ref = kintra.substitute_refs(ref, mask, cfg.mid_val)
    return kintra.predict_mode(tab, ref, mode, s, pdpc=cfg.pdpc and luma,
                               left_ok=x > 0, top_ok=y > 0)


def _tu(tab, cfg, plane, src, coef, x, y, mode, s, mts_idx, encode,
        mask, rdoq_lam, luma, lfnst_idx=0):
    """One intra TU: (recon (s, s), levels (s, s)) int32."""
    pred = _intra_pred(tab, cfg, plane, x, y, mode, s, mask, luma)
    return residual_path(tab, cfg, pred, src, coef, x, y, s, mts_idx,
                         encode, rdoq_lam,
                         lfnst=(lfnst_idx, mode) if lfnst_idx else None)


def residual_path(tab, cfg, pred, src, coef, x, y, s, mts_idx, encode,
                  rdoq_lam, skip=False, lfnst=None):
    """A TU's residual around its prediction pred (s, s) int32: encode
    transforms (or with mts_idx TS_IDX shifts) and quantizes the source
    minus pred (zero levels when skip), decode reads the levels; both
    dequantize, inverse-transform (or shift back) and clip.  Lossless:
    the levels are the residual and the recon is the source (a skip CU:
    zero levels and the clipped prediction).  Under cfg.dep_quant the
    quantizer is the trellis (at the RDOQ lambda, else default_lam) and the
    dequantizer the state-dependent one; under cfg.sign_data_hiding the
    levels then get their parity moves (x266_tpu/engine/recon.py:90-178).
    lfnst: (lfnst_idx > 0, the CU's mode) of a luma TU on the DCT-II
    pair: LFNST forward between the primary transform and the quantizer,
    inverse between the dequantizer and the primary inverse.  Returns
    (recon (s, s), levels (s, s)) int32."""
    bd, qp = cfg.bit_depth, cfg.qp
    if cfg.lossless:
        if encode and skip:
            return (pred.clamp(0, cfg.max_val),
                    torch.zeros((s, s), dtype=torch.int32, device=pred.device))
        if encode:
            orig = src[y + 1:y + 1 + s, x + 1:x + 1 + s]
            return orig, orig - pred
        lev = coef[y:y + s, x:x + s]
        return (pred + lev).clamp(0, cfg.max_val), lev
    ts = mts_idx == TS_IDX
    tv, th = MTS_COMBOS[0 if ts else mts_idx]
    tsh = transform_shift(s, bd)
    if ts or mts_idx:
        lfnst = None
    if encode and skip:
        lev = torch.zeros((s, s), dtype=torch.int32, device=pred.device)
    elif encode:
        res = src[y + 1:y + 1 + s, x + 1:x + 1 + s] - pred
        c = (res[None] << tsh if ts
             else ktx.forward_transform(tab, res[None], s, tv, th, bd))
        if lfnst is not None:
            c = klfnst.lfnst_fwd(c, [lfnst[1]], [lfnst[0]], cfg.n_pred_modes)
        if cfg.dep_quant:
            lev = kquant.dq_quantize_trellis(
                tab, c, qp, s,
                rdoq_lam if rdoq_lam else kquant.default_lam(qp), bd)[0]
        elif rdoq_lam is not None:
            lev = kquant.rd_quantize(tab, c, qp, s, rdoq_lam, bd)[0]
        else:
            lev = kquant.quantize(tab, c, qp, s, bd)[0]
        if cfg.sign_data_hiding:
            lev = kquant.sdh_adjust(tab, lev, s, coef=c[0], qp=qp,
                                    bit_depth=bd,
                                    lam=rdoq_lam if rdoq_lam else None)
    else:
        lev = coef[y:y + s, x:x + s]
    deq = kquant.dq_dequantize if cfg.dep_quant else kquant.dequantize
    d = deq(tab, lev[None], qp, s, bd)
    if lfnst is not None:
        d = klfnst.lfnst_inv(d, [lfnst[1]], [lfnst[0]], cfg.n_pred_modes)
    if ts:
        rres = (d[0] + (1 << (tsh - 1))) >> tsh
    else:
        rres = ktx.inverse_transform(tab, d, s, tv, th, bd)[0]
    return (pred + rres).clamp(0, cfg.max_val), lev


def _scan_frame(cfg, tab, encode, a, b, c, size_map, mode_map, mts_map,
                masks, inter=None):
    """One frame of the scan.  a, b, c: padded sources (encode) or
    coefficient planes (decode) as int32; maps as host numpy.

    inter: a P picture's per-CU predictor (engine.inter.InterScan):
    ``inter.predict(ux, uy, s)`` is called once per CU in coding order;
    it returns None for an intra CU, else the CU's (luma, Cb, Cr) MC
    predictions and its skip flag.  Its final MV planes are appended to
    the outputs.  An I picture's encode under cfg.cclm appends the mts map
    with the CCLM choices in bit 3 (int32, H/8 x W/8)."""
    w, h = cfg.width, cfg.height
    cw, ch = w // 2, h // 2
    dev = a.device
    mid = cfg.mid_val
    lum_masks, chro_masks, lum_v, chro_v = masks
    rdoq_lam = cfg.lambda_mode if (cfg.rdoq and encode) else None
    yP = torch.full((1 + h + PAD, 1 + w + PAD), mid, dtype=torch.int32,
                    device=dev)
    cbP = torch.full((1 + ch + PAD, 1 + cw + PAD), mid, dtype=torch.int32,
                     device=dev)
    crP = cbP.clone()
    if encode:
        src = (a, b, c)
        coefs = [torch.zeros((h, w), dtype=torch.int32, device=dev),
                 torch.zeros((ch, cw), dtype=torch.int32, device=dev),
                 torch.zeros((ch, cw), dtype=torch.int32, device=dev)]
    else:
        src = (None, None, None)
        coefs = [a, b, c]
    # CCLM rides I pictures only (the reference's inter scan has none)
    cclm = cfg.cclm and inter is None
    mmap = (torch.from_numpy(np.array(mts_map, dtype=np.int32))
            if cclm and encode else None)
    for cy in range(cfg.ctus_y):
        for cx in range(cfg.ctus_x):
            for z in range(64):
                zx, zy = avail.z_deinterleave(z)
                ux, uy = cx * 8 + zx, cy * 8 + zy
                if ux >= cfg.units_x or uy >= cfg.units_y:
                    continue
                s = int(size_map[uy, ux])
                u = s // 8
                # MTT: bits 4-5 of the mts map, 1 BT-H / 2 BT-V; a BT leaf
                # codes as two rectangular CUs, here at their origins
                bt = (int(mts_map[uy, ux]) >> 4) & 3 if cfg.mtt else 0
                if ux & ((u >> (bt == 2)) - 1) or uy & ((u >> (bt == 1)) - 1):
                    continue
                mode = int(mode_map[uy, ux])
                # chroma of a MIP CU predicts planar (the MIP matrices
                # are luma-trained)
                mode_c = 0 if mode >= cfg.n_intra_modes else mode
                mcp = inter.predict(ux, uy, s) if inter is not None else None
                x, y = ux * 8, uy * 8
                if bt == 0:
                    tus = [(x, y, s)]
                else:
                    # the rect CU's two t-TUs, coded in turn
                    # (x266_tpu/engine/recon.py:393-458)
                    t = s // 2
                    tus = [(x, y, t), (x, y + t, t) if bt == 2
                           else (x + t, y, t)]
                for xt, yt, st in tus:
                    mval = int(mts_map[yt // 8, xt // 8])
                    mts_idx = _transform_index(cfg, mval)
                    lf = (mval >> 6) & 3 if cfg.lfnst else 0
                    xc, yc, cs = xt // 2, yt // 2, st // 2
                    planes = ((yP, 0, xt, yt, st, mts_idx, mode),
                              (cbP, 1, xc, yc, cs, 0, mode_c),
                              (crP, 2, xc, yc, cs, 0, mode_c))
                    cpred = None
                    for plane, k, px, py, ps, m, pm in planes:
                        if cclm and k == 1:
                            cpred = _cclm_choice(tab, cfg, encode, yP, cbP,
                                                 crP, src, xc, yc, cs,
                                                 mode_c, chro_masks,
                                                 int(mts_map[uy, ux]))
                            if mmap is not None:
                                # the reference's dynamic_update_slice keeps
                                # the CU's block inside the map
                                y0 = min(uy, cfg.units_y - u)
                                x0 = min(ux, cfg.units_x - u)
                                mmap[y0:y0 + u, x0:x0 + u] = cpred[2]
                        if mcp is not None:
                            rec, lev = residual_path(
                                tab, cfg, mcp[0][k], src[k], coefs[k], px,
                                py, ps, m, encode, rdoq_lam, skip=mcp[1])
                        elif cpred is not None:
                            rec, lev = residual_path(
                                tab, cfg, cpred[k - 1], src[k], coefs[k], px,
                                py, ps, m, encode, rdoq_lam)
                        else:
                            lm = ((lum_v if bt == 2 else lum_masks) if k == 0
                                  else (chro_v if bt == 2 else chro_masks))
                            msk = (lm[ps][py // ps, px // ps]
                                   if lm is not None else None)
                            rec, lev = _tu(tab, cfg, plane, src[k], coefs[k],
                                           px, py, pm, ps, m, encode, msk,
                                           rdoq_lam, k == 0,
                                           lf if k == 0 else 0)
                        plane[py + 1:py + 1 + ps, px + 1:px + 1 + ps] = rec
                        coefs[k][py:py + ps, px:px + ps] = lev
    out = (yP[1:1 + h, 1:1 + w].to(torch.uint8),
           cbP[1:1 + ch, 1:1 + cw].to(torch.uint8),
           crP[1:1 + ch, 1:1 + cw].to(torch.uint8),
           *(cf.to(torch.int16) for cf in coefs))
    if inter is not None:
        out = out + inter.final_mvs()
    if mmap is not None:
        out = out + (mmap.to(dev),)
    return out


def _cclm_choice(tab, cfg, encode, yP, cbP, crP, src, xc, yc, cs, mode_c,
                 chro_masks, mval):
    """A square CU's chroma predictions under CCLM, (Cb, Cr), and its mts
    value out (x266_tpu/engine/recon.py:332-391): the linear model's or
    DM's (the chroma mode, substituted under cfg.ref_substitute), by the
    encoder's joint SSE against the source (CCLM where strictly below)
    or the decoder's bit 3 of the CU's mts value mval; the value out is
    (mval & 7) | choice << 3."""
    cc = [cclm_pred(yP, p, xc, yc, cs, cfg.max_val) for p in (cbP, crP)]
    msk = (chro_masks[cs][yc // cs, xc // cs]
           if chro_masks is not None else None)
    dm = [_intra_pred(tab, cfg, p, xc, yc, mode_c, cs, msk, False)
          for p in (cbP, crP)]
    if encode:
        def sse(preds):
            return sum(int(((q - o[yc + 1:yc + 1 + cs,
                                  xc + 1:xc + 1 + cs]) ** 2).sum())
                       for q, o in zip(preds, src[1:]))

        use_cc = sse(cc) < sse(dm)
    else:
        use_cc = (mval >> 3) & 1 == 1
    return (*(cc if use_cc else dm), (mval & 7) | (int(use_cc) << 3))


def _transform_index(cfg: CodecConfig, v: int) -> int:
    """A luma TU's mts_map value -> its MTS_COMBOS index, or TS_IDX for
    transform skip; the map is read when cfg.mts or
    cfg.transform_skip, as in the reference's _fwd_mts/_inv_mts."""
    v &= 7
    if cfg.transform_skip and v == TS_IDX:
        return TS_IDX
    return min(v, len(MTS_COMBOS) - 1) if cfg.mts else 0


def check_slice(cfg: CodecConfig) -> None:
    """Raise for configurations outside the port's slices."""
    _check_cfg(cfg)
    if cfg.bit_depth != 8:
        raise NotImplementedError("the port's slices are 8-bit")


def make_recon_pass_raw(cfg: CodecConfig, tab: Tables, encode: bool):
    """The plain scan over a batch of frames.

    encode=True:  f(origY_pad, origCb_pad, origCr_pad,
                    size_map, mode_map, mts_map)
    encode=False: f(coefY, coefCb, coefCr, size_map, mode_map, mts_map)
    Inputs carry a leading frame dim: padded planes (F, 1+H+PAD,
    1+W+PAD), coefficient planes (F, H, W) / (F, H/2, W/2), maps
    (F, H/8, W/8).  Returns (reconY, reconCb, reconCr) uint8 and
    (coefY, coefCb, coefCr) int16, each with the frame dim, and under
    cfg.cclm (encode) the mts map with the CCLM choices in bit 3 (F, H/8,
    W/8) int32, the reference's seventh output.
    """
    check_slice(cfg)
    masks = {}                          # device -> availability masks

    def run(a, b, c, size_map, mode_map, mts_map):
        if a.device not in masks:
            masks[a.device] = _subst_tables(cfg, a.device)
        maps = [m.cpu().numpy() for m in (size_map, mode_map, mts_map)]
        outs = [_scan_frame(cfg, tab, encode, a[f].to(torch.int32),
                            b[f].to(torch.int32), c[f].to(torch.int32),
                            maps[0][f], maps[1][f], maps[2][f],
                            masks[a.device])
                for f in range(a.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))

    return run


def recon_pass(cfg: CodecConfig, tab: Tables, encode: bool):
    """Pass B for a batch of frames: CPU tensors take the plain scan,
    CUDA tensors the hand-written kernel (K1 encode / K2 decode) and
    nothing else."""
    plain = make_recon_pass_raw(cfg, tab, encode)

    def run(a, b, c, size_map, mode_map, mts_map):
        if a.device.type == "cuda":
            return recon_cuda.recon_intra(cfg, tab, encode, a, b, c,
                                          size_map, mode_map, mts_map)
        if a.device.type != "cpu":
            raise ValueError(f"unsupported device {a.device}")
        return plain(a, b, c, size_map, mode_map, mts_map)

    return run
