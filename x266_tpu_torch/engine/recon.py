"""Pass B: the normative reconstruction scan (C6/C10/C11/C12, decode
C18) -- the plain PyTorch version of kernels K1/K2.

Counterpart of x266_tpu/engine/recon.py:125-541 (intra branches, no
CCLM/MTT/LFNST): a loop over CTUs in raster order and 8x8 units
in z-order; at each TU origin predict -> [transform -> quantize] ->
dequantize -> inverse -> clip, written back into the padded plane that
later TUs read their references from.  The intra tools: PDPC on luma
TUs, MIP modes (a chroma TU of a MIP CU predicts planar), transform skip
on luma TUs whose mts_map value is TS_IDX (coefficients = residual <<
transform_shift, inverse (dequantized + round) >> transform_shift), and
lossless coding (levels = source - prediction, recon = source; decode
clip(prediction + levels)); on every plane and TU branch, dependent
quantization (the trellis and the state-dependent dequantizer) and
sign-data hiding (the parity move after the quantizer).  Planes start
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
from x266_tpu_torch.kernels import quant as kquant
from x266_tpu_torch.kernels import transforms as ktx
from x266_tpu_torch.specmodel.quant import transform_shift
from x266_tpu_torch.tables import MTS_COMBOS, Tables


def _gather_ref(plane: torch.Tensor, x: int, y: int, s: int):
    return torch.cat([plane[y, x:x + 2 * s + 1],
                      plane[y + 1:y + 1 + 2 * s, x]])


def _subst_tables(cfg: CodecConfig, device: torch.device):
    """{s: (gy, gx, 4s+1) bool} luma and {s/2: ...} chroma masks."""
    if not cfg.ref_substitute:
        return None, None
    w, h = cfg.width, cfg.height
    sizes = [s for s in (8, 16, 32) if s <= cfg.max_cu_size]

    def dev(m):
        return torch.from_numpy(np.ascontiguousarray(m)).to(device)

    lum = {s: dev(ref_masks(w, h, s)) for s in sizes}
    chro = {s // 2: dev(ref_masks(w, h, s // 2, scale=2))
            for s in sizes}
    return lum, chro


def _tu(tab, cfg, plane, src, coef, x, y, mode, s, mts_idx, encode,
        mask, rdoq_lam, luma):
    """One intra TU: (recon (s, s), levels (s, s)) int32.  PDPC blends
    luma TUs only (its gates: the TU's plane x > 0 and y > 0)."""
    ref = _gather_ref(plane, x, y, s)
    if mask is not None:
        ref = kintra.substitute_refs(ref, mask, cfg.mid_val)
    pred = kintra.predict_mode(tab, ref, mode, s, pdpc=cfg.pdpc and luma,
                               left_ok=x > 0, top_ok=y > 0)
    return residual_path(tab, cfg, pred, src, coef, x, y, s, mts_idx,
                         encode, rdoq_lam)


def residual_path(tab, cfg, pred, src, coef, x, y, s, mts_idx, encode,
                  rdoq_lam, skip=False):
    """A TU's residual around its prediction pred (s, s) int32: encode
    transforms (or with mts_idx TS_IDX shifts) and quantizes the source
    minus pred (zero levels when skip), decode reads the levels; both
    dequantize, inverse-transform (or shift back) and clip.  Lossless:
    the levels are the residual and the recon is the source (a skip CU:
    zero levels and the clipped prediction).  Under cfg.dep_quant the
    quantizer is the trellis (at the RDOQ lambda, else default_lam) and the
    dequantizer the state-dependent one; under cfg.sign_data_hiding the
    levels then get their parity moves (x266_tpu/engine/recon.py:90-178).
    Returns (recon (s, s), levels (s, s)) int32."""
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
    if encode and skip:
        lev = torch.zeros((s, s), dtype=torch.int32, device=pred.device)
    elif encode:
        res = src[y + 1:y + 1 + s, x + 1:x + 1 + s] - pred
        c = (res[None] << tsh if ts
             else ktx.forward_transform(tab, res[None], s, tv, th, bd))
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
    the outputs."""
    w, h = cfg.width, cfg.height
    cw, ch = w // 2, h // 2
    dev = a.device
    mid = cfg.mid_val
    lum_masks, chro_masks = masks
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
    for cy in range(cfg.ctus_y):
        for cx in range(cfg.ctus_x):
            for z in range(64):
                zx, zy = avail.z_deinterleave(z)
                ux, uy = cx * 8 + zx, cy * 8 + zy
                if ux >= cfg.units_x or uy >= cfg.units_y:
                    continue
                s = int(size_map[uy, ux])
                u = s // 8
                if ux & (u - 1) or uy & (u - 1):
                    continue
                mode = int(mode_map[uy, ux])
                # chroma of a MIP CU predicts planar (the MIP matrices
                # are luma-trained)
                mode_c = 0 if mode >= cfg.n_intra_modes else mode
                mts_idx = _transform_index(cfg, int(mts_map[uy, ux]))
                x, y = ux * 8, uy * 8
                xc, yc, cs = x // 2, y // 2, s // 2
                mcp = inter.predict(ux, uy, s) if inter is not None else None
                planes = ((yP, 0, x, y, s, mts_idx, mode),
                          (cbP, 1, xc, yc, cs, 0, mode_c),
                          (crP, 2, xc, yc, cs, 0, mode_c))
                for plane, k, px, py, ps, m, pm in planes:
                    if mcp is not None:
                        rec, lev = residual_path(
                            tab, cfg, mcp[0][k], src[k], coefs[k], px, py,
                            ps, m, encode, rdoq_lam, skip=mcp[1])
                    else:
                        lm = lum_masks if k == 0 else chro_masks
                        msk = (lm[ps][py // ps, px // ps]
                               if lm is not None else None)
                        rec, lev = _tu(tab, cfg, plane, src[k], coefs[k],
                                       px, py, pm, ps, m, encode, msk,
                                       rdoq_lam, k == 0)
                    plane[py + 1:py + 1 + ps, px + 1:px + 1 + ps] = rec
                    coefs[k][py:py + ps, px:px + ps] = lev
    out = (yP[1:1 + h, 1:1 + w].to(torch.uint8),
           cbP[1:1 + ch, 1:1 + cw].to(torch.uint8),
           crP[1:1 + ch, 1:1 + cw].to(torch.uint8),
           *(cf.to(torch.int16) for cf in coefs))
    if inter is not None:
        out = out + inter.final_mvs()
    return out


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
    (coefY, coefCb, coefCr) int16, each with the frame dim.
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
