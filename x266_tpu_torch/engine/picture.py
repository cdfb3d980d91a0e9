"""Per-picture encode/decode orchestration for single-tile I, P and B
pictures: the device step, host entropy coding and slice assembly.

Counterpart of x266_tpu/engine/picture.py (tile_compute_async :50-83,
tiles_compute_batched_async :114-160, code_segments :163-201,
tile_entropy :204-208, assemble_slice :247-312, _parse_segments
:332-365, _alf_maps_from_header :368-412, encode_picture_gop_async
:563-616, b_qp_offset, gop_coding_order, encode_picture_b_async and
decode_picture_b :633-761, decode_picture_gop :764-795, which here
decodes every I picture too), with SAO, ALF and weighted prediction
(the slice header's weights; the references' pyramids reweighted by
fused.apply_wp before the step, on encode and decode).  The entropy
coder is the reference's own, carried in
x266_tpu_torch.cabac (the native C++ range coder, or its Python mirror
where no C++ toolchain exists), so equal maps and levels give equal
bytes.

Dispatch is asynchronous: the device step of a chunk of frames (or of
one P or B picture) is queued and ``finalize()`` does the ``.cpu()``
copies, so the kernels of later pictures run while the host
entropy-codes earlier ones.  An inter picture's only dependencies are
its references' pyramids, which stay on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from x266_tpu_torch.cabac import native_bind
from x266_tpu_torch.cabac.contexts import NUM_CONTEXTS
from x266_tpu_torch.cabac.syntax import SyntaxDecoder, SyntaxEncoder
from x266_tpu_torch.config import CodecConfig, SliceType
from x266_tpu_torch.core.headers import SliceHeader, write_slice_header
from x266_tpu_torch.core.yuv import Frame
from x266_tpu_torch.engine.fused import (IDENTITY_WP, apply_wp,
                                         build_pyramids_device,
                                         decode_filters, has_filters,
                                         tu_size_map)
from x266_tpu_torch.kernels.interp import mv_bounds


@dataclass
class TileData:
    """Device-step outputs of one frame (pre-entropy), on the host."""
    cfg: CodecConfig
    size_map: np.ndarray
    mode_map: np.ndarray
    mts_map: np.ndarray
    coef_y: np.ndarray
    coef_cb: np.ndarray
    coef_cr: np.ndarray
    recon: Frame | None
    sse: np.ndarray                # (3,) float32 SSE, the reference's sum
    sse_exact: np.ndarray          # (3,) int64 SSE against the source
    inter_maps: tuple | None = None   # P: (pred, mvx, mvy) final maps;
    #                                   B: and (mvx1, mvy1)
    sao: tuple | None = None       # (type, band, off), plane axis first
    alf: tuple | None = None       # the ALF parameter tuple (fused)


def _upload(frames: list[Frame], device: torch.device):
    planes = [np.stack([getattr(f, p) for f in frames])
              for p in ("y", "cb", "cr")]
    return [torch.from_numpy(p).to(device, non_blocking=True)
            for p in planes]


def tiles_compute_batched_async(cfg: CodecConfig, step, frames: list[Frame],
                                device: torch.device):
    """Queue one device step over a chunk of frames; returns
    finalize() -> list[TileData], which waits for and downloads it.
    step: fused.make_encode_step_i(cfg, tab, with_recon)."""
    out = step(*_upload(frames, device))

    return lambda: _download(cfg, out, len(frames))


def _download(cfg: CodecConfig, out: dict, n: int) -> list[TileData]:
    """A step's device outputs -> per-frame TileData (waits for them)."""
    coef = [c.cpu().numpy() for c in out["coef"]]
    maps = [m.cpu().numpy().astype(np.int32) for m in out["maps"]]
    sse = out["sse"].cpu().numpy()
    sse_exact = out["sse_exact"].cpu().numpy()
    rec = ([r.cpu().numpy() for r in out["recon"]]
           if "recon" in out else None)
    sao, alf = ([[a.cpu().numpy() for a in out[k]] if k in out else None
                 for k in ("sao", "alf")])
    return [TileData(cfg, maps[0][i], maps[1][i], maps[2][i],
                     coef[0][i].astype(np.int32),
                     coef[1][i].astype(np.int32),
                     coef[2][i].astype(np.int32),
                     Frame(rec[0][i], rec[1][i], rec[2][i])
                     if rec is not None else None, sse[i], sse_exact[i],
                     tuple(m[i] for m in maps[3:]) if len(maps) > 3
                     else None,
                     tuple(a[i] for a in sao) if cfg.sao else None,
                     tuple(a[i] for a in alf) if cfg.alf else None)
            for i in range(n)]


def tile_compute_async(cfg: CodecConfig, step, frame: Frame,
                       device: torch.device):
    """One frame: finalize() -> TileData."""
    fin = tiles_compute_batched_async(cfg, step, [frame], device)
    return lambda: fin()[0]


def code_segments(cfg: CodecConfig, size_map, mode_map, cy, ccb, ccr,
                  mts_map=None, inter_maps=None,
                  sao_params=None) -> list[bytes]:
    """Entropy-code a picture's segments in order, chaining WPP context
    inheritance when cfg.ctx_inherit: segment i > 0 starts from segment
    i-1's states after its first min(2, ctus_x) CTUs.  inter_maps: a P
    picture's (pred, mvx, mvy) maps, a B picture's (pred, mvx, mvy, mvx1,
    mvy1), None for an I picture; sao_params: (type, band, off) with
    cfg.sao."""
    rows = cfg.segment_ctu_rows()
    inherit = cfg.ctx_inherit and len(rows) > 1
    segs: list[bytes] = []
    prev = None
    if native_bind.available():
        for i, (r0, r1) in enumerate(rows):
            snap = (np.zeros(2 * NUM_CONTEXTS, np.int32)
                    if inherit and i < len(rows) - 1 else None)
            segs.append(native_bind.encode_segment(
                cfg, size_map, mode_map, cy, ccb, ccr, r0, r1, sao_params,
                mts_map, inter_maps, init_states=prev, snapshot=snap))
            prev = snap
        return segs
    is_b = inter_maps is not None and len(inter_maps) == 5
    enc = SyntaxEncoder(
        cfg, size_map, mode_map, cy, ccb, ccr, sao_params, mts_map,
        is_p=inter_maps is not None and not is_b, is_b=is_b,
        pred_map=inter_maps[0] if inter_maps else None,
        mvx_map=inter_maps[1] if inter_maps else None,
        mvy_map=inter_maps[2] if inter_maps else None,
        mvx1_map=inter_maps[3] if is_b else None,
        mvy1_map=inter_maps[4] if is_b else None)
    for i, (r0, r1) in enumerate(rows):
        segs.append(enc.encode_segment(
            r0, r1, init_states=prev,
            snapshot=inherit and i < len(rows) - 1))
        prev = enc.snapshot
    return segs


def tile_entropy(td: TileData) -> list[bytes]:
    return code_segments(td.cfg, td.size_map, td.mode_map, td.coef_y,
                         td.coef_cb, td.coef_cr, td.mts_map, td.inter_maps,
                         td.sao)


def _ints(a) -> list[int]:
    return [int(v) for v in np.asarray(a).ravel()]


def assemble_slice(cfg: CodecConfig, poc: int, segments: list[bytes],
                   slice_type: SliceType = SliceType.I,
                   ref_pocs: list[list[int]] | None = None,
                   alf: tuple | None = None,
                   wp: list[int] | None = None) -> bytes:
    """Slice RBSP: header with the entry points, segment payloads and
    the 0x80 stop byte.  ref_pocs: an inter slice's reference POCs
    ([[L0]] for P, [[L0], [L1]] for B), signalled as POC deltas when
    cfg.rpl; alf: the picture's ALF parameter tuple (fused.loop_filters)
    with cfg.alf; wp: an inter slice's weights, [wy, oy, wc, oc] per
    list (P 4 values, B 8), written with cfg.weighted_pred."""
    entry_points = [int(e) for e in np.cumsum([len(s)
                                               for s in segments[:-1]])]
    payload = b"".join(segments) + b"\x80"
    inter = slice_type != SliceType.I
    rpl = None
    if cfg.rpl and inter and ref_pocs is not None:
        rpl = [[poc - rp for rp in lst] for lst in ref_pocs]
    kw = {}
    if cfg.alf:
        flag, coef, cflag, ccoef, clip, cclip, cc_coef, cc_flag = alf
        kw = dict(alf_coeffs=_ints(coef), alf_flags=_ints(flag))
        if cfg.alf_nonlinear:
            kw["alf_clips"] = _ints(clip)
        if cfg.alf_chroma:
            kw.update(alf_ccoeffs=_ints(ccoef), alf_cflags=_ints(cflag))
            if cfg.alf_nonlinear:
                kw["alf_cclips"] = _ints(cclip)
        if cfg.ccalf:
            kw.update(ccalf_coeffs=_ints(cc_coef),
                      ccalf_flags=_ints(cc_flag))
    sh = SliceHeader(slice_type, poc=poc, qp=cfg.qp,
                     entry_points=entry_points, rpl=rpl,
                     rpl_expected=cfg.rpl and inter,
                     wp=wp if inter else None, **kw)
    return write_slice_header(sh) + payload


def encode_picture_gop_async(cfg: CodecConfig, steps, frame: Frame,
                             poc: int, pyramids, device: torch.device,
                             ref_poc: int | None = None, wp=None):
    """Queue one picture of a low-delay stream without blocking.

    steps: (fused.make_encode_step_i(cfg, tab, with_recon, True),
    fused.make_encode_step_p(cfg, tab, with_recon)), or for an all-intra
    stream (cfg.intra_period 1) an I step without pyramids and None;
    pyramids: the previous picture's, or None (an IDR).  A picture codes as IDR when
    its POC is a multiple of cfg.intra_period.  wp: a P picture's
    weights [wy, oy, wc, oc] with cfg.weighted_pred (None: identity).
    Returns (finalize, new_pyramids, slice_type); the new pyramids are
    on the device at once (the next picture's only dependency) and
    finalize() -> (rbsp, recon | None, sse, sse_exact) downloads and
    entropy-codes."""
    is_p = (pyramids is not None and cfg.intra_period > 1
            and poc % cfg.intra_period != 0)
    planes = _upload([frame], device)
    if is_p:
        out = steps[1](*planes, *pyramids,
                       wp=wp if cfg.weighted_pred else None)
    else:
        out = steps[0](*planes)
    st = SliceType.P if is_p else SliceType.I

    def finalize():
        td = _download(cfg, out, 1)[0]
        rbsp = assemble_slice(
            cfg, poc, tile_entropy(td), st,
            ref_pocs=[[ref_poc]] if (is_p and ref_poc is not None)
            else None, alf=td.alf,
            wp=wp if (is_p and cfg.weighted_pred) else None)
        return rbsp, td.recon, td.sse, td.sse_exact

    return finalize, out.get("pyramids"), st


def b_qp_offset(cfg: CodecConfig, poc: int) -> int:
    """An RA B picture's QP offset: +1 for referenced (even-POC) B
    pictures, +3 for the hierarchy's leaves (0 when lossless)."""
    if cfg.lossless:
        return 0
    return 1 if poc % 2 == 0 else 3


def gop_coding_order(n: int, intra_period: int, gop: int
                     ) -> list[tuple[int, str]]:
    """Random-access coding order: [(poc, kind)], kind "I", "P" or "B".
    Anchors sit at multiples of gop -- an IDR at multiples of
    intra_period, else a P picture referencing the previous anchor --
    and the POCs between two anchors code as hierarchical-B midpoints,
    each referencing the nearest coded pictures below and above it.  A
    tail after the last anchor codes low-delay P."""
    order: list[tuple[int, str]] = []

    def mids(lo, hi):
        if hi - lo <= 1:
            return
        m = (lo + hi) // 2
        order.append((m, "B"))
        mids(lo, m)
        mids(m, hi)

    anchors = list(range(0, n, max(gop, 1)))
    prev = None
    for a in anchors:
        order.append((a, "I" if (intra_period <= 0 or a % intra_period == 0)
                      else "P"))
        if prev is not None:
            mids(prev, a)
        prev = a
    order += [(p, "P") for p in range(anchors[-1] + 1, n)]
    return order


def encode_picture_b_async(cfg: CodecConfig, step, frame: Frame, poc: int,
                           pyr0, pyr1, device: torch.device,
                           ref_pocs=None, wp=None):
    """Queue one B picture without blocking.  step:
    fused.make_encode_step_b(cfg, tab, with_recon, with_pyramids); pyr0,
    pyr1: the L0 and L1 references' pyramids; wp: with
    cfg.weighted_pred, the L0 and L1 weights [[wy, oy, wc, oc], [...]]
    (None: identity), which the slice header carries as 8 values.
    Returns (finalize, new_pyramids or None); finalize() -> (rbsp,
    recon | None, sse, sse_exact)."""
    if cfg.weighted_pred and wp is None:
        wp = [IDENTITY_WP, IDENTITY_WP]
    out = step(*_upload([frame], device), *pyr0, *pyr1,
               wp=wp if cfg.weighted_pred else None)

    def finalize():
        td = _download(cfg, out, 1)[0]
        rbsp = assemble_slice(cfg, poc, tile_entropy(td), SliceType.B,
                              ref_pocs=ref_pocs, alf=td.alf,
                              wp=[*wp[0], *wp[1]] if cfg.weighted_pred
                              else None)
        return rbsp, td.recon, td.sse, td.sse_exact

    return finalize, out.get("pyramids")


def _parse_segments(cfg: CodecConfig, segments: list[bytes],
                    is_p: bool = False, is_b: bool = False
                    ) -> SyntaxDecoder:
    dec = SyntaxDecoder(cfg)
    dec.is_p = is_p or is_b
    dec.is_b = is_b
    imaps = ((dec.pred_map, dec.mvx_map, dec.mvy_map, dec.mvx1_map,
              dec.mvy1_map) if is_b
             else (dec.pred_map, dec.mvx_map, dec.mvy_map) if is_p
             else None)
    rows = cfg.segment_ctu_rows()
    if len(segments) != len(rows):
        raise ValueError("segment count mismatch")
    inherit = cfg.ctx_inherit and len(rows) > 1
    prev = None
    for i, ((r0, r1), data) in enumerate(zip(rows, segments)):
        if native_bind.available():
            snap = (np.zeros(2 * NUM_CONTEXTS, np.int32)
                    if inherit and i < len(rows) - 1 else None)
            native_bind.decode_segment(
                cfg, dec.size_map, dec.mode_map, dec.coef["y"],
                dec.coef["cb"], dec.coef["cr"], r0, r1, data,
                sao_params=dec.sao, mts_map=dec.mts_map, inter_maps=imaps,
                init_states=prev, snapshot=snap)
            prev = snap
        else:
            dec.decode_segment(data, r0, r1, init_states=prev,
                               snapshot=inherit and i < len(rows) - 1)
            prev = dec.snapshot
    return dec


def alf_maps_from_header(cfg: CodecConfig, sh: SliceHeader,
                         device: torch.device) -> dict:
    """The picture's ALF maps from the slice header (single tile):
    int32 tensors on the device, zeros for what the header lacks."""
    cy, cx = cfg.ctus_y, cfg.ctus_x
    fields = {"alf_flag": (sh.alf_flags, (cy, cx)),
              "alf_coef": (sh.alf_coeffs, (25, 12)),
              "alf_clip": (sh.alf_clips, (25,)),
              "alf_cflag": (sh.alf_cflags, (2, cy, cx)),
              "alf_ccoef": (sh.alf_ccoeffs, (2, 6)),
              "alf_cclip": (sh.alf_cclips, (2,)),
              "ccalf_coef": (sh.ccalf_coeffs, (2, 7)),
              "ccalf_flag": (sh.ccalf_flags, (2, cy, cx))}
    out = {}
    for name, (vals, shape) in fields.items():
        a = (np.asarray(vals, np.int32).reshape(shape) if vals is not None
             else np.zeros(shape, np.int32))
        out[name] = torch.from_numpy(a).to(device)
    return out


def _decode_device(cfg: CodecConfig, decode_step, sh: SliceHeader,
                   segments: list[bytes], device: torch.device,
                   pyramids=()):
    """Host entropy parse, then the device recon -- K2 on CUDA for an I
    picture, K3-P for a P picture (the reference's pyramids given), K3-B
    for a B picture (L0's then L1's pyramids) -- and the loop filters.
    Returns the recon planes (1, H, W) / (1, H/2, W/2) on the device."""
    is_b = len(pyramids) == 6
    is_p = len(pyramids) == 3
    dec = _parse_segments(cfg, segments, is_p, is_b)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a[None]).astype(
            dtype)).to(device)

    args = [up(dec.coef[p], np.int16) for p in ("y", "cb", "cr")]
    maps = [dec.size_map, dec.mode_map, dec.mts_map]
    mv_maps = ([dec.mvx_map, dec.mvy_map]
               + ([dec.mvx1_map, dec.mvy1_map] if is_b else []))
    if is_p or is_b:
        # MVs come from the stream: a read past the reference's pad is
        # refused here, as the kernel cannot clamp it the way the
        # reference's slices do
        bound = mv_bounds(cfg, 16)
        if max(int(np.abs(m).max()) for m in mv_maps) > bound:
            raise ValueError(f"{sh.slice_type.name} slice MV beyond "
                             f"+-{bound} quarter-pels")
        maps += [dec.pred_map, *mv_maps[:2]]
    args += [up(m, np.int32) for m in maps]
    l1 = [up(m, np.int32) for m in mv_maps[2:]]
    out = decode_step(*args, *pyramids, *l1)
    rec = [r[0] for r in out[:3]]
    if not has_filters(cfg):
        return out[:3]
    db_info = None
    if is_p or is_b:
        db_info = (args[6][0], out[6][0].to(torch.int32),
                   out[7][0].to(torch.int32), args[0][0].to(torch.int32))
    sao = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
           for a in dec.sao]
    rec = decode_filters(cfg, *rec, tu_size_map(cfg, args[3][0],
                                                 args[5][0]), sao,
                         alf_maps_from_header(cfg, sh, device), db_info)
    return tuple(r[None] for r in rec)


def _split_payload(sh: SliceHeader, payload: bytes) -> list[bytes]:
    bounds = [0] + [int(e) for e in sh.entry_points] + [len(payload) - 1]
    return [payload[b0:b1] for b0, b1 in zip(bounds[:-1], bounds[1:])]


def decode_picture_gop(cfg: CodecConfig, steps, sh: SliceHeader,
                       payload: bytes, pyramids, device: torch.device,
                       with_pyramids: bool = True):
    """One I, P or B picture; payload: the slice RBSP after the header
    (incl. the stop byte); steps: (fused.make_decode_step_i(cfg, tab),
    engine.inter.recon_inter_pass(cfg, tab, encode=False), the same with
    b_mode=True); pyramids: the reference's for a P slice, (L0's, L1's)
    for a B slice.  With cfg.weighted_pred each list's reference is
    reweighted by the slice header's weights (identity where the header
    has none) before the step.  Returns (Frame, new_pyramids), the
    pyramids built from this picture and left on the device, or None
    without with_pyramids."""
    kind = {SliceType.I: 0, SliceType.P: 1, SliceType.B: 2}[sh.slice_type]
    if kind and pyramids is None:
        raise ValueError(f"{sh.slice_type.name} slice before any reference "
                         "picture")
    lists = [] if kind == 0 else [pyramids] if kind == 1 else list(pyramids)
    if cfg.weighted_pred and kind:
        wp = (list(sh.wp) if sh.wp is not None
              else list(IDENTITY_WP) * len(lists))
        lists = [apply_wp(cfg, p, wp[4 * i:4 * i + 4])
                 for i, p in enumerate(lists)]
    refs = tuple(t for p in lists for t in p)
    rec = _decode_device(cfg, steps[kind], sh, _split_payload(sh, payload),
                         device, refs)
    new_pyr = (build_pyramids_device(*(r[0] for r in rec))
               if with_pyramids else None)
    return Frame(*(r[0].cpu().numpy() for r in rec)), new_pyr

