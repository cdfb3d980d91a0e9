"""Per-picture encode/decode orchestration for single-tile I and P
pictures: the device step, host entropy coding and slice assembly.

Counterpart of x266_tpu/engine/picture.py (tile_compute_async :50-83,
tiles_compute_batched_async :114-160, code_segments :163-201,
tile_entropy :204-208, assemble_slice :247-312, _parse_segments
:332-365, encode_picture_gop_async :563-616, decode_picture_gop
:764-795, which here decodes every I picture too), without
SAO, ALF or weighted prediction.  The entropy coder is the reference's
own, carried in x266_tpu_torch.cabac (the native C++ range coder, or its
Python mirror where no C++ toolchain exists), so equal maps and levels
give equal bytes.

Dispatch is asynchronous: the device step of a chunk of frames (or of
one P picture) is queued and ``finalize()`` does the ``.cpu()`` copies,
so the kernels of later pictures run while the host entropy-codes
earlier ones.  A P picture's only dependency is the previous picture's
pyramids, which stay on the device.
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
from x266_tpu_torch.engine.fused import build_pyramids_device
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
    sse: np.ndarray                # (3,) SSE against the source
    inter_maps: tuple | None = None   # P: (pred, mvx, mvy) final maps


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
    rec = ([r.cpu().numpy() for r in out["recon"]]
           if "recon" in out else None)
    return [TileData(cfg, maps[0][i], maps[1][i], maps[2][i],
                     coef[0][i].astype(np.int32),
                     coef[1][i].astype(np.int32),
                     coef[2][i].astype(np.int32),
                     Frame(rec[0][i], rec[1][i], rec[2][i])
                     if rec is not None else None, sse[i],
                     tuple(m[i] for m in maps[3:]) if len(maps) > 3
                     else None)
            for i in range(n)]


def tile_compute_async(cfg: CodecConfig, step, frame: Frame,
                       device: torch.device):
    """One frame: finalize() -> TileData."""
    fin = tiles_compute_batched_async(cfg, step, [frame], device)
    return lambda: fin()[0]


def code_segments(cfg: CodecConfig, size_map, mode_map, cy, ccb, ccr,
                  mts_map=None, inter_maps=None) -> list[bytes]:
    """Entropy-code a picture's segments in order, chaining WPP context
    inheritance when cfg.ctx_inherit: segment i > 0 starts from segment
    i-1's states after its first min(2, ctus_x) CTUs.  inter_maps: a P
    picture's (pred, mvx, mvy) maps, None for an I picture."""
    rows = cfg.segment_ctu_rows()
    inherit = cfg.ctx_inherit and len(rows) > 1
    segs: list[bytes] = []
    prev = None
    if native_bind.available():
        for i, (r0, r1) in enumerate(rows):
            snap = (np.zeros(2 * NUM_CONTEXTS, np.int32)
                    if inherit and i < len(rows) - 1 else None)
            segs.append(native_bind.encode_segment(
                cfg, size_map, mode_map, cy, ccb, ccr, r0, r1, None,
                mts_map, inter_maps, init_states=prev, snapshot=snap))
            prev = snap
        return segs
    is_p = inter_maps is not None
    enc = SyntaxEncoder(
        cfg, size_map, mode_map, cy, ccb, ccr, None, mts_map, is_p=is_p,
        pred_map=inter_maps[0] if is_p else None,
        mvx_map=inter_maps[1] if is_p else None,
        mvy_map=inter_maps[2] if is_p else None)
    for i, (r0, r1) in enumerate(rows):
        segs.append(enc.encode_segment(
            r0, r1, init_states=prev,
            snapshot=inherit and i < len(rows) - 1))
        prev = enc.snapshot
    return segs


def tile_entropy(td: TileData) -> list[bytes]:
    return code_segments(td.cfg, td.size_map, td.mode_map, td.coef_y,
                         td.coef_cb, td.coef_cr, td.mts_map, td.inter_maps)


def assemble_slice(cfg: CodecConfig, poc: int, segments: list[bytes],
                   slice_type: SliceType = SliceType.I,
                   ref_pocs: list[list[int]] | None = None) -> bytes:
    """Slice RBSP: header with the entry points, segment payloads and
    the 0x80 stop byte.  ref_pocs: a P slice's reference POCs ([[L0]]),
    signalled as POC deltas when cfg.rpl."""
    entry_points = [int(e) for e in np.cumsum([len(s)
                                               for s in segments[:-1]])]
    payload = b"".join(segments) + b"\x80"
    inter = slice_type != SliceType.I
    rpl = None
    if cfg.rpl and inter and ref_pocs is not None:
        rpl = [[poc - rp for rp in lst] for lst in ref_pocs]
    sh = SliceHeader(slice_type, poc=poc, qp=cfg.qp,
                     entry_points=entry_points, rpl=rpl,
                     rpl_expected=cfg.rpl and inter)
    return write_slice_header(sh) + payload


def encode_picture_gop_async(cfg: CodecConfig, steps, frame: Frame,
                             poc: int, pyramids, device: torch.device,
                             ref_poc: int | None = None):
    """Queue one picture of a low-delay stream without blocking.

    steps: (fused.make_encode_step_i(cfg, tab, with_recon, True),
    fused.make_encode_step_p(cfg, tab, with_recon)); pyramids: the
    previous picture's, or None (an IDR).  A picture codes as IDR when
    its POC is a multiple of cfg.intra_period.  Returns (finalize,
    new_pyramids, slice_type); the new pyramids are on the device at
    once (the next picture's only dependency) and finalize() ->
    (rbsp, recon | None, sse) downloads and entropy-codes."""
    is_p = (pyramids is not None and cfg.intra_period > 1
            and poc % cfg.intra_period != 0)
    planes = _upload([frame], device)
    out = steps[1](*planes, *pyramids) if is_p else steps[0](*planes)
    st = SliceType.P if is_p else SliceType.I

    def finalize():
        td = _download(cfg, out, 1)[0]
        rbsp = assemble_slice(
            cfg, poc, tile_entropy(td), st,
            ref_pocs=[[ref_poc]] if (is_p and ref_poc is not None)
            else None)
        return rbsp, td.recon, td.sse

    return finalize, out["pyramids"], st


def _parse_segments(cfg: CodecConfig, segments: list[bytes],
                    is_p: bool = False) -> SyntaxDecoder:
    dec = SyntaxDecoder(cfg)
    dec.is_p = is_p
    imaps = (dec.pred_map, dec.mvx_map, dec.mvy_map) if is_p else None
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


def _decode_device(cfg: CodecConfig, decode_step, segments: list[bytes],
                   device: torch.device, pyramids=None):
    """Host entropy parse, then the device recon: K2 on CUDA for an I
    picture, K3 (decode form) for a P picture (pyramids given).
    Returns the recon planes (1, H, W) / (1, H/2, W/2) on the device."""
    is_p = pyramids is not None
    dec = _parse_segments(cfg, segments, is_p)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a[None]).astype(
            dtype)).to(device)

    args = [up(dec.coef[p], np.int16) for p in ("y", "cb", "cr")]
    maps = [dec.size_map, dec.mode_map, dec.mts_map]
    if is_p:
        # MVs come from the stream: a read past the reference's pad is
        # refused here, as the kernel cannot clamp it the way the
        # reference's slices do
        bound = mv_bounds(cfg, 16)
        if max(np.abs(dec.mvx_map).max(), np.abs(dec.mvy_map).max()) > bound:
            raise ValueError(f"P slice MV beyond +-{bound} quarter-pels")
        maps += [dec.pred_map, dec.mvx_map, dec.mvy_map]
    args += [up(m, np.int32) for m in maps]
    return decode_step(*args, *(pyramids or ()))[:3]


def _split_payload(sh: SliceHeader, payload: bytes) -> list[bytes]:
    bounds = [0] + [int(e) for e in sh.entry_points] + [len(payload) - 1]
    return [payload[b0:b1] for b0, b1 in zip(bounds[:-1], bounds[1:])]


def decode_picture_gop(cfg: CodecConfig, steps, sh: SliceHeader,
                       payload: bytes, pyramids, device: torch.device,
                       with_pyramids: bool = True):
    """One I or P picture; payload: the slice RBSP after the header
    (incl. the stop byte); steps: (fused.make_decode_step_i(cfg, tab),
    engine.inter.recon_inter_pass(cfg, tab, encode=False)); pyramids:
    the reference's, for a P slice.  Returns (Frame, new_pyramids), the
    pyramids built from this picture and left on the device, or None
    without with_pyramids."""
    is_p = sh.slice_type == SliceType.P
    if is_p and pyramids is None:
        raise ValueError("P slice before any reference picture")
    rec = _decode_device(cfg, steps[1] if is_p else steps[0],
                         _split_payload(sh, payload), device,
                         pyramids if is_p else None)
    new_pyr = (build_pyramids_device(*(r[0] for r in rec))
               if with_pyramids else None)
    return Frame(*(r[0].cpu().numpy() for r in rec)), new_pyr

