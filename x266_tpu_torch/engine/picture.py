"""Per-picture encode/decode orchestration for all-intra single-tile
pictures: the device step, host entropy coding and slice assembly.

Counterpart of x266_tpu/engine/picture.py (tile_compute_async :50-83,
tiles_compute_batched_async :114-160, code_segments :163-201,
tile_entropy :204-208, assemble_slice :247-312, _parse_segments
:332-365, tile_decode :415-432, decode_picture :435-455), restricted to
I slices without ALF.  The entropy coder is the reference's own
(x266_tpu.cabac: the native C++ range coder, or its Python mirror where
no C++ toolchain exists), so equal maps and levels give equal bytes.

Dispatch is asynchronous: the device step of a chunk of frames is queued
and ``finalize()`` does the ``.cpu()`` copies, so the kernels of later
chunks run while the host entropy-codes earlier ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from x266_tpu.cabac import native_bind
from x266_tpu.cabac.contexts import NUM_CONTEXTS
from x266_tpu.cabac.syntax import SyntaxDecoder, SyntaxEncoder
from x266_tpu.config import CodecConfig, SliceType
from x266_tpu.core.headers import SliceHeader, write_slice_header
from x266_tpu.core.yuv import Frame


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

    def finalize() -> list[TileData]:
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
                         if rec is not None else None, sse[i])
                for i in range(len(frames))]

    return finalize


def tile_compute_async(cfg: CodecConfig, step, frame: Frame,
                       device: torch.device):
    """One frame: finalize() -> TileData."""
    fin = tiles_compute_batched_async(cfg, step, [frame], device)
    return lambda: fin()[0]


def code_segments(cfg: CodecConfig, size_map, mode_map, cy, ccb, ccr,
                  mts_map=None) -> list[bytes]:
    """Entropy-code an I picture's segments in order, chaining WPP
    context inheritance when cfg.ctx_inherit: segment i > 0 starts from
    segment i-1's states after its first min(2, ctus_x) CTUs."""
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
                mts_map, None, init_states=prev, snapshot=snap))
            prev = snap
        return segs
    enc = SyntaxEncoder(cfg, size_map, mode_map, cy, ccb, ccr, None,
                        mts_map)
    for i, (r0, r1) in enumerate(rows):
        segs.append(enc.encode_segment(
            r0, r1, init_states=prev,
            snapshot=inherit and i < len(rows) - 1))
        prev = enc.snapshot
    return segs


def tile_entropy(td: TileData) -> list[bytes]:
    return code_segments(td.cfg, td.size_map, td.mode_map, td.coef_y,
                         td.coef_cb, td.coef_cr, td.mts_map)


def assemble_slice(cfg: CodecConfig, poc: int,
                   segments: list[bytes]) -> bytes:
    """I-slice RBSP: header with the entry points, segment payloads and
    the 0x80 stop byte."""
    entry_points = [int(e) for e in np.cumsum([len(s)
                                               for s in segments[:-1]])]
    payload = b"".join(segments) + b"\x80"
    sh = SliceHeader(SliceType.I, poc=poc, qp=cfg.qp,
                     entry_points=entry_points)
    return write_slice_header(sh) + payload


def _parse_segments(cfg: CodecConfig, segments: list[bytes]) -> SyntaxDecoder:
    dec = SyntaxDecoder(cfg)
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
                sao_params=dec.sao, mts_map=dec.mts_map, inter_maps=None,
                init_states=prev, snapshot=snap)
            prev = snap
        else:
            dec.decode_segment(data, r0, r1, init_states=prev,
                               snapshot=inherit and i < len(rows) - 1)
            prev = dec.snapshot
    return dec


def tile_decode(cfg: CodecConfig, decode_step, segments: list[bytes],
                device: torch.device) -> Frame:
    """Host entropy parse, then the device recon (K2 on CUDA).
    decode_step: fused.make_decode_step_i(cfg, tab)."""
    dec = _parse_segments(cfg, segments)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a[None]).astype(
            dtype)).to(device)

    rec = decode_step(up(dec.coef["y"], np.int16),
                      up(dec.coef["cb"], np.int16),
                      up(dec.coef["cr"], np.int16),
                      up(dec.size_map, np.int32), up(dec.mode_map, np.int32),
                      up(dec.mts_map, np.int32))
    return Frame(*(r[0].cpu().numpy() for r in rec))


def decode_picture(cfg: CodecConfig, decode_step, sh: SliceHeader,
                   payload: bytes, device: torch.device) -> Frame:
    """payload: slice RBSP after the header (incl. the stop byte)."""
    bounds = [0] + [int(e) for e in sh.entry_points] + [len(payload) - 1]
    segments = [payload[b0:b1] for b0, b1 in zip(bounds[:-1], bounds[1:])]
    return tile_decode(cfg, decode_step, segments, device)

