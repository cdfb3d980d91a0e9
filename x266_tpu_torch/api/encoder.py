"""Encoder front-end: frames -> Annex-B style bytestream.

Counterpart of x266_tpu/api/encoder.py: the all-intra branch (:88-161)
and the low-delay loop ``_encode_gop`` (:163-223) without rate control,
weighted prediction or tiles.  All-intra frames go to the device in
chunks of ``batch_frames``; every chunk's step is queued before the
first is finalized, so the device works on later chunks while the host
entropy-codes earlier ones.  In a low-delay stream (intra_period > 1)
an IDR starts every intra_period frames and the pictures between are P
pictures; frame i+1 is dispatched before frame i is finalized, its only
dependency being frame i's pyramids on the device.  The stream is
identical to the reference's for the same frames and config.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from x266_tpu_torch.config import CodecConfig, SliceType
from x266_tpu_torch.core import headers
from x266_tpu_torch.core.nal import NalType, write_nal
from x266_tpu_torch.core.yuv import Frame

from x266_tpu_torch import device as devmod
from x266_tpu_torch import tables
from x266_tpu_torch.engine import fused
from x266_tpu_torch.engine.picture import (assemble_slice,
                                           encode_picture_gop_async,
                                           tiles_compute_batched_async,
                                           tile_entropy)
from x266_tpu_torch.engine.recon import check_slice


@dataclass
class EncodeResult:
    bitstream: bytes
    recon: list[Frame]
    frame_bits: list[int] = field(default_factory=list)
    sse: list = field(default_factory=list)   # per-frame (3,) SSE

    def psnr_y(self, width: int, height: int,
               max_val: int = 255) -> list[float]:
        """Luma PSNR per frame from the device-computed SSE."""
        n = float(width * height)
        return [float(10 * np.log10(float(max_val) ** 2 * n
                                    / max(float(s[0]), 1e-9)))
                for s in self.sse]

    @property
    def total_bits(self) -> int:
        return 8 * len(self.bitstream)


def check_config(cfg: CodecConfig) -> None:
    """Raise NotImplementedError for anything outside the port's slices:
    all-intra or low-delay P (gop_size 1), one tile, 8-bit, no loop
    filters, CU <= 32, tools limited to MTS, RDOQ, reference
    substitution, merge candidates, AMVP and signalled reference
    lists."""
    if cfg.gop_size > 1:
        raise NotImplementedError("B pictures (gop_size > 1) are not in "
                                  "the port's slices")
    if cfg.num_tiles != 1:
        raise NotImplementedError("tiles are not in the port's slices")
    for flag in ("deblock", "sao", "alf", "weighted_pred", "multi_ref"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag} is not in the port's "
                                      "slices")
    check_slice(cfg)


class Encoder:
    """All-intra or low-delay P encoder, on the card unless the caller
    asks for the CPU (device="cpu").

    >>> enc = Encoder(preset_cfg3(1920, 1080))
    >>> result = enc.encode(frames)
    """

    def __init__(self, cfg: CodecConfig, device="cuda",
                 with_recon: bool = True, batch_frames: int = 1,
                 rate_control=None):
        if rate_control is not None:
            raise NotImplementedError("rate control is not in the port's "
                                      "slices")
        check_config(cfg)
        self.cfg = cfg
        self.device = devmod.resolve(device)
        self.with_recon = with_recon
        self.batch_frames = max(1, batch_frames)
        self.tab = tables.from_reference(cfg, self.device)
        if cfg.intra_period == 1:
            self.step = fused.make_encode_step_i(cfg, self.tab, with_recon)
        else:
            self.steps = (fused.make_encode_step_i(cfg, self.tab,
                                                   with_recon, True),
                          fused.make_encode_step_p(cfg, self.tab,
                                                   with_recon))

    def encode(self, frames: list[Frame]) -> EncodeResult:
        cfg = self.cfg
        for frame in frames:
            if (frame.height, frame.width) != (cfg.height, cfg.width):
                raise ValueError("frame size does not match config")
        out = [write_nal(NalType.VPS, headers.write_vps(cfg)),
               write_nal(NalType.SPS, headers.write_sps(cfg)),
               write_nal(NalType.PPS, headers.write_pps(cfg))]
        if cfg.intra_period != 1:
            return self._encode_gop(frames, out)
        bf = self.batch_frames
        fins = [tiles_compute_batched_async(cfg, self.step,
                                            frames[i:i + bf], self.device)
                for i in range(0, len(frames), bf)]
        res = EncodeResult(b"", [])
        poc = 0
        for fin in fins:
            for td in fin():
                nal = write_nal(NalType.IDR, assemble_slice(
                    cfg, poc, tile_entropy(td)))
                out.append(nal)
                if td.recon is not None:
                    res.recon.append(td.recon)
                res.frame_bits.append(8 * len(nal))
                res.sse.append(td.sse)
                poc += 1
        res.bitstream = b"".join(out)
        return res

    def _encode_gop(self, frames: list[Frame],
                    out: list[bytes]) -> EncodeResult:
        """Low-delay stream: IDR every intra_period frames, P pictures
        between; frame i+1 is dispatched before frame i is finalized."""
        res = EncodeResult(b"", [])
        pending = []
        pyramids = None

        def drain():
            fin, st = pending.pop(0)
            rbsp, recon, sse = fin()
            nal = write_nal(NalType.IDR if st == SliceType.I
                            else NalType.TRAIL, rbsp)
            out.append(nal)
            if recon is not None:
                res.recon.append(recon)
            res.frame_bits.append(8 * len(nal))
            res.sse.append(sse)

        for poc, frame in enumerate(frames):
            fin, pyramids, st = encode_picture_gop_async(
                self.cfg, self.steps, frame, poc, pyramids, self.device,
                ref_poc=poc - 1)
            pending.append((fin, st))
            while len(pending) > 1:
                drain()
        while pending:
            drain()
        res.bitstream = b"".join(out)
        return res
