"""Encoder front-end: frames -> Annex-B style bytestream, all-intra.

Counterpart of the all-intra branch of x266_tpu/api/encoder.py:88-161.
Frames go to the device in chunks of ``batch_frames``; every chunk's step
is queued before the first is finalized, so the device works on later
chunks while the host entropy-codes earlier ones.  The stream is
identical to the reference's for the same frames and config.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from x266_tpu.config import CodecConfig
from x266_tpu.core import headers
from x266_tpu.core.nal import NalType, write_nal
from x266_tpu.core.yuv import Frame

from x266_tpu_torch import device as devmod
from x266_tpu_torch import tables
from x266_tpu_torch.engine import fused
from x266_tpu_torch.engine.picture import (assemble_slice,
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
    """Raise NotImplementedError for anything outside the port's first
    slice: all-intra, one tile, 8-bit, no loop filters, CU <= 32, tools
    limited to MTS, RDOQ and reference substitution."""
    if cfg.intra_period != 1 or cfg.gop_size > 1:
        raise NotImplementedError("the port's first slice is all-intra")
    if cfg.num_tiles != 1:
        raise NotImplementedError("tiles are not in the port's first slice")
    for flag in ("deblock", "sao", "alf", "weighted_pred", "multi_ref",
                 "rpl", "merge_cands", "amvp"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag} is not in the port's "
                                      "first slice")
    check_slice(cfg)


class Encoder:
    """All-intra encoder on an explicit device.

    >>> enc = Encoder(CodecConfig(width=416, height=240), device="cuda")
    >>> result = enc.encode(frames)
    """

    def __init__(self, cfg: CodecConfig, device, with_recon: bool = True,
                 batch_frames: int = 1, rate_control=None):
        if rate_control is not None:
            raise NotImplementedError("rate control is not in the port's "
                                      "first slice")
        check_config(cfg)
        self.cfg = cfg
        self.device = devmod.resolve(device)
        self.with_recon = with_recon
        self.batch_frames = max(1, batch_frames)
        self.tab = tables.from_reference(cfg, self.device)
        self.step = fused.make_encode_step_i(cfg, self.tab, with_recon)

    def encode(self, frames: list[Frame]) -> EncodeResult:
        cfg = self.cfg
        for frame in frames:
            if (frame.height, frame.width) != (cfg.height, cfg.width):
                raise ValueError("frame size does not match config")
        out = [write_nal(NalType.VPS, headers.write_vps(cfg)),
               write_nal(NalType.SPS, headers.write_sps(cfg)),
               write_nal(NalType.PPS, headers.write_pps(cfg))]
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
