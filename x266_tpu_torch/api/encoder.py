"""Encoder front-end: frames -> Annex-B style bytestream.

Counterpart of x266_tpu/api/encoder.py: the all-intra branch (:88-161),
the low-delay loop ``_encode_gop`` (:163-223) and the random-access loop
``_encode_ra`` (:304-382), without rate control, weighted prediction,
multiple references or tiles.  All-intra frames go to the device in
chunks of ``batch_frames``; every chunk's step is queued before the
first is finalized, so the device works on later chunks while the host
entropy-codes earlier ones.  In a low-delay stream (intra_period > 1,
gop_size 1) an IDR starts every intra_period frames and the pictures
between are P pictures; frame i+1 is dispatched before frame i is
finalized, its only dependency being frame i's pyramids on the device.
A random-access stream (gop_size > 1) codes anchors every gop_size
pictures and hierarchical B pictures between them, in coding order.
The intra tools (lossless, transform skip, PDPC, MIP) code on every
picture type.  The stream is identical to the reference's for the same
frames and config.
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
from x266_tpu_torch.engine.picture import (assemble_slice, b_qp_offset,
                                           encode_picture_b_async,
                                           encode_picture_gop_async,
                                           gop_coding_order,
                                           tiles_compute_batched_async,
                                           tile_entropy)
from x266_tpu_torch.engine.recon import check_slice


@dataclass
class EncodeResult:
    bitstream: bytes
    recon: list[Frame]
    frame_bits: list[int] = field(default_factory=list)
    # per-frame (3,) SSE: float32 as the reference sums it, and exact
    sse: list = field(default_factory=list)
    sse_exact: list = field(default_factory=list)

    def psnr_y(self, width: int, height: int,
               max_val: int = 255) -> list[float]:
        """Luma PSNR per frame from the device-computed float32 SSE, as
        the reference reports it: with a float32 SSE the quotient and
        the logarithm are float32 too (numpy's promotion)."""
        n = float(width * height)
        return [float(10 * np.log10(float(max_val) ** 2 * n
                                    / max(s[0], 1e-9)))
                for s in self.sse]

    @property
    def total_bits(self) -> int:
        return 8 * len(self.bitstream)


def check_config(cfg: CodecConfig, encode: bool = True) -> None:
    """Raise NotImplementedError for anything outside the port's slices:
    all-intra, low-delay P or random access (gop_size > 1), one tile,
    8-bit, CU <= 32, tools limited to MTS, RDOQ, reference substitution,
    merge candidates, AMVP, signalled reference lists, deblock, SAO,
    ALF, lossless, transform skip, PDPC and MIP.  The decoder
    (encode=False) also takes nonlinear ALF and CC-ALF, whose estimators
    are not ported."""
    if cfg.num_tiles != 1:
        raise NotImplementedError("tiles are not in the port's slices")
    flags = ["weighted_pred", "multi_ref"]
    if encode:
        flags += ["alf_nonlinear", "ccalf"]
    for flag in flags:
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag} is not in the port's "
                                      "slices")
    check_slice(cfg)


class Encoder:
    """All-intra, low-delay P or random-access encoder, on the card
    unless the caller asks for the CPU (device="cpu").

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
        self.b_steps = {}       # (qp, is_ref) -> B step

    def encode(self, frames: list[Frame]) -> EncodeResult:
        cfg = self.cfg
        for frame in frames:
            if (frame.height, frame.width) != (cfg.height, cfg.width):
                raise ValueError("frame size does not match config")
        out = [write_nal(NalType.VPS, headers.write_vps(cfg)),
               write_nal(NalType.SPS, headers.write_sps(cfg)),
               write_nal(NalType.PPS, headers.write_pps(cfg))]
        if cfg.intra_period != 1:
            if cfg.gop_size > 1:
                return self._encode_ra(frames, out)
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
                    cfg, poc, tile_entropy(td), alf=td.alf))
                out.append(nal)
                if td.recon is not None:
                    res.recon.append(td.recon)
                res.frame_bits.append(8 * len(nal))
                res.sse.append(td.sse)
                res.sse_exact.append(td.sse_exact)
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
            rbsp, recon, sse, sse_exact = fin()
            nal = write_nal(NalType.IDR if st == SliceType.I
                            else NalType.TRAIL, rbsp)
            out.append(nal)
            if recon is not None:
                res.recon.append(recon)
            res.frame_bits.append(8 * len(nal))
            res.sse.append(sse)
            res.sse_exact.append(sse_exact)

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

    def _b_step(self, poc: int):
        """The B step of POC poc: its QP is the anchor's plus
        b_qp_offset, and a leaf (odd POC) builds no pyramids.  Steps are
        made once per (QP, referenced) and reused."""
        bc = self.cfg.replace(qp=self.cfg.qp + b_qp_offset(self.cfg, poc))
        key = (bc.qp, poc % 2 == 0)
        if key not in self.b_steps:
            self.b_steps[key] = (bc, fused.make_encode_step_b(
                bc, self.tab, self.with_recon, with_pyramids=key[1]))
        return self.b_steps[key]

    def _encode_ra(self, frames: list[Frame],
                   out: list[bytes]) -> EncodeResult:
        """Random access: anchors every gop_size pictures (IDR at
        multiples of intra_period, else P on the previous anchor) and
        hierarchical B pictures between, each on the nearest coded
        pictures below and above.  NALs leave in coding order; recon,
        bits and SSE come back in display order.  The DPB keeps the
        pyramids of POCs from the previous anchor on; leaf B pictures
        are never referenced and build none.  The next picture is
        dispatched before the last one is finalized."""
        cfg = self.cfg
        dpb: dict[int, tuple] = {}
        per_poc: dict[int, tuple] = {}
        pending = []

        def drain():
            poc, fin, nal_type = pending.pop(0)
            rbsp, recon, *sse = fin()
            nal = write_nal(nal_type, rbsp)
            out.append(nal)
            per_poc[poc] = (nal, recon, *sse)

        for poc, kind in gop_coding_order(len(frames), cfg.intra_period,
                                          cfg.gop_size):
            if kind == "B":
                l0 = max(p for p in dpb if p < poc)
                l1 = min(p for p in dpb if p > poc)
                bc, step = self._b_step(poc)
                fin, pyr = encode_picture_b_async(
                    bc, step, frames[poc], poc, dpb[l0], dpb[l1],
                    self.device, ref_pocs=[[l0], [l1]])
                nal_type = NalType.TRAIL
            else:
                rpoc = (None if kind == "I"
                        else max(p for p in dpb if p < poc))
                fin, pyr, st = encode_picture_gop_async(
                    cfg, self.steps, frames[poc], poc,
                    None if rpoc is None else dpb[rpoc], self.device,
                    ref_poc=rpoc)
                nal_type = NalType.IDR if st == SliceType.I else \
                    NalType.TRAIL
            if pyr is not None:
                dpb[poc] = pyr
            pending.append((poc, fin, nal_type))
            while len(pending) > 1:
                drain()
            if kind != "B" and poc > 0:
                # a new span (previous anchor, poc]: older pyramids go
                for p in [p for p in dpb if p < poc - cfg.gop_size]:
                    del dpb[p]
        while pending:
            drain()
        pocs = sorted(per_poc)
        return EncodeResult(b"".join(out),
                            [per_poc[p][1] for p in pocs
                             if per_poc[p][1] is not None],
                            [8 * len(per_poc[p][0]) for p in pocs],
                            [per_poc[p][2] for p in pocs],
                            [per_poc[p][3] for p in pocs])
