"""Encoder front-end: frames -> Annex-B style bytestream.

Counterpart of x266_tpu/api/encoder.py: ``fit_weight`` (:36-62), the
all-intra branch (:88-161), the low-delay loop ``_encode_gop``
(:163-223), the low-delay GPB loop ``_encode_gpb`` (:225-302) and the
random-access loop ``_encode_ra`` (:304-382), with weighted prediction
on every inter picture, and without tiles.  Rate control
(utils/ratecontrol.py) codes a low-delay or all-intra stream picture by
picture through the low-delay loop (:186-210), each picture at the
controller's QP with steps made once per QP.  All-intra
frames go to the device in
chunks of ``batch_frames``; every chunk's step is queued before the
first is finalized, so the device works on later chunks while the host
entropy-codes earlier ones.  In a low-delay stream (intra_period > 1,
gop_size 1) an IDR starts every intra_period frames and the pictures
between are P pictures; frame i+1 is dispatched before frame i is
finalized, its only dependency being frame i's pyramids on the device.
With cfg.multi_ref (GPB) the first picture after each IDR is a P
picture and every later one a B slice on two past pictures.  A
random-access stream (gop_size > 1) codes anchors every gop_size
pictures and hierarchical B pictures between them, in coding order.
The intra tools (lossless, transform skip, PDPC, MIP) code on every
picture type; CCLM on I pictures (the I step's mts map carries the
scan's choices).  The stream is identical to the reference's for the same
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


def fit_weight(cur: Frame, ref: Frame) -> list[int]:
    """Least-squares explicit weighted-prediction fit [wy, oy, wc, oc]
    (denominator 64), in float64 on the host.

    The encoder fits against the reference's source frame as a proxy
    for its reconstruction; the decoder applies whatever the slice
    header says.  Falls back to identity (64, 0) when the fit is
    degenerate or near identity."""
    cy = cur.y.astype(np.float64)
    ry = ref.y.astype(np.float64)
    var = ry.var()
    if var < 1.0:
        wy, oy = 64, int(round(cy.mean() - ry.mean()))
    else:
        w = 64.0 * ((cy * ry).mean() - cy.mean() * ry.mean()) / var
        wy = int(round(min(max(w, 16.0), 192.0)))
        oy = int(round(cy.mean() - wy * ry.mean() / 64.0))
    oy = min(max(oy, -128), 127)
    mc = (cur.cb.astype(np.float64).mean()
          + cur.cr.astype(np.float64).mean()) / 2.0
    mr = (ref.cb.astype(np.float64).mean()
          + ref.cr.astype(np.float64).mean()) / 2.0
    oc = min(max(int(round(mc - mr)), -128), 127)
    if abs(wy - 64) <= 1 and abs(oy) <= 1:
        wy, oy = 64, 0
    if abs(oc) <= 1:
        oc = 0
    return [wy, oy, 64, oc]


def check_config(cfg: CodecConfig) -> None:
    """Raise NotImplementedError for anything outside the port's slices:
    all-intra, low-delay P, low-delay GPB (multi_ref) or random access
    (gop_size > 1), one tile, 8-bit, CU <= 32, tools limited to MTS,
    RDOQ, reference substitution, merge candidates, AMVP, signalled
    reference lists, weighted prediction, deblock, SAO, ALF (linear or
    nonlinear, chroma, CC-ALF), lossless, transform skip, PDPC, MIP,
    sign-data hiding, dependent quantization, MTT, LFNST and CCLM (on I
    pictures; CodecConfig refuses it with MTT); the encoder and the
    decoder take the same configs."""
    if cfg.num_tiles != 1:
        raise NotImplementedError("tiles are not in the port's slices")
    check_slice(cfg)


class Encoder:
    """All-intra, low-delay P, low-delay GPB or random-access encoder, on
    the card unless the caller asks for the CPU (device="cpu").

    >>> enc = Encoder(preset_cfg3(1920, 1080))
    >>> result = enc.encode(frames)
    """

    def __init__(self, cfg: CodecConfig, device="cuda",
                 with_recon: bool = True, batch_frames: int = 1,
                 rate_control=None):
        """rate_control: a controller of utils.ratecontrol
        (make_controller or make_lambda_controller; its qp attribute and
        update(bits)), for a low-delay or all-intra stream coded picture
        by picture, each at the controller's QP; None: cfg.qp."""
        check_config(cfg)
        self.cfg = cfg
        self.device = devmod.resolve(device)
        self.with_recon = with_recon
        self.batch_frames = max(1, batch_frames)
        self.rate_control = rate_control
        self.tab = tables.from_reference(cfg, self.device)
        self.qp_steps = {}      # qp -> (config, (I step, P step))
        self.steps_at(cfg.qp)
        self.b_steps = {}       # (qp, is_ref) -> B step
        if cfg.multi_ref:
            # GPB's B pictures code at the config's QP and are all
            # referenced
            self.gpb_step = fused.make_encode_step_b(cfg, self.tab,
                                                     with_recon)

    def encode(self, frames: list[Frame]) -> EncodeResult:
        cfg = self.cfg
        for frame in frames:
            if (frame.height, frame.width) != (cfg.height, cfg.width):
                raise ValueError("frame size does not match config")
        out = [write_nal(NalType.VPS, headers.write_vps(cfg)),
               write_nal(NalType.SPS, headers.write_sps(cfg)),
               write_nal(NalType.PPS, headers.write_pps(cfg))]
        if self.rate_control is not None:
            # the reference's own limits (x266_tpu/api/encoder.py:179-181,
            # 319-320)
            if cfg.gop_size > 1:
                raise ValueError("rate control supports low-delay in v1")
            if cfg.multi_ref:
                raise ValueError("rate control + multi_ref is not "
                                 "supported in v1")
        if cfg.intra_period != 1 or self.rate_control is not None:
            if cfg.gop_size > 1:
                return self._encode_ra(frames, out)
            if cfg.multi_ref:
                return self._encode_gpb(frames, out)
            return self._encode_gop(frames, out)
        bf = self.batch_frames
        step = self.steps_at(cfg.qp)[1][0]
        fins = [tiles_compute_batched_async(cfg, step,
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

    @staticmethod
    def _drainer(res: EncodeResult, out: list[bytes], pending: list):
        """drain(): finalize the oldest pending picture (fin, NAL type)
        and append its NAL, recon, bits and SSE."""
        def drain():
            fin, nal_type = pending.pop(0)
            rbsp, recon, sse, sse_exact = fin()
            nal = write_nal(nal_type, rbsp)
            out.append(nal)
            if recon is not None:
                res.recon.append(recon)
            res.frame_bits.append(8 * len(nal))
            res.sse.append(sse)
            res.sse_exact.append(sse_exact)

        return drain

    def _encode_gop(self, frames: list[Frame],
                    out: list[bytes]) -> EncodeResult:
        """Low-delay stream: IDR every intra_period frames, P pictures
        between, each weighted against the previous source frame with
        cfg.weighted_pred.  Without rate control frame i+1 is dispatched
        before frame i is finalized; with it (an all-intra stream
        included) each picture codes at the controller's QP, which the
        slice header carries and lambda follows, and its NAL's bits
        update the controller before the next picture is dispatched."""
        cfg, rc = self.cfg, self.rate_control
        res = EncodeResult(b"", [])
        pending = []
        drain = self._drainer(res, out, pending)
        pyramids = None
        for poc, frame in enumerate(frames):
            qc, steps = self.steps_at(cfg.qp if rc is None else rc.qp)
            wp = (fit_weight(frame, frames[poc - 1])
                  if (cfg.weighted_pred and poc % cfg.intra_period)
                  else None)
            fin, pyramids, st = encode_picture_gop_async(
                qc, steps, frame, poc, pyramids, self.device,
                ref_poc=poc - 1, wp=wp)
            pending.append((fin, NalType.IDR if st == SliceType.I
                            else NalType.TRAIL))
            while len(pending) > (1 if rc is None else 0):
                drain()
                if rc is not None:
                    rc.update(res.frame_bits[-1])
        while pending:
            drain()
        res.bitstream = b"".join(out)
        return res

    def steps_at(self, qp: int):
        """(config, (I step, P step)) at QP qp: made once per QP and
        reused, the kernels built once for all of them.  An all-intra
        stream's I step builds no pyramids and it has no P step."""
        if qp not in self.qp_steps:
            qc = self.cfg.replace(qp=qp)
            lowdelay = qc.intra_period != 1
            self.qp_steps[qp] = (qc, (
                fused.make_encode_step_i(qc, self.tab, self.with_recon,
                                         lowdelay),
                fused.make_encode_step_p(qc, self.tab, self.with_recon)
                if lowdelay else None))
        return self.qp_steps[qp]

    def _encode_gpb(self, frames: list[Frame],
                    out: list[bytes]) -> EncodeResult:
        """Low-delay GPB stream (cfg.multi_ref): IDR every intra_period
        frames; the first picture after an IDR is a P picture on it, and
        every later one a B slice on two past pictures at cfg.qp.  The
        DPB holds the newest 2 pictures, or 4 with cfg.rpl: without
        reference lists L0 and L1 are the previous two pictures (the
        decoder derives them), with them the two of the DPB whose
        sources are nearest the current frame by decimated SAD, which
        the slice header signals.  Pipelined as _encode_gop."""
        cfg = self.cfg
        _, steps = self.steps_at(cfg.qp)
        res = EncodeResult(b"", [])
        pending = []
        drain = self._drainer(res, out, pending)
        dpb_n = 4 if cfg.rpl else 2
        refs: list[tuple] = []          # [(poc, pyramids)], newest last

        def pick_refs(frame):
            if not cfg.rpl or len(refs) == 2:
                return refs[-1], refs[-2]
            cur = frame.y[::4, ::4].astype(np.int32)
            scored = sorted(
                refs, key=lambda e: int(np.abs(
                    frames[e[0]].y[::4, ::4].astype(np.int32)
                    - cur).sum()))
            return scored[0], scored[1]

        for poc, frame in enumerate(frames):
            if poc % cfg.intra_period == 0:
                fin, pyr, _ = encode_picture_gop_async(
                    cfg, steps, frame, poc, None, self.device)
                refs = [(poc, pyr)]
                nal_type = NalType.IDR
            elif len(refs) < 2:
                wp = (fit_weight(frame, frames[poc - 1])
                      if cfg.weighted_pred else None)
                fin, pyr, _ = encode_picture_gop_async(
                    cfg, steps, frame, poc, refs[-1][1], self.device,
                    ref_poc=refs[-1][0], wp=wp)
                refs.append((poc, pyr))
                nal_type = NalType.TRAIL
            else:
                (p0, r0), (p1, r1) = pick_refs(frame)
                wp = ([fit_weight(frame, frames[p0]),
                       fit_weight(frame, frames[p1])]
                      if cfg.weighted_pred else None)
                fin, pyr = encode_picture_b_async(
                    cfg, self.gpb_step, frame, poc, r0, r1, self.device,
                    ref_pocs=[[p0], [p1]], wp=wp)
                refs = (refs + [(poc, pyr)])[-dpb_n:]
                nal_type = NalType.TRAIL
            pending.append((fin, nal_type))
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
        are never referenced and build none.  With cfg.weighted_pred a
        P anchor is weighted against its reference's source frame and a
        B picture against L0's and L1's.  The next picture is
        dispatched before the last one is finalized."""
        cfg = self.cfg
        _, steps = self.steps_at(cfg.qp)
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
                wp = ([fit_weight(frames[poc], frames[l0]),
                       fit_weight(frames[poc], frames[l1])]
                      if cfg.weighted_pred else None)
                fin, pyr = encode_picture_b_async(
                    bc, step, frames[poc], poc, dpb[l0], dpb[l1],
                    self.device, ref_pocs=[[l0], [l1]], wp=wp)
                nal_type = NalType.TRAIL
            else:
                rpoc = (None if kind == "I"
                        else max(p for p in dpb if p < poc))
                wp = (fit_weight(frames[poc], frames[rpoc])
                      if (cfg.weighted_pred and rpoc is not None)
                      else None)
                fin, pyr, st = encode_picture_gop_async(
                    cfg, steps, frames[poc], poc,
                    None if rpoc is None else dpb[rpoc], self.device,
                    ref_poc=rpoc, wp=wp)
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
