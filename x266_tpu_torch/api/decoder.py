"""Decoder front-end: bytestream -> pictures, for I and P slices.

Counterpart of x266_tpu/api/decoder.py restricted to the port's slices:
VPS, SPS, PPS, I slices and low-delay P slices, which reference the
previous picture through a one-entry DPB of device pyramids (the slice
header's reference list when signalled).  B slices, and any SPS flag
outside the slices, raise NotImplementedError.
"""

from __future__ import annotations

from x266_tpu_torch.config import CodecConfig, SliceType
from x266_tpu_torch.core import headers
from x266_tpu_torch.core.nal import NalType, split_nals
from x266_tpu_torch.core.yuv import Frame

from x266_tpu_torch import device as devmod
from x266_tpu_torch import tables
from x266_tpu_torch.api.encoder import check_config
from x266_tpu_torch.engine import fused
from x266_tpu_torch.engine.inter import recon_inter_pass
from x266_tpu_torch.engine.picture import decode_picture_gop


def _reference(dpb: dict, sh) -> tuple:
    """A P slice's reference pyramids: the POC its reference list names,
    else the latest picture before it."""
    if sh.rpl is not None:
        poc = sh.poc - sh.rpl[0][0]
    else:
        poc = max((p for p in dpb if p < sh.poc), default=None)
    if poc not in dpb:
        raise ValueError(f"P slice at POC {sh.poc} references POC {poc}, "
                         "which is not in the DPB")
    return dpb[poc]


class Decoder:
    """Decodes on the card unless the caller asks for the CPU."""

    def __init__(self, device="cuda"):
        self.device = devmod.resolve(device)

    def decode(self, stream: bytes) -> tuple[CodecConfig, list[Frame]]:
        cfg: CodecConfig | None = None
        qp: int | None = None
        tab = None
        steps = {}                      # slice qp -> decode steps (I, P)
        frames: dict[int, Frame] = {}
        dpb: dict[int, tuple] = {}      # poc -> device pyramids
        vps = None
        for nal_type, rbsp in split_nals(stream):
            if nal_type == NalType.VPS:
                vps = headers.parse_vps(rbsp)
            elif nal_type == NalType.SPS:
                cfg = headers.parse_sps(rbsp)
                check_config(cfg)
                if vps is not None:
                    want = headers.PROFILE_IDS[cfg.profile]
                    if vps["profile_idc"] != want:
                        raise ValueError(
                            f"VPS profile {vps['profile_idc']} != SPS "
                            f"profile {want}")
                    if vps["level_idc"] < headers.level_for(cfg):
                        raise ValueError(
                            f"stream exceeds its signalled level "
                            f"{vps['level_idc']}")
                tab = tables.from_reference(cfg, self.device)
                steps = {}
            elif nal_type == NalType.PPS:
                qp = headers.parse_pps(rbsp)["qp"]
            elif nal_type in (NalType.IDR, NalType.TRAIL):
                if cfg is None or qp is None:
                    raise ValueError("slice before parameter sets")
                sh, off = headers.parse_slice_header(
                    rbsp, cfg.alf, cfg.ctus_y * cfg.ctus_x,
                    cfg.alf_chroma, cfg.alf_nonlinear, cfg.ccalf,
                    has_wp=cfg.weighted_pred, n_bands=cfg.num_tiles,
                    has_rpl=cfg.rpl)
                if sh.slice_type == SliceType.B:
                    raise NotImplementedError(
                        "B slices are not in the port's slices")
                use = cfg if sh.qp == cfg.qp else cfg.replace(qp=sh.qp)
                if sh.qp not in steps:
                    steps[sh.qp] = (fused.make_decode_step_i(use, tab),
                                    recon_inter_pass(use, tab, encode=False))
                ref = (_reference(dpb, sh) if sh.slice_type == SliceType.P
                       else None)
                # pyramids only where a P picture can follow
                frames[sh.poc], pyr = decode_picture_gop(
                    use, steps[sh.qp], sh, rbsp[off:], ref, self.device,
                    with_pyramids=use.intra_period != 1)
                if pyr is not None:
                    dpb = {sh.poc: pyr}         # low-delay: the latest
            elif nal_type == NalType.EOS:
                break
        if cfg is None:
            raise ValueError("no SPS in stream")
        return cfg, [frames[p] for p in sorted(frames)]
