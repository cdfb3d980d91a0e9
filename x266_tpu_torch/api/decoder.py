"""Decoder front-end: bytestream -> pictures, for I slices.

Counterpart of x266_tpu/api/decoder.py restricted to the port's first
slice: VPS, SPS, PPS and IDR I slices.  P and B slices, and any SPS flag
outside the slice, raise NotImplementedError.
"""

from __future__ import annotations

from x266_tpu.config import CodecConfig, SliceType
from x266_tpu.core import headers
from x266_tpu.core.nal import NalType, split_nals
from x266_tpu.core.yuv import Frame

from x266_tpu_torch import device as devmod
from x266_tpu_torch import tables
from x266_tpu_torch.api.encoder import check_config
from x266_tpu_torch.engine import fused
from x266_tpu_torch.engine.picture import decode_picture


class Decoder:
    def __init__(self, device):
        self.device = devmod.resolve(device)

    def decode(self, stream: bytes) -> tuple[CodecConfig, list[Frame]]:
        cfg: CodecConfig | None = None
        qp: int | None = None
        tab = None
        steps = {}                      # slice qp -> decode step
        frames: dict[int, Frame] = {}
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
                if sh.slice_type != SliceType.I:
                    raise NotImplementedError(
                        f"{sh.slice_type.name} slices are not in the "
                        "port's first slice")
                use = cfg if sh.qp == cfg.qp else cfg.replace(qp=sh.qp)
                if sh.qp not in steps:
                    steps[sh.qp] = fused.make_decode_step_i(use, tab)
                frames[sh.poc] = decode_picture(use, steps[sh.qp], sh,
                                                rbsp[off:], self.device)
            elif nal_type == NalType.EOS:
                break
        if cfg is None:
            raise ValueError("no SPS in stream")
        return cfg, [frames[p] for p in sorted(frames)]
