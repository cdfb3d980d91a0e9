"""Decoder front-end: bytestream -> pictures, for I, P and B slices.

Counterpart of x266_tpu/api/decoder.py restricted to the port's slices:
VPS, SPS, PPS, I slices, P slices, random-access B slices and low-delay
GPB B slices, with deblock, SAO, ALF (nonlinear and CC-ALF included)
and weighted prediction.  The DPB holds device pyramids.  A P slice
references the POC its reference list names, else the latest picture
before it; a B slice takes the slice header's reference lists when
signalled, else L0 = the nearest POC below and L1 = the nearest above,
or, when no picture lies above (GPB), the second-nearest below.  Leaf B
pictures of random access (odd POC, L1 above) are never referenced and
build no pyramids, and each anchor evicts the pyramids older than the
previous anchor; a low-delay stream keeps the newest picture, the newest
two with multi_ref, or four with multi_ref and signalled lists.
Pictures come out in POC order.  Tiles and any other SPS flag outside
the slices raise NotImplementedError.
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


def _ref(dpb: dict, sh, poc) -> tuple:
    if poc not in dpb:
        raise ValueError(f"{sh.slice_type.name} slice at POC {sh.poc} "
                         f"references POC {poc}, which is not in the DPB")
    return dpb[poc]


def _references(dpb: dict, sh):
    """An inter slice's reference pyramids and whether the picture is
    itself referenced.  P: the POC its reference list names, else the
    latest picture before it.  B: the POCs its lists name, else the
    nearest below (L0) and above (L1), or with no picture above (GPB)
    the second-nearest below.  A B picture with an L1 above it is
    referenced at even POCs only (the hierarchy's leaves are odd); a GPB
    picture, whose references are both past, always."""
    if sh.slice_type == SliceType.P:
        poc = (sh.poc - sh.rpl[0][0] if sh.rpl is not None
               else max((p for p in dpb if p < sh.poc), default=None))
        return _ref(dpb, sh, poc), True
    if sh.rpl is not None:
        l0, l1 = sh.poc - sh.rpl[0][0], sh.poc - sh.rpl[1][0]
    else:
        below = sorted(p for p in dpb if p < sh.poc)
        l0 = below[-1] if below else None
        l1 = min((p for p in dpb if p > sh.poc), default=None)
        if l1 is None and len(below) > 1:
            l1 = below[-2]
    is_ref = sh.poc % 2 == 0 if (l1 is not None and l1 > sh.poc) else True
    return (_ref(dpb, sh, l0), _ref(dpb, sh, l1)), is_ref


class Decoder:
    """Decodes on the card unless the caller asks for the CPU."""

    def __init__(self, device="cuda"):
        self.device = devmod.resolve(device)

    def decode(self, stream: bytes) -> tuple[CodecConfig, list[Frame]]:
        cfg: CodecConfig | None = None
        qp: int | None = None
        tab = None
        steps = {}                      # slice qp -> decode steps (I, P, B)
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
                use = cfg if sh.qp == cfg.qp else cfg.replace(qp=sh.qp)
                if sh.qp not in steps:
                    steps[sh.qp] = (fused.make_decode_step_i(use, tab),
                                    recon_inter_pass(use, tab, encode=False),
                                    recon_inter_pass(use, tab, encode=False,
                                                     b_mode=True))
                ref, is_ref = ((None, True) if sh.slice_type == SliceType.I
                               else _references(dpb, sh))
                # pyramids only where an inter picture can follow
                frames[sh.poc], pyr = decode_picture_gop(
                    use, steps[sh.qp], sh, rbsp[off:], ref, self.device,
                    with_pyramids=is_ref and (use.intra_period != 1
                                              or use.gop_size > 1))
                if pyr is None:
                    continue
                if cfg.gop_size > 1:
                    dpb[sh.poc] = pyr
                    if sh.slice_type != SliceType.B and sh.poc > 0:
                        # a new span: pyramids older than the previous
                        # anchor are no longer referenced
                        for p in [p for p in dpb
                                  if p < sh.poc - cfg.gop_size]:
                            del dpb[p]
                else:
                    # low-delay: the newest picture stays referenceable,
                    # GPB the newest two, with signalled lists four
                    dpb[sh.poc] = pyr
                    n_keep = (4 if (cfg.rpl and cfg.multi_ref)
                              else 2 if cfg.multi_ref else 1)
                    dpb = {p: dpb[p] for p in sorted(dpb)[-n_keep:]}
            elif nal_type == NalType.EOS:
                break
        if cfg is None:
            raise ValueError("no SPS in stream")
        return cfg, [frames[p] for p in sorted(frames)]
