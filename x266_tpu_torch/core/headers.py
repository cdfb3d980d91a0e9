"""Parameter sets and slice headers (SURVEY.md §2.1 C2) [STD-shaped].

The x266t bitstream carries an SPS (sequence geometry + tool flags), a PPS
(picture-level parameters), and per-picture slice headers with entropy
segment entry points (wavefront stitching, BASELINE.json:5).  The syntax is
x266t's own (the normative HEVC/VVC syntax cannot be bit-verified here —
SURVEY.md §0), but the structure mirrors the standards: every tool flag in
``CodecConfig`` round-trips through the SPS bit-exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

from x266_tpu_torch.config import CodecConfig, Profile, SliceType
from x266_tpu_torch.core.bitio import BitReader, BitWriter


PROFILE_IDS = {Profile.HEVC_SUBSET: 1, Profile.VVC: 2}

# level limits: max luma samples per picture (level id -> cap), an
# HEVC/VVC general-level analog on this format's geometry
LEVELS = [(30, 552960),     # ~480p class
          (40, 2228224),    # 1080p class
          (50, 8912896),    # 4K class
          (60, 35651584)]   # 8K class


def level_for(cfg: CodecConfig) -> int:
    samples = cfg.width * cfg.height
    for lid, cap in LEVELS:
        if samples <= cap:
            return lid
    return LEVELS[-1][0]


def write_vps(cfg: CodecConfig) -> bytes:
    """VPS (C2): profile / tier / level + layer info.  x266t streams
    are single-layer; the VPS pins the decoder capability contract
    (profile id, tier flag, level id, max DPB pictures) ahead of the
    SPS, mirroring the standards' parameter-set layering [STD]."""
    w = BitWriter()
    w.u(1, 4)                          # vps id space (single)
    w.u(PROFILE_IDS[cfg.profile], 7)   # general_profile_idc
    w.flag(False)                      # general_tier_flag (main tier)
    w.u(level_for(cfg), 8)             # general_level_idc
    w.ue(1)                            # max_layers
    w.ue(4 if cfg.rpl else 2)          # max_dpb_pictures
    w.align()
    return w.bytes_value()


def parse_vps(rbsp: bytes) -> dict:
    r = BitReader(rbsp)
    out = {"vps_id": r.u(4)}
    out["profile_idc"] = r.u(7)
    out["tier"] = bool(r.flag())
    out["level_idc"] = r.u(8)
    out["max_layers"] = r.ue()
    out["max_dpb_pictures"] = r.ue()
    return out


def write_sps(cfg: CodecConfig) -> bytes:
    w = BitWriter()
    w.u(int(cfg.profile), 8)
    w.ue(cfg.width // 8)
    w.ue(cfg.height // 8)
    w.ue(cfg.bit_depth - 8)
    w.ue({64: 0}[cfg.ctu_size])
    w.ue({8: 0, 16: 1, 32: 2, 64: 3}[cfg.max_cu_size])
    w.flag(cfg.lossless)
    w.flag(cfg.deblock)
    w.flag(cfg.sao)
    w.flag(cfg.sao_chroma)
    w.flag(cfg.alf)
    w.flag(cfg.alf_chroma)
    w.flag(cfg.alf_nonlinear)
    w.flag(cfg.ccalf)
    w.flag(cfg.mts)
    w.flag(cfg.transform_skip)
    w.flag(cfg.pdpc)
    w.flag(cfg.ref_substitute)
    w.flag(cfg.merge_cands)
    w.flag(cfg.cclm)
    w.flag(cfg.mtt)
    w.flag(cfg.lfnst)
    w.flag(cfg.mip)
    w.flag(cfg.multi_ref)
    w.flag(cfg.ctx_init)
    w.flag(cfg.sign_data_hiding)
    w.flag(cfg.dep_quant)
    w.flag(cfg.weighted_pred)
    w.flag(cfg.amvp)
    w.flag(cfg.rpl)
    w.flag(cfg.ctx_inherit)
    w.ue(cfg.rows_per_segment)
    w.ue(cfg.tile_rows)
    w.ue(cfg.tile_cols)
    w.ue(cfg.intra_period - 1)
    w.ue(cfg.gop_size - 1)
    w.align()
    return w.bytes_value()


def parse_sps(rbsp: bytes) -> CodecConfig:
    r = BitReader(rbsp)
    profile = Profile(r.u(8))
    width = r.ue() * 8
    height = r.ue() * 8
    bit_depth = r.ue() + 8
    ctu_size = {0: 64}[r.ue()]
    max_cu = {0: 8, 1: 16, 2: 32, 3: 64}[r.ue()]
    lossless = r.flag()
    deblock = r.flag()
    sao = r.flag()
    sao_chroma = r.flag()
    alf = r.flag()
    alf_chroma = r.flag()
    alf_nonlinear = r.flag()
    ccalf = r.flag()
    mts = r.flag()
    transform_skip = r.flag()
    pdpc = r.flag()
    ref_substitute = r.flag()
    merge_cands = r.flag()
    cclm = r.flag()
    mtt = r.flag()
    lfnst = r.flag()
    mip = r.flag()
    multi_ref = r.flag()
    ctx_init = r.flag()
    sign_data_hiding = r.flag()
    dep_quant = r.flag()
    weighted_pred = r.flag()
    amvp = r.flag()
    rpl = r.flag()
    ctx_inherit = r.flag()
    rows_per_segment = r.ue()
    tile_rows = r.ue()
    tile_cols = r.ue()
    intra_period = r.ue() + 1
    gop_size = r.ue() + 1
    r.align()
    return CodecConfig(width=width, height=height, bit_depth=bit_depth,
                       profile=profile, ctu_size=ctu_size,
                       max_cu_size=max_cu, lossless=lossless,
                       deblock=deblock, sao=sao, sao_chroma=sao_chroma,
                       alf=alf, alf_chroma=alf_chroma,
                       alf_nonlinear=alf_nonlinear, ccalf=ccalf, mts=mts,
                       transform_skip=transform_skip,
                       pdpc=pdpc, ref_substitute=ref_substitute,
                       merge_cands=merge_cands,
                       cclm=cclm, mtt=mtt, lfnst=lfnst, mip=mip,
                       multi_ref=multi_ref, ctx_init=ctx_init,
                       sign_data_hiding=sign_data_hiding,
                       dep_quant=dep_quant,
                       weighted_pred=weighted_pred, amvp=amvp,
                       rpl=rpl, ctx_inherit=ctx_inherit,
                       rows_per_segment=rows_per_segment,
                       tile_rows=tile_rows, tile_cols=tile_cols,
                       intra_period=intra_period,
                       gop_size=gop_size)


def write_pps(cfg: CodecConfig) -> bytes:
    w = BitWriter()
    w.ue(cfg.qp)
    w.align()
    return w.bytes_value()


def parse_pps(rbsp: bytes) -> dict:
    r = BitReader(rbsp)
    qp = r.ue()
    r.align()
    return {"qp": qp}


@dataclass
class SliceHeader:
    slice_type: SliceType
    poc: int
    qp: int
    # Byte offsets (within the slice payload, after the header) where each
    # entropy segment after the first begins — the WPP entry-point analog
    # [STD], enabling host-side stitching of independently coded segments.
    entry_points: list[int]
    # ALF (C15) picture parameters, present iff SPS alf flag: PER TILE
    # BAND (loop filters do not cross tile boundaries, so each band
    # derives and signals its own filter set — the APS-per-tile analog;
    # x266t carries these in the slice header instead of an APS), each
    # band contributing 25 classes x 12 diamond-pair coefficients
    # (se(v)) and its CTBs' on/off bits.  Lists are band-major
    # concatenations; with one band this is the flat per-picture layout.
    alf_coeffs: list[int] | None = None       # n_bands * 300 ints
    alf_flags: list[int] | None = None        # sum(band ctbs) bits
    # chroma ALF (iff SPS alf_chroma): per band, 2 planes x 6
    # diamond-pair coefficients (se(v)) + per-plane per-CTB bits.
    alf_ccoeffs: list[int] | None = None      # n_bands * 12 ints
    alf_cflags: list[int] | None = None       # band-major [b][2][ctb_b]
    # nonlinear ALF (iff SPS alf_nonlinear): per band, per-class 2-bit
    # clip level (u(2)) and, iff alf_chroma, one level per chroma plane.
    alf_clips: list[int] | None = None        # n_bands * 25 in 0..3
    alf_cclips: list[int] | None = None       # n_bands * 2 in 0..3
    # CC-ALF (iff SPS ccalf): per band, 2 planes x 7 diamond
    # coefficients (se(v)) + per-plane per-CTB bits.
    ccalf_coeffs: list[int] | None = None     # n_bands * 14 ints
    ccalf_flags: list[int] | None = None      # band-major [b][2][ctb_b]
    # weighted prediction (C7, iff SPS weighted_pred and inter slice):
    # per reference list [w_luma, o_luma, w_chroma, o_chroma], denom 64
    # (4 ints for P, 8 for B)
    wp: list[int] | None = None
    # signalled reference picture lists (C16, iff SPS rpl and inter
    # slice; round-5): per list, the active references as POC deltas
    # (this POC - ref POC; negative = future, RA L1).  [[L0], [L1]]
    # for B, [[L0]] for P.  A per-slice presence flag lets encode
    # paths that have not plumbed ref POCs fall back to the legacy
    # decode-history derivation.
    rpl: list[list[int]] | None = None
    # writer-side: SPS rpl is on and this is an inter slice, so the
    # presence flag must be emitted even when rpl is None (legacy path)
    rpl_expected: bool = False


def write_slice_header(sh: SliceHeader) -> bytes:
    w = BitWriter()
    w.ue(int(sh.slice_type))
    w.ue(sh.poc)
    w.se(sh.qp - 26)
    w.ue(len(sh.entry_points))
    for off in sh.entry_points:
        w.ue(off)
    if sh.alf_coeffs is not None:
        for c in sh.alf_coeffs:
            w.se(int(c))
        for f in sh.alf_flags:
            w.flag(int(f))
        if sh.alf_clips is not None:
            for c in sh.alf_clips:
                w.u(int(c), 2)
    if sh.alf_ccoeffs is not None:
        for c in sh.alf_ccoeffs:
            w.se(int(c))
        for f in sh.alf_cflags:
            w.flag(int(f))
        if sh.alf_cclips is not None:
            for c in sh.alf_cclips:
                w.u(int(c), 2)
    if sh.ccalf_coeffs is not None:
        for c in sh.ccalf_coeffs:
            w.se(int(c))
        for f in sh.ccalf_flags:
            w.flag(int(f))
    if sh.wp is not None:
        for i, v in enumerate(sh.wp):
            w.se(int(v) - (64 if i % 2 == 0 else 0))
    if sh.rpl is not None:
        w.flag(True)
        for lst in sh.rpl:
            w.ue(len(lst))
            for d in lst:
                w.se(int(d))
    elif sh.rpl_expected:
        w.flag(False)
    w.align()
    return w.bytes_value()


def parse_slice_header(rbsp: bytes, has_alf: bool = False,
                       num_ctbs: int = 0,
                       has_alf_chroma: bool = False,
                       has_alf_nonlinear: bool = False,
                       has_ccalf: bool = False,
                       has_wp: bool = False,
                       n_bands: int = 1,
                       has_rpl: bool = False
                       ) -> tuple[SliceHeader, int]:
    """Returns (header, payload_byte_offset_within_rbsp).

    num_ctbs is the TOTAL CTB count over the picture; n_bands the tile
    band count (each band signals its own ALF set — flag fields already
    total num_ctbs per plane, so only the per-band-constant fields
    scale with n_bands)."""
    r = BitReader(rbsp)
    st = SliceType(r.ue())
    poc = r.ue()
    qp = r.se() + 26
    n = r.ue()
    entries = [r.ue() for _ in range(n)]
    alf_coeffs = alf_flags = alf_ccoeffs = alf_cflags = None
    alf_clips = alf_cclips = ccalf_coeffs = ccalf_flags = None
    if has_alf:
        alf_coeffs = [r.se() for _ in range(25 * 12 * n_bands)]
        alf_flags = [int(r.flag()) for _ in range(num_ctbs)]
        if has_alf_nonlinear:
            alf_clips = [r.u(2) for _ in range(25 * n_bands)]
    if has_alf_chroma:
        alf_ccoeffs = [r.se() for _ in range(2 * 6 * n_bands)]
        alf_cflags = [int(r.flag()) for _ in range(2 * num_ctbs)]
        if has_alf_nonlinear:
            alf_cclips = [r.u(2) for _ in range(2 * n_bands)]
    if has_ccalf:
        ccalf_coeffs = [r.se() for _ in range(2 * 7 * n_bands)]
        ccalf_flags = [int(r.flag()) for _ in range(2 * num_ctbs)]
    wp = None
    if has_wp and st != SliceType.I:
        n_wp = 8 if st == SliceType.B else 4
        wp = [r.se() + (64 if i % 2 == 0 else 0) for i in range(n_wp)]
    rpl = None
    if has_rpl and st != SliceType.I and r.flag():
        n_lists = 2 if st == SliceType.B else 1
        rpl = [[r.se() for _ in range(r.ue())]
               for _ in range(n_lists)]
    r.align()
    return SliceHeader(st, poc, qp, entries, alf_coeffs,
                       alf_flags, alf_ccoeffs, alf_cflags,
                       alf_clips, alf_cclips, ccalf_coeffs,
                       ccalf_flags, wp, rpl), r.byte_position
