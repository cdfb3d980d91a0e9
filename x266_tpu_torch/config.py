"""Codec configuration (SURVEY.md §5 "Config / flag system").

Every tool flag maps 1:1 to an SPS flag (see ``core/headers.py``) so the
config <-> bitstream capability surface is auditable, mirroring how HEVC/VVC
SPS tool flags gate the toolset [STD].  Presets correspond to the five
driver milestone configs (BASELINE.json:6-12).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from enum import IntEnum


class Profile(IntEnum):
    """Bitstream profile.

    HEVC_SUBSET: HEVC-class toolset (35 intra modes, DCT-II/DST-VII,
        quadtree CUs) — the reference C model's scope (SURVEY.md §0.2).
    VVC: adds MTS (DST-VII/DCT-VIII), 67 intra modes, MTT partitioning
        (staged across milestones M2+).
    """

    HEVC_SUBSET = 0
    VVC = 1


class SliceType(IntEnum):
    I = 0
    P = 1
    B = 2


@dataclass(frozen=True)
class CodecConfig:
    """Static configuration for one encode/decode session.

    All fields that affect the bitstream are serialized into the SPS/PPS; a
    decoder reconstructs an identical ``CodecConfig`` from the headers.
    """

    width: int
    height: int
    bit_depth: int = 8
    profile: Profile = Profile.HEVC_SUBSET

    # Partitioning (SURVEY.md §2.1 C5). v1: quadtree, CTU 64, CU sizes
    # {8,16,32}; the 64->32 split is implicit (no flag) while max_cu_size=32.
    ctu_size: int = 64
    min_cu_size: int = 8
    max_cu_size: int = 32

    # Rate / quality (C17). Fixed QP in v1.
    qp: int = 32

    # GOP structure (C16). intra_period=1 => all-intra.
    intra_period: int = 1
    gop_size: int = 1

    # Tool flags (each maps to an SPS flag).
    lossless: bool = False          # transquant bypass, whole stream (C11)
    deblock: bool = False           # C13
    sao: bool = False               # C14 (luma)
    sao_chroma: bool = False        # C14 chroma planes (requires sao)
    alf: bool = False               # C15 (VVC, luma)
    alf_chroma: bool = False        # C15 chroma 5x5 diamond (requires alf)
    # C15 nonlinear ALF: geometric transposes (derived per 4x4 block, no
    # signalling) + per-class clip level (2 bits each in the slice
    # header) applied to every neighbor difference; chroma gets one
    # plane-global clip level.  Requires alf.
    alf_nonlinear: bool = False
    # C15 CC-ALF: per-plane chroma correction from collocated SAO-stage
    # luma (7-tap diamond, slice-header coefficients + per-CTB flags).
    ccalf: bool = False             # requires alf
    mts: bool = False               # C10 VVC MTS (requires profile=VVC)
    # C10 transform skip: per-TU flag (luma) coding the residual in the
    # spatial domain (scaled by 2^transform_shift); selected by the
    # encoder's transform-select stage alongside the MTS candidates.
    transform_skip: bool = False
    # C6 VVC PDPC: position-dependent blend of the intra prediction with
    # the unfiltered references for planar/DC/H/V on luma (FORMAT.md §8).
    pdpc: bool = False              # requires profile=VVC
    # C6 reference-sample substitution [STD, HEVC 8.4.4.2.2-shaped]:
    # unavailable intra reference samples take the nearest available
    # sample along the substitution scan (left bottom->top, corner,
    # top left->right) instead of the x266t constant mid-gray rule.
    # NORMATIVE (in the SPS).  Round-4 falsification showed mid-gray
    # references are what made the PDPC blend RD-negative; this flag
    # removes the FORMAT.md §9.2 deviation.  Runs on the XLA recon
    # path (the Pallas Pass-B kernel falls back, as 10-bit does).
    ref_substitute: bool = False
    # C11 RDOQ (encoder-only, NOT in the SPS — the quantizer is
    # non-normative [STD]): per-coefficient D + lambda*R level decision
    # (kernels.quant.rd_quantize) instead of the fixed deadzone.
    rdoq: bool = False
    # C11 dependent quantization (VVC-shaped): two offset scalar
    # quantizers switched by a 4-state parity machine over the TU's
    # coding order; levels code identically, only quant/dequant change.
    # Normative (in the SPS).  TPU-first: the state machine runs as an
    # associative scan (kernels.quant.dq_quantize/dq_dequantize);
    # encoder choice is greedy per state, not the full trellis.  Runs
    # on the XLA recon path (Pallas Pass-B falls back, as 10-bit does).
    dep_quant: bool = False
    # C11 sign-data hiding [STD-shaped]: per 4x4 coefficient group with
    # first/last significant scan positions >= 4 apart, the sign of the
    # first significant coefficient is not coded; the decoder infers it
    # from the parity of the CG's absolute-level sum (odd = negative).
    # The encoder enforces the parity in the quantization stage
    # (kernels.quant.sdh_adjust).  Normative: in the SPS.  Runs on the
    # XLA recon path (the Pallas Pass-B kernel falls back, as 10-bit
    # does).
    sign_data_hiding: bool = False
    # C7 merge candidate list: skip CUs signal merge_idx over the
    # 2-candidate list {derived (left-first), above} (FORMAT.md §7).
    merge_cands: bool = False
    # C7 AMVP + merge-with-residual (round-4): non-skip inter CUs code
    # merge_flag (MV == a merge candidate, no MVD, residual follows)
    # and otherwise an amvp_idx selecting which of the two candidates
    # predicts the MVD.  ENTROPY-ONLY: the reconstruction path and MV
    # maps are unchanged — the device step never sees this flag (the
    # TPU-first place for MV-coding decisions is the host walker).
    amvp: bool = False
    # C7 explicit weighted prediction: per inter slice and reference
    # list, luma (weight, offset) + shared chroma (weight, offset) in
    # the slice header (denominator 64).  TPU-first: the weights apply
    # ONCE to the whole reference pyramid (elementwise reweight before
    # ME/MC), so prediction, warp kernels and recon are unchanged —
    # both sides reweight identically, so decode stays bit-exact.
    weighted_pred: bool = False
    # C6 CCLM: intra chroma prediction from the collocated reconstructed
    # luma via a per-TU linear model (SPS-level: applies to every intra
    # CU's chroma; requires profile=VVC; FORMAT.md §7).
    cclm: bool = False
    # C5 MTT: after the quadtree, a 16/32 leaf may binary-split into two
    # rectangular CUs (BT-H: two s/2 x s, BT-V: two s x s/2), each with
    # its own intra mode; the residual tiles as two square s/2 TUs
    # predicted sequentially from reconstructed neighbors (HEVC-RQT /
    # ISP-shaped).  Intra CUs only in v1 (P/B slices infer no-split).
    mtt: bool = False               # requires profile=VVC
    # C10 LFNST: per-TU secondary non-separable transform on the DCT2
    # low 4x4 band, lfnst_idx in {0,1,2}; kernels are KLTs trained on
    # this codec's own statistics (tools/train_lfnst.py).  Intra luma
    # TUs of I slices in v1.
    lfnst: bool = False             # requires profile=VVC
    # C16 multi-reference (low-delay GPB): non-anchor pictures code as
    # B slices whose L0 = previous picture and L1 = the one before it
    # (both past), giving two references + bi averaging to the whole
    # low-delay chain.  Requires intra_period > 1 and gop_size == 1.
    multi_ref: bool = False
    # C6 MIP (matrix intra prediction): 8 machine-trained integer
    # matrices per TU size predicting the block from downsampled
    # boundary sums (specmodel/mip_tables.py), competing with the 67
    # analytic modes in Pass A as extra rows of the same MXU matmul.
    # Luma only; chroma collocated with a MIP CU predicts planar.
    mip: bool = False               # requires profile=VVC
    # C16/C2 signalled reference picture lists (round-5): inter slice
    # headers carry their active reference POCs (as POC deltas) instead
    # of the decoder deriving lists from decode history — the HEVC
    # RPS / VVC RPL analog, required for loss/splice robustness and
    # for adaptive reference selection (the encoder keeps a 4-entry
    # DPB and may pick any signalled subset; api.encoder selects the
    # best 2 by decimated SAD in the low-delay GPB mode).
    rpl: bool = False
    # P6 WPP context inheritance (round-5): each entropy segment
    # after a tile's first initializes its adaptive contexts from a
    # SNAPSHOT of the previous segment's states taken after that
    # segment's first min(2, ctus_x) CTUs — the standard's WPP answer
    # to the fresh-context cost (trained init recovered it to +3..5%
    # at rows_per_segment=1; inheritance removes most of the rest).
    # Normative (in the SPS): the decoder chains identically.
    ctx_inherit: bool = False
    # C3 "context init tables per slice type": every entropy segment
    # starts its adaptive contexts from trained per-slice-type tables
    # (cabac/ctx_init.py) instead of p=0.5 — recovers most of the
    # fresh-context cost of wavefront segments (measured +5..9% bits at
    # rows_per_segment=1 without it).
    ctx_init: bool = True

    # Entropy segmentation (SURVEY.md §2.2 P6): number of CABAC segments per
    # picture; segment i covers CTU rows [i*rows/n, (i+1)*rows/n). Entry-point
    # offsets are written in the slice header so segments decode in parallel
    # and are stitched on host (BASELINE.json:5).
    rows_per_segment: int = 0       # 0 => single segment per picture

    # Spatial tiles (SURVEY.md §2.2 P2): horizontal bands of tile_rows CTU
    # rows each, fully independent (prediction, entropy and loop filters do
    # not cross tile boundaries), so bands encode/decode concurrently on
    # separate chips with bit-identical output vs a single device.
    tile_rows: int = 0              # 0 => one tile (whole picture)

    # 2-D tile grid (SURVEY T4/P2 `tile_y x tile_x`): tile_cols CTU
    # COLUMNS per tile column; 0 => one column.  With both set, the
    # picture splits into a row-major rect grid; each rect is a fully
    # independent sub-picture exactly like a band, and inter prediction
    # reads across both edges via the 2-D halo rule (shard/halo.py).
    tile_cols: int = 0

    def __post_init__(self) -> None:
        if self.width % 8 or self.height % 8:
            raise ValueError("v1 requires width/height multiples of 8")
        if self.bit_depth not in (8, 10):
            raise ValueError("bit_depth must be 8 or 10")
        if self.ctu_size != 64:
            raise ValueError("v1 supports ctu_size=64 only")
        if self.max_cu_size not in (8, 16, 32, 64):
            raise ValueError("max_cu_size must be 8..64")
        if self.max_cu_size == 64:
            # 64x64 CUs (64-pt DCT-II with zero-out, C10/C5 round-5):
            # all-intra VVC v1; the low 32x32 band is coded
            if self.profile != Profile.VVC:
                raise ValueError("max_cu_size=64 requires VVC profile")
            if self.intra_period != 1 or self.gop_size > 1:
                raise ValueError("max_cu_size=64 is all-intra in v1")
            for bad in ("mip", "mtt", "lossless", "dep_quant",
                        "sign_data_hiding"):
                if getattr(self, bad):
                    raise ValueError(f"max_cu_size=64 + {bad} is not "
                                     "supported in v1")
        if self.min_cu_size != 8:
            raise ValueError("v1 supports min_cu_size=8 only")
        if self.mts and self.profile != Profile.VVC:
            raise ValueError("MTS requires the VVC profile")
        if self.pdpc and self.profile != Profile.VVC:
            raise ValueError("PDPC requires the VVC profile")
        if self.cclm and self.profile != Profile.VVC:
            raise ValueError("CCLM requires the VVC profile")
        if self.mtt and self.profile != Profile.VVC:
            raise ValueError("MTT requires the VVC profile")
        if self.lfnst and self.profile != Profile.VVC:
            raise ValueError("LFNST requires the VVC profile")
        if self.mip and self.profile != Profile.VVC:
            raise ValueError("MIP requires the VVC profile")
        if self.lfnst and self.lossless:
            raise ValueError("lfnst + lossless is not supported")
        if self.dep_quant and self.profile != Profile.VVC:
            raise ValueError("dep_quant requires the VVC profile")
        if self.dep_quant and self.lossless:
            raise ValueError("dep_quant + lossless is not supported")
        if self.dep_quant and self.sign_data_hiding:
            # as in VVC: dependent quantization replaces SDH
            raise ValueError("dep_quant excludes sign_data_hiding")
        if self.weighted_pred and self.lossless:
            raise ValueError("weighted_pred + lossless is not "
                             "supported")
        if self.sign_data_hiding and self.lossless:
            # as HEVC's transquant bypass: no quantizer, no parity to
            # enforce, so the hidden sign cannot be made to match
            raise ValueError("sign_data_hiding + lossless is not "
                             "supported")
        if self.mtt and self.cclm:
            raise ValueError("mtt + cclm is not supported in v1 (the "
                             "in-scan CCLM decision is per square CU)")
        if self.mtt and self.lossless:
            raise ValueError("mtt + lossless is not supported in v1")
        if self.sao_chroma and not self.sao:
            raise ValueError("sao_chroma requires sao")
        if self.alf_chroma and not self.alf:
            raise ValueError("alf_chroma requires alf")
        if self.alf_nonlinear and not self.alf:
            raise ValueError("alf_nonlinear requires alf")
        if self.ccalf and not self.alf:
            raise ValueError("ccalf requires alf")
        if self.multi_ref and (self.intra_period == 1
                               or self.gop_size > 1):
            raise ValueError("multi_ref is the low-delay GPB mode: "
                             "needs intra_period > 1, gop_size == 1")
        if self.gop_size > 1 and (self.gop_size
                                  & (self.gop_size - 1)) != 0:
            raise ValueError("gop_size must be a power of two (the "
                             "leaf-B rule relies on it)")

    # ---- derived geometry -------------------------------------------------

    @property
    def ctus_x(self) -> int:
        return -(-self.width // self.ctu_size)

    @property
    def ctus_y(self) -> int:
        return -(-self.height // self.ctu_size)

    @property
    def units_x(self) -> int:
        """Picture width in 8x8 minimum-CU units."""
        return self.width // 8

    @property
    def units_y(self) -> int:
        return self.height // 8

    @property
    def num_segments(self) -> int:
        if self.rows_per_segment <= 0:
            return 1
        return -(-self.ctus_y // self.rows_per_segment)

    def segment_ctu_rows(self) -> list[tuple[int, int]]:
        """[start_ctu_row, end_ctu_row) per entropy segment."""
        if self.num_segments == 1:
            return [(0, self.ctus_y)]
        r = self.rows_per_segment
        return [(i * r, min((i + 1) * r, self.ctus_y))
                for i in range(self.num_segments)]

    # ---- tiles ------------------------------------------------------------

    @property
    def num_tile_rows(self) -> int:
        if self.tile_rows <= 0:
            return 1
        return -(-self.ctus_y // self.tile_rows)

    @property
    def num_tile_cols(self) -> int:
        if self.tile_cols <= 0:
            return 1
        return -(-self.ctus_x // self.tile_cols)

    @property
    def num_tiles(self) -> int:
        return self.num_tile_rows * self.num_tile_cols

    def tile_bands(self) -> list[tuple[int, int]]:
        """[start_row_px, end_row_px) of each tile band (1-D grid)."""
        if self.num_tile_rows == 1:
            return [(0, self.height)]
        h = self.tile_rows * self.ctu_size
        return [(i * h, min((i + 1) * h, self.height))
                for i in range(self.num_tile_rows)]

    def tile_col_spans(self) -> list[tuple[int, int]]:
        """[start_col_px, end_col_px) of each tile column."""
        if self.num_tile_cols == 1:
            return [(0, self.width)]
        w = self.tile_cols * self.ctu_size
        return [(j * w, min((j + 1) * w, self.width))
                for j in range(self.num_tile_cols)]

    def tile_rects(self) -> list[tuple[int, int, int, int]]:
        """[y0, y1, x0, x1) pixel rects of each tile, row-major."""
        return [(y0, y1, x0, x1)
                for (y0, y1) in self.tile_bands()
                for (x0, x1) in self.tile_col_spans()]

    def tile_cfg(self, band) -> "CodecConfig":
        """Config of one tile (band 2-tuple or rect 4-tuple) treated as
        an independent sub-picture."""
        if len(band) == 4:
            y0, y1, x0, x1 = band
            return self.replace(height=y1 - y0, width=x1 - x0,
                                tile_rows=0, tile_cols=0)
        return self.replace(height=band[1] - band[0], tile_rows=0,
                            tile_cols=0)

    @property
    def n_intra_modes(self) -> int:
        """35 (HEVC subset) or 67 (VVC) intra prediction modes (C6)."""
        return 67 if self.profile == Profile.VVC else 35

    @property
    def n_pred_modes(self) -> int:
        """Total luma mode alphabet incl. the MIP extension (C6):
        mode_map values >= n_intra_modes are MIP indices."""
        from x266_tpu_torch.specmodel.intra import MIP_K

        return self.n_intra_modes + (MIP_K if self.mip else 0)

    # ---- sample range (C2 bit_depth) ---------------------------------------

    @property
    def mid_val(self) -> int:
        """Mid-gray: the x266t unavailable-reference value (FORMAT.md §7)."""
        return 1 << (self.bit_depth - 1)

    @property
    def max_val(self) -> int:
        return (1 << self.bit_depth) - 1

    @property
    def pixel_dtype(self):
        """numpy dtype of picture samples (and the packed device I/O)."""
        import numpy as _np

        return _np.uint8 if self.bit_depth == 8 else _np.uint16

    # ---- rate-distortion --------------------------------------------------

    @property
    def lambda_mode(self) -> float:
        """RD lambda for mode decision; HM-style lambda = k*2^((QP-12)/3)
        with the all-intra k ~ 0.57 [STD, HM encoder convention]."""
        return 0.57 * math.pow(2.0, (self.qp - 12) / 3.0)

    def replace(self, **kw) -> "CodecConfig":
        return dataclasses.replace(self, **kw)


# ---- presets: the five driver milestone configs (BASELINE.json:6-12) -------

def preset_cfg1(width: int = 416, height: int = 240) -> CodecConfig:
    """Config 1: all-intra HEVC-subset, 416x240, single tile, CPU-runnable."""
    return CodecConfig(width=width, height=height,
                       profile=Profile.HEVC_SUBSET, intra_period=1,
                       rdoq=True, ref_substitute=True)


def preset_cfg2(width: int = 1920, height: int = 1080) -> CodecConfig:
    """Config 2: all-intra 1080p VVC with MTS + CABAC, one chip."""
    return CodecConfig(width=width, height=height, profile=Profile.VVC,
                       mts=True, intra_period=1, rdoq=True,
                       ref_substitute=True)


def preset_cfg2q(width: int = 1920, height: int = 1080) -> CodecConfig:
    """Config 2 QUALITY variant: cfg2 + MTT binary partitioning.

    MTT measures RD-POSITIVE (-2.35% BD-rate over 4 QPs,
    tests/bd_rates.json) but costs ~3.6x device time at 1080p on v5e
    (574 vs 158 ms unbatched; the BT pair evaluations triple the
    Pass-A work and the MTT recon scan rides the XLA path, round-4
    measurement), so the throughput preset keeps it off and this
    preset trades fps for bits.  Round-5 adds reference-sample
    substitution (-3.45% mean BD-rate on the 416x240 corpus,
    tests/bd_rates.json refsubst row; in EVERY preset now that the
    Pallas recon kernels carry the closed-form fill) and SDH."""
    return preset_cfg2(width, height).replace(mtt=True,
                                              ref_substitute=True,
                                              sign_data_hiding=True)


def preset_cfg2s(width: int = 1920, height: int = 1080) -> CodecConfig:
    """Config 2 SCREEN-CONTENT variant: transform skip (-34% BD-rate
    on the text clip, tests/bd_rates.json — but +20% on natural
    'mixed' content, which is why it is NOT in the general presets)
    + SDH + reference substitution."""
    return preset_cfg2(width, height).replace(
        transform_skip=True, sign_data_hiding=True,
        ref_substitute=True)


def preset_cfg3(width: int = 1920, height: int = 1080) -> CodecConfig:
    """Config 3: low-delay P 1080p, integer+fractional ME."""
    return CodecConfig(width=width, height=height, qp=32,
                       intra_period=32, rdoq=True,
                       ref_substitute=True)


def preset_cfg4(width: int = 3840, height: int = 2160,
                tile_rows: int = 0) -> CodecConfig:
    """Config 4: random-access GOP-16 4K with deblock/SAO/ALF
    (BASELINE.json:10).  tile_rows > 0 selects CTU tile bands for
    sharding over chips (shard.tiled_gop); ALF runs band-locally with
    per-band filter sets in the slice header, so the FULL filter chain
    composes with tiles (round-4)."""
    return CodecConfig(width=width, height=height, qp=32,
                       intra_period=32, gop_size=16, deblock=True,
                       sao=True, sao_chroma=True, alf=True,
                       alf_chroma=True, rdoq=True,
                       ref_substitute=True, tile_rows=tile_rows)


def preset_cfg5(width: int = 3840, height: int = 2160) -> CodecConfig:
    """Config 5 (single-host form): GOPs scheduled over local devices
    with wavefront entropy segments; multi-host DCN is round 2."""
    return CodecConfig(width=width, height=height, qp=32,
                       intra_period=16, deblock=True, sao=True,
                       sao_chroma=True, rows_per_segment=1, rdoq=True,
                       ctx_inherit=True, ref_substitute=True)
