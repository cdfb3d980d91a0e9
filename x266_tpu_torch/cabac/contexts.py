"""Context registry for the x266t entropy layer (C4-analog).

Named index ranges into one flat ContextSet; encoder and decoder share
these constants, so context selection can never diverge.  Layout is
HEVC-shaped (per-syntax-element sets, size/CG/diagonal conditioning)
[STD-shaped], with counts simplified for v1.
"""

from __future__ import annotations

# -- offsets ---------------------------------------------------------------
SPLIT = 0          # 2: [size 32, size 16]
MPM_FLAG = 2       # 1
CBF_Y = 3          # 2: [size >= 16, size == 8]
CBF_C = 5          # 2: [cb, cr]
LAST_X = 7         # 20: 10 luma + 10 chroma (ctx = min(bin, 9))
LAST_Y = 27        # 20
CSBF = 47          # 4: (right|below) + 2*chroma
SIG = 51           # 18: luma 12 (min(diag,5) + 6*(cg>0)), chroma 6
GT1 = 69           # 4: luma cg0 / luma other / chroma cg0 / chroma other
GT2 = 73           # 2: luma / chroma
SAO_ON = 75        # 1: sao type != off
SAO_KIND = 76      # 1: band (1) vs edge (0)
MTS = 77           # 1: mts_idx != 0 (VVC MTS, C10)
SKIP = 78          # 1: cu_skip_flag (P/B slices)
PRED_MODE = 79     # 1: intra (1) vs inter (0), P/B slices
MVD_GT0 = 80       # 2: mvd component != 0 (x, y)
BLIST = 82         # 2: [bi-pred flag, L1 flag] (B slices)
TS_FLAG = 84       # 1: transform_skip_flag (C10, luma TUs)
MERGE_IDX = 85     # 1: skip merge candidate index (C7, cfg.merge_cands)
CCLM_FLAG = 86     # 1: chroma CCLM vs DM (C6, cfg.cclm, I slices)
BT_FLAG = 87       # 2: binary split present (C5 MTT): [size 32, size 16]
BT_DIR = 89        # 1: split direction (1 = vertical line / side-by-side)
LFNST = 90         # 1: lfnst_idx > 0 (C10, luma TUs, I slices)
MIP_FLAG = 91      # 1: matrix intra prediction flag (C6, cfg.mip)
AMVP_MERGE = 92    # 1: merge-with-residual flag (C7, cfg.amvp)
AMVP_IDX = 93      # 1: AMVP predictor index (C7, cfg.amvp)
NUM_CONTEXTS = 94

MIN_IN_GROUP = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24]


def group_idx(v: int) -> int:
    """Last-significant coordinate prefix group [STD last_sig scheme]."""
    if v < 4:
        return v
    k = v.bit_length() - 1
    return 2 * k + ((v >> (k - 1)) & 1)


def group_suffix_bits(g: int) -> int:
    return max(0, (g >> 1) - 1)


def max_group(size: int) -> int:
    return group_idx(size - 1)
