"""Intra prediction as integer weight matrices (C6) [STD-shaped].

The 35 HEVC-class intra modes (0=planar, 1=DC, 2..34 angular) are each an
affine map of the reference samples:  pred = (W @ ref + 2^(shift-1)) >> shift
with small integer W.  This module *generates* W per (size, mode) from the
standard prediction equations (angle table, inverse-angle projection,
two-tap interpolation, planar/DC weights) [STD].  Both the batched TPU
mode-decision kernel and the normative reconstruction path consume these
same matrices, so encoder RD search and decode are consistent by
construction — the TPU-first restatement of "intra prediction" as MXU
matmuls (SURVEY.md §1.2 T1).

Reference vector layout (length R = 4s+1):
    ref[0]           corner  p[-1][-1]
    ref[1 .. 2s]     top     p[x][-1],  x = 0..2s-1
    ref[2s+1 .. 4s]  left    p[-1][y],  y = 0..2s-1
The *extended* vector fed to the stacked matrices is [ref, smoothed_ref]
(length 2R); per-mode columns select raw or [1,2,1]-smoothed samples
(HEVC's strong-filter rule per size/mode distance) [STD].

x266t availability rule (deviation from HEVC substitution, documented in
SURVEY.md §7 hard-part #3 spirit): reference positions that are out of
picture or not yet reconstructed in coding order read the mid-level value
(128 for 8-bit) — realized for free by initializing the padded recon plane
to 128 and writing blocks in coding order.
"""

from __future__ import annotations

import functools

import numpy as np

PLANAR, DC = 0, 1
NUM_MODES = 35            # HEVC-subset profile
NUM_MODES_VVC = 67        # VVC profile (67 modes, square blocks)

# MIP (matrix intra prediction, C6 VVC tool): modes NUM_MODES_VVC ..
# NUM_MODES_VVC + MIP_K - 1 are machine-trained integer matrices over
# the 16 downsampled boundary group sums (tools/train_mip.py), exposed
# through the SAME stacked-weight interface as the analytic modes —
# on TPU, MIP is literally extra rows of the one intra matmul.
MIP_K = 8

# intraPredAngle for modes 2..34, HEVC 35-mode family [STD].
ANGLES = np.array([32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17,
                   -21, -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5,
                   9, 13, 17, 21, 26, 32], dtype=np.int32)

# |intraPredAngle| ladder for the VVC 65-angle family, offsets 0..16 from
# pure horizontal (mode 18) / vertical (mode 50) [STD H.266 8.4.5.2.12].
ABS_ANGLES_VVC = np.array([0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20,
                           23, 26, 29, 32], dtype=np.int32)


def num_modes(profile_vvc: bool) -> int:
    return NUM_MODES_VVC if profile_vvc else NUM_MODES


def mode_geometry(mode: int, n_modes: int) -> tuple[bool, int]:
    """(vertical_family, intraPredAngle) for an angular mode [STD].

    35-mode: vertical iff mode >= 18, angle from ANGLES.
    67-mode: vertical iff mode >= 34; pure H = 18, pure V = 50;
    angle magnitude from ABS_ANGLES_VVC, sign toward the diagonals.
    """
    assert mode >= 2
    if n_modes == NUM_MODES:
        return mode >= 18, int(ANGLES[mode - 2])
    vertical = mode >= 34
    center = 50 if vertical else 18
    off = mode - center
    mag = int(ABS_ANGLES_VVC[abs(off)])
    if vertical:
        a = mag if off >= 0 else -mag
    else:
        a = mag if off <= 0 else -mag
    return vertical, a


def ref_len(size: int) -> int:
    return 4 * size + 1


def _idx_corner() -> int:
    return 0


def _idx_top(size: int, x: int) -> int:
    assert 0 <= x < 2 * size
    return 1 + x


def _idx_left(size: int, y: int) -> int:
    assert 0 <= y < 2 * size
    return 1 + 2 * size + y


@functools.cache
def smoothing_matrix(size: int) -> np.ndarray:
    """(R, R) int matrix: [1,2,1]/4 filter along the boundary line with
    endpoints passed through; apply as (S @ ref + 2) >> 2 [STD]."""
    r = ref_len(size)
    # line order: L[2s-1] ... L[0], corner, T[0] ... T[2s-1]
    line_of = np.empty(r, dtype=np.int64)
    pos = 0
    for y in range(2 * size - 1, -1, -1):
        line_of[pos] = _idx_left(size, y)
        pos += 1
    line_of[pos] = _idx_corner()
    pos += 1
    for x in range(2 * size):
        line_of[pos] = _idx_top(size, x)
        pos += 1
    s_line = np.zeros((r, r), dtype=np.int32)
    for i in range(r):
        if i == 0 or i == r - 1:
            s_line[i, i] = 4
        else:
            s_line[i, i - 1] = 1
            s_line[i, i] = 2
            s_line[i, i + 1] = 1
    # Permute from line space back to ref-vector space.
    s = np.zeros((r, r), dtype=np.int32)
    for li in range(r):
        for lj in range(r):
            s[line_of[li], line_of[lj]] = s_line[li, lj]
    return s


def use_smoothed(size: int, mode: int, n_modes: int = NUM_MODES) -> bool:
    """HEVC-style strong intra smoothing rule [STD]: never for 4x4 or DC;
    for angular modes, when the distance to pure H/V exceeds the per-size
    threshold; planar counts as maximally distant.  Thresholds double in
    the 67-mode family (same angular distance).  MIP modes read raw
    references (their training saw raw boundaries)."""
    if size == 4 or mode == DC or mode >= NUM_MODES_VVC:
        return False
    if mode == PLANAR:
        return True
    if n_modes == NUM_MODES:
        thresh = {8: 7, 16: 1, 32: 0}.get(size)
        dist = min(abs(mode - 10), abs(mode - 26))
    else:
        thresh = {8: 14, 16: 2, 32: 0}.get(size)
        dist = min(abs(mode - 18), abs(mode - 50))
    if thresh is None:
        return False
    return dist > thresh


def _angular_weights(size: int, mode: int,
                     n_modes: int = NUM_MODES) -> np.ndarray:
    """(s*s, R) two-tap angular weights, shift 5, offset 16 [STD]."""
    s = size
    r = ref_len(s)
    vertical, a = mode_geometry(mode, n_modes)

    # refMain[k] for k in [-s, 2s]; entries are ref-vector indices.
    def main_idx(k: int) -> int:
        if k == 0:
            return _idx_corner()
        if k > 0:
            return (_idx_top(s, k - 1) if vertical else _idx_left(s, k - 1))
        # negative side: inverse-angle projection onto the side reference
        inv = round(8192.0 / -a)          # a < 0 here; inv > 0
        j = ((-k) * inv + 128) >> 8       # refSide index, 0 = corner
        if j == 0:
            return _idx_corner()
        j = min(j, 2 * s)
        return (_idx_left(s, j - 1) if vertical else _idx_top(s, j - 1))

    w = np.zeros((s * s, r), dtype=np.int32)
    for y in range(s):                    # distance along prediction dir
        idx = ((y + 1) * a) >> 5
        frac = ((y + 1) * a) & 31
        for x in range(s):                # position across
            k1 = x + idx + 1
            row = (y * s + x) if vertical else (x * s + y)  # transpose for H
            if frac == 0:
                w[row, main_idx(k1)] += 32
            else:
                w[row, main_idx(k1)] += 32 - frac
                w[row, main_idx(k1 + 1)] += frac
    return w


def _planar_weights(size: int) -> np.ndarray:
    s = size
    w = np.zeros((s * s, ref_len(s)), dtype=np.int32)
    for y in range(s):
        for x in range(s):
            row = y * s + x
            w[row, _idx_left(s, y)] += s - 1 - x
            w[row, _idx_top(s, s)] += x + 1          # top-right sample
            w[row, _idx_top(s, x)] += s - 1 - y
            w[row, _idx_left(s, s)] += y + 1         # bottom-left sample
    return w


def _dc_weights(size: int) -> np.ndarray:
    s = size
    w = np.zeros((s * s, ref_len(s)), dtype=np.int32)
    for x in range(s):
        w[:, _idx_top(s, x)] = 1
    for y in range(s):
        w[:, _idx_left(s, y)] = 1
    return w


@functools.cache
def mode_shift(size: int, mode: int) -> int:
    if mode >= NUM_MODES_VVC:          # MIP: 6 + log2(group s/4)
        return (size.bit_length() - 1) + 4
    if mode in (PLANAR, DC):
        return (size.bit_length() - 1) + 1
    return 5


@functools.cache
def mip_weight_matrix(size: int, k: int) -> np.ndarray:
    """(s*s, R) int weights of MIP mode k in raw-ref space.

    The trained (s*s, 16) matrix over boundary group sums expands by
    replicating each group weight over its s/4 raw boundary columns
    (group g covers body[g*s/4:(g+1)*s/4], body = [top 2s, left 2s]);
    the 1/(s/4) averaging folds into mode_shift.  Rows sum to exactly
    64 * s/4 = 2^shift, so flat fields reproduce exactly."""
    from x266_tpu_torch.specmodel.mip_tables import TABLES

    s = size
    m = TABLES[s][k].astype(np.int32)                 # (s*s, 16)
    w = np.zeros((s * s, ref_len(s)), dtype=np.int32)
    g = s // 4
    w[:, 1:] = np.repeat(m, g, axis=1)
    assert (w.sum(axis=1) == (1 << mode_shift(s, NUM_MODES_VVC))).all()
    return w


@functools.cache
def weight_matrix(size: int, mode: int,
                  n_modes: int = NUM_MODES) -> np.ndarray:
    """(s*s, R) int32 weights in *raw-ref* space (smoothing not applied);
    rows sum to exactly 2^mode_shift(size, mode)."""
    if mode >= NUM_MODES_VVC:
        w = mip_weight_matrix(size, mode - NUM_MODES_VVC)
    elif mode == PLANAR:
        w = _planar_weights(size)
    elif mode == DC:
        w = _dc_weights(size)
    else:
        w = _angular_weights(size, mode, n_modes)
    assert (w.sum(axis=1) == (1 << mode_shift(size, mode))).all()
    return w


@functools.cache
def stacked_weights(size: int, n_modes: int = NUM_MODES
                    ) -> tuple[np.ndarray, np.ndarray]:
    """All-modes matrices over the extended [raw, smoothed] ref vector.

    Returns (W, shifts): W int8 (n_modes, s*s, 2R) where per mode the
    raw or the smoothed half is populated per use_smoothed(); shifts
    (n_modes,) int32.  Weight magnitudes <= 32 < 127 so int8 is exact.
    """
    r = ref_len(size)
    w = np.zeros((n_modes, size * size, 2 * r), dtype=np.int8)
    shifts = np.zeros(n_modes, dtype=np.int32)
    for m in range(n_modes):
        wm = weight_matrix(size, m, n_modes)
        assert np.abs(wm).max() <= 127
        if use_smoothed(size, m, n_modes):
            w[m, :, r:] = wm
        else:
            w[m, :, :r] = wm
        shifts[m] = mode_shift(size, m)
    return w, shifts


def extend_refs(ref: np.ndarray) -> np.ndarray:
    """[ref, smoothed_ref] for one (R,) int vector (NumPy oracle path)."""
    size = (ref.shape[0] - 1) // 4
    s = smoothing_matrix(size)
    sm = (s @ ref.astype(np.int64) + 2) >> 2
    return np.concatenate([ref.astype(np.int64), sm])


# ---- PDPC (C6, VVC tool) ----------------------------------------------------
#
# Position-dependent prediction combination [STD-shaped, H.266 8.4.5.2.15]:
# after the mode prediction, boundary rows/columns are blended toward the
# *unfiltered* reference samples with weights that decay by distance:
#
#   planar/DC:  p' = (wL(x)*L(y) + wT(y)*T(x) + (64-wL-wT)*p + 32) >> 6
#   vertical:   p' = (64*p + wL(x)*(L(y) - C) + 32) >> 6
#   horizontal: p' = (64*p + wT(y)*(T(x) - C) + 32) >> 6
#   wL(x) = 32 >> min(31, (2x) >> scale), wT likewise over y,
#   scale = (2*log2(s) - 2) >> 2.
#
# x266t deviations (FORMAT.md §8): PDPC applies to the four dominant modes
# (planar, DC, pure H, pure V) and to luma only; the VVC near-diagonal
# angular variants are not implemented.  No output clip (the final
# reconstruction clip bounds the sample; encoder and decoder share the
# identical function so no mismatch is possible).
#
# Availability gate (x266t, replaces HEVC/VVC reference substitution):
# unavailable reference positions read 128 in this format, and blending
# boundary pixels toward that constant measurably poisons edge blocks
# (a 32x32 DC block at the picture top lost ~7 extra coded coefficients
# on the gradient test clip).  A blend term is therefore DISABLED when
# its reference side is out of picture: the left terms require x0 > 0,
# the top terms y0 > 0, and the H/V corner forms require both.  The gate
# is purely geometric (TU origin), so encoder and decoder derive it
# identically with no signalling.

PDPC_NONE, PDPC_PD, PDPC_HOR, PDPC_VER = 0, 1, 2, 3


def pdpc_mode_class(mode: int, n_modes: int = NUM_MODES) -> int:
    """Which PDPC blend (if any) a mode receives."""
    if mode in (PLANAR, DC):
        return PDPC_PD
    h, v = (10, 26) if n_modes == NUM_MODES else (18, 50)
    if mode == h:
        return PDPC_HOR
    if mode == v:
        return PDPC_VER
    return PDPC_NONE


@functools.cache
def pdpc_weights(size: int) -> tuple[np.ndarray, np.ndarray]:
    """(wL (s,), wT (s,)) int32 decay weights [STD]."""
    scale = (2 * (size.bit_length() - 1) - 2) >> 2
    pos = np.arange(size, dtype=np.int32)
    w = 32 >> np.minimum(31, (2 * pos) >> scale)
    return w.copy(), w.copy()


def apply_pdpc(pred: np.ndarray, ref: np.ndarray, size: int, mode: int,
               n_modes: int = NUM_MODES, left_ok: bool = True,
               top_ok: bool = True) -> np.ndarray:
    """NumPy oracle PDPC blend; ref is the RAW (unfiltered) ref vector.
    left_ok/top_ok: geometric availability gates (x0 > 0 / y0 > 0)."""
    cls = pdpc_mode_class(mode, n_modes)
    if cls == PDPC_NONE:
        return pred
    s = size
    p = pred.astype(np.int64)
    corner = int(ref[_idx_corner()])
    top = ref[1:1 + s].astype(np.int64)[None, :]          # (1, s)
    left = ref[2 * s + 1:2 * s + 1 + s].astype(np.int64)[:, None]  # (s, 1)
    wl, wt = pdpc_weights(s)
    wl = wl.astype(np.int64)[None, :] * int(left_ok)      # by column x
    wt = wt.astype(np.int64)[:, None] * int(top_ok)      # by row y
    if cls == PDPC_PD:
        out = (wl * left + wt * top + (64 - wl - wt) * p + 32) >> 6
    elif cls == PDPC_VER:
        if not (left_ok and top_ok):
            return pred
        out = (64 * p + wl * (left - corner) + 32) >> 6
    else:
        if not (left_ok and top_ok):
            return pred
        out = (64 * p + wt * (top - corner) + 32) >> 6
    return out.astype(np.int32)


def predict(ref: np.ndarray, size: int, mode: int,
            n_modes: int = NUM_MODES, pdpc: bool = False,
            left_ok: bool = True, top_ok: bool = True) -> np.ndarray:
    """NumPy oracle: predict an (s, s) block from an (R,) ref vector."""
    ext = extend_refs(ref)
    w, shifts = stacked_weights(size, n_modes)
    sh = int(shifts[mode])
    p = (w[mode].astype(np.int64) @ ext + (1 << (sh - 1))) >> sh
    p = p.reshape(size, size).astype(np.int32)
    if pdpc:
        p = apply_pdpc(p, np.asarray(ref), size, mode, n_modes,
                       left_ok, top_ok)
    return p
