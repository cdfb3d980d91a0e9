"""Adaptive loop filter (C15), as x266_tpu/kernels/alf.py.

Normative and integer (equal to the reference bit for bit): the 4x4
block classification (``classify_full``: 25 classes and 4 transposes),
the 7x7-diamond luma filter (``apply_alf``: linear, or nonlinear with
per-class clip levels and the transposes), the 5x5-diamond chroma filter
(``apply_alf_chroma``) and the cross-component filter (``apply_ccalf``).
The reference looks the per-block coefficients up through a one-hot
matmul (a gather is slow on the TPU); here it is a gather.

The encoder's estimators of config 4, ``estimate_alf`` and
``estimate_alf_chroma``, solve per-class normal equations.  The
reference accumulates them in float32 and solves in float32 (XLA CPU,
LAPACK); the port accumulates them exactly -- features and errors are
integers, every partial sum of their products is an integer below 2^53,
so float64 sums them exactly in any order, on the CPU and on the card --
and solves in float64 by an LDL^T elimination written as a fixed
sequence of elementwise ops, each rounded once by IEEE rules, so its CPU
and CUDA routes give the same coefficients bit for bit, with no round
trip to the host.  On small pictures they equal the reference's except
where its unrounded solution lies near a half-integer; on larger ones
the reference's float32 sums drift further from the exact ones (ROADMAP
queue 3, F9).  The per-CTB on/off decision sums the SSE exactly (int64)
and then compares as the reference does in float32.
"""

from __future__ import annotations

import numpy as np
import torch

DIAMOND = np.array([
    (0, 1), (0, 2), (0, 3),
    (1, -2), (1, -1), (1, 0), (1, 1), (1, 2),
    (2, -1), (2, 0), (2, 1),
    (3, 0),
], dtype=np.int32)

NUM_CLASSES = 25
COEF_BITS = 7
COEF_MAX = 511
ACT_THRESHOLDS = (64, 256, 1024, 4096)

TRANSPOSE_PERMS = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
    [5, 9, 11, 8, 4, 0, 6, 10, 3, 1, 7, 2],
    [0, 1, 2, 7, 6, 5, 4, 3, 10, 9, 8, 11],
    [5, 9, 11, 10, 6, 0, 4, 8, 7, 1, 3, 2],
], dtype=np.int32)

CHROMA_DIAMOND = np.array([
    (0, 1), (0, 2),
    (1, -1), (1, 0), (1, 1),
    (2, 0),
], dtype=np.int32)

CC_OFFSETS = np.array([
    (-1, 0),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
    (2, 0),
], dtype=np.int32)


def clip_levels(bit_depth: int = 8) -> tuple[int, int, int, int]:
    """Nonlinear-ALF clip values per 2-bit level (level 0 is linear)."""
    b = bit_depth
    return (1 << b, 1 << (b - 3), 1 << (b - 5), 1 << (b - 7))


def _shift2(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(p, (-int(dy), -int(dx)), (0, 1))


def _up4(a: torch.Tensor) -> torch.Tensor:
    return a.repeat_interleave(4, 0).repeat_interleave(4, 1)


def _ctb_plane(flags: torch.Tensor, ctb: int, h: int, w: int):
    return flags.repeat_interleave(ctb, 0).repeat_interleave(ctb, 1)[:h, :w]


def classify_full(y: torch.Tensor):
    """(H, W) luma -> (class (H/4, W/4), transpose (H/4, W/4)) int32."""
    y = y.to(torch.int32)
    h, w = y.shape
    lh = (2 * y - _shift2(y, 0, -1) - _shift2(y, 0, 1)).abs()
    lv = (2 * y - _shift2(y, -1, 0) - _shift2(y, 1, 0)).abs()
    ld0 = (2 * y - _shift2(y, -1, -1) - _shift2(y, 1, 1)).abs()
    ld1 = (2 * y - _shift2(y, -1, 1) - _shift2(y, 1, -1)).abs()

    def blk(a):
        return a.reshape(h // 4, 4, w // 4, 4).sum((1, 3), dtype=torch.int32)

    gh, gv, g0, g1 = blk(lh), blk(lv), blk(ld0), blk(ld1)
    hv_hi, hv_lo = torch.maximum(gh, gv), torch.minimum(gh, gv)
    d_hi, d_lo = torch.maximum(g0, g1), torch.minimum(g0, g1)
    hv_strong = hv_hi > 2 * hv_lo
    d_strong = d_hi > 2 * d_lo
    hv_wins = hv_hi * d_lo >= d_hi * hv_lo
    dir_hv = torch.where(gv > gh, 1, 2)
    dir_d = torch.where(g0 > g1, 3, 4)
    direction = torch.where(hv_wins, torch.where(hv_strong, dir_hv, 0),
                            torch.where(d_strong, dir_d, 0))
    act = gh + gv
    a = sum((act > t).to(torch.int32) for t in ACT_THRESHOLDS)
    cls = (5 * a + direction).to(torch.int32)
    transpose = ((gh > gv).to(torch.int32)
                 + 2 * (g1 > g0).to(torch.int32))
    return cls, transpose


def classify(y: torch.Tensor) -> torch.Tensor:
    return classify_full(y)[0]


def _diff_planes(y: torch.Tensor, diamond=DIAMOND) -> torch.Tensor:
    """(T, H, W) symmetric difference features (s_i - c) + (s_-i - c)."""
    return torch.stack([_shift2(y, dy, dx) + _shift2(y, -dy, -dx) - 2 * y
                        for dy, dx in diamond])


def _clipped_diff_planes(y, v, diamond=DIAMOND) -> torch.Tensor:
    """(T, H, W) features with each difference clipped to +-v (v a
    scalar or a per-sample plane)."""
    return torch.stack([torch.clamp(_shift2(y, dy, dx) - y, -v, v)
                        + torch.clamp(_shift2(y, -dy, -dx) - y, -v, v)
                        for dy, dx in diamond])


def apply_alf(y, class_map, coeffs, ctb_flags, bit_depth: int = 8,
              transpose_map=None, clip_idx=None) -> torch.Tensor:
    """Normative luma ALF: y (H, W) int32 (post-SAO), class_map (H/4,
    W/4), coeffs (25, 12), ctb_flags (Cy, Cx).  With transpose_map and
    clip_idx (25,) the nonlinear, transposed filter."""
    y = y.to(torch.int32)
    h, w = y.shape
    coeffs = coeffs.to(torch.int32)
    if transpose_map is not None:
        lv = clip_idx.to(torch.int64)[class_map.long()]
        vblk = torch.zeros_like(class_map)
        for i, v in enumerate(clip_levels(bit_depth)):
            vblk = vblk + (lv == i).to(torch.int32) * v
        feats = _clipped_diff_planes(y, _up4(vblk))
        perms = torch.from_numpy(TRANSPOSE_PERMS).to(y.device).long()
        table = coeffs[:, perms].reshape(NUM_CLASSES * 4, 12)
        group = class_map * 4 + transpose_map
    else:
        feats = _diff_planes(y)
        table = coeffs
        group = class_map
    cblk = table[group.long()]                        # (H/4, W/4, 12)
    acc = torch.zeros_like(y)
    for i in range(12):
        acc = acc + _up4(cblk[..., i]) * feats[i]
    filt = (y + ((acc + 64) >> COEF_BITS)).clamp(0, (1 << bit_depth) - 1)
    return torch.where(_ctb_plane(ctb_flags, 64, h, w) > 0, filt, y)


def apply_alf_chroma(c, coeffs, ctb_flags, bit_depth: int = 8,
                     clip_lvl=None) -> torch.Tensor:
    """Normative chroma ALF: c (H, W) int32 (post-SAO), coeffs (6,),
    ctb_flags on the luma CTU grid (32x32 chroma samples each); clip_lvl
    (0-3) the plane's clip level in nonlinear mode."""
    c = c.to(torch.int32)
    h, w = c.shape
    if clip_lvl is not None:
        feats = _clipped_diff_planes(c, clip_levels(bit_depth)[int(clip_lvl)],
                                     CHROMA_DIAMOND)
    else:
        feats = _diff_planes(c, CHROMA_DIAMOND)
    coeffs = coeffs.to(torch.int32)
    acc = (coeffs[:, None, None] * feats).sum(0, dtype=torch.int32)
    filt = (c + ((acc + 64) >> COEF_BITS)).clamp(0, (1 << bit_depth) - 1)
    return torch.where(_ctb_plane(ctb_flags, 32, h, w) > 0, filt, c)


def _cc_feats(luma, ch: int, cw: int) -> torch.Tensor:
    """(7, ch, cw) luma-difference features at chroma resolution."""
    center = luma[0::2, 0::2][:ch, :cw]
    return torch.stack([_shift2(luma, dy, dx)[0::2, 0::2][:ch, :cw] - center
                        for dy, dx in CC_OFFSETS])


def apply_ccalf(c, luma, coeffs, ctb_flags, bit_depth: int = 8):
    """Normative CC-ALF of one chroma plane: c (ch, cw) int32 (post
    chroma ALF), luma (H, W) int32 (post-SAO, pre-ALF), coeffs (7,)."""
    c = c.to(torch.int32)
    ch, cw = c.shape
    feats = _cc_feats(luma.to(torch.int32), ch, cw)
    acc = (coeffs.to(torch.int32)[:, None, None] * feats).sum(
        0, dtype=torch.int32)
    filt = (c + ((acc + 64) >> COEF_BITS)).clamp(0, (1 << bit_depth) - 1)
    return torch.where(_ctb_plane(ctb_flags, 32, ch, cw) > 0, filt, c)


# ---- encoder estimators ----------------------------------------------------

def ldl_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of a x = b for symmetric positive definite a (..., n, n) and b
    (..., n), float64, by an LDL^T elimination.  Every step is one
    multiply, subtract or divide of whole tensors (no square root: torch's
    CPU one is not correctly rounded; no reduction), each rounded once by
    IEEE rules, so the result does not depend on the device."""
    n = a.shape[-1]
    a = a.clone()
    low = torch.zeros_like(a)
    diag = torch.zeros_like(b)
    for k in range(n):
        diag[..., k] = a[..., k, k]
        low[..., k + 1:, k] = a[..., k + 1:, k] / a[..., k, k, None]
        a[..., k + 1:, k + 1:] -= (low[..., k + 1:, k, None]
                                   * a[..., None, k + 1:, k])
    y = b.clone()
    for k in range(n):
        y[..., k + 1:] -= low[..., k + 1:, k] * y[..., k, None]
    y = y / diag
    for k in reversed(range(n)):
        y[..., :k] -= low[..., k, :k] * y[..., k, None]
    return y


def _solve(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Round and clip the solution of (gram + 64 I) c = 128 rhs, solved
    in float64 on the inputs' device: (..., n) int32."""
    n = gram.shape[-1]
    g = gram + 64.0 * torch.eye(n, dtype=torch.float64, device=gram.device)
    sol = ldl_solve(g, rhs * float(1 << COEF_BITS))
    return torch.round(sol).clamp(-COEF_MAX, COEF_MAX).to(torch.int32)


def normal_equations(feats, err, cls_blk=None, n_classes: int = 1):
    """Exact per-class sums (gram (C, T, T), rhs (C, T) float64) of
    feats (T, H, W) and err (H, W) integer planes, each 4x4 block's
    pixels in the class cls_blk (H/4, W/4) gives it (all in class 0 when
    None): each block's sums by a batched matmul, then the classes' by a
    matmul with the blocks' one-hot classes, with nothing read back to
    the host."""
    t = feats.shape[0]
    f = feats.to(torch.float64)
    e = err.to(torch.float64)
    if cls_blk is None:
        f = f.reshape(t, -1)
        return (f @ f.T)[None], (f @ e.reshape(-1))[None]
    h, w = err.shape
    fb = f.reshape(t, h // 4, 4, w // 4, 4).permute(1, 3, 0, 2, 4).reshape(
        -1, t, 16)
    eb = e.reshape(h // 4, 4, w // 4, 4).permute(0, 2, 1, 3).reshape(
        -1, 16, 1)
    hot = (cls_blk.reshape(-1, 1) == torch.arange(
        n_classes, device=f.device)).to(torch.float64).T
    gram = hot @ torch.bmm(fb, fb.transpose(1, 2)).reshape(-1, t * t)
    rhs = hot @ torch.bmm(fb, eb).reshape(-1, t)
    return gram.reshape(n_classes, t, t), rhs


def _ctb_flags(filt, recon, orig, ctb: int, lam: float) -> torch.Tensor:
    """Per-CTB on/off: the SSE gain of filtering, summed exactly, then
    gain + lam * 1.5 < 0 in float32 as the reference decides."""
    h, w = orig.shape
    cy, cx = -(-h // ctb), -(-w // ctb)

    def ctb_sse(a):
        d = (a - orig).to(torch.int64) ** 2
        d = torch.nn.functional.pad(d, (0, cx * ctb - w, 0, cy * ctb - h))
        return d.reshape(cy, ctb, cx, ctb).sum((1, 3))

    gain = (ctb_sse(filt) - ctb_sse(recon)).to(torch.float32)
    return ((gain + float(np.float32(lam * 1.5))) < 0).to(torch.int32)


def estimate_alf(orig, recon, lam: float, bit_depth: int = 8):
    """Per-class Wiener filters and per-CTB flags: (coeffs (25, 12),
    ctb_flags (Cy, Cx), filtered (H, W)) int32."""
    orig = orig.to(torch.int32)
    recon = recon.to(torch.int32)
    h, w = orig.shape
    cls = classify(recon)
    gram, rhs = normal_equations(_diff_planes(recon), orig - recon, cls,
                                 NUM_CLASSES)
    coeffs = _solve(gram, rhs)
    all_on = torch.ones(((h + 63) // 64, (w + 63) // 64), dtype=torch.int32,
                        device=orig.device)
    filt = apply_alf(recon, cls, coeffs, all_on, bit_depth)
    flags = _ctb_flags(filt, recon, orig, 64, lam)
    return coeffs, flags, apply_alf(recon, cls, coeffs, flags, bit_depth)


def estimate_alf_chroma(orig, recon, lam: float, bit_depth: int = 8):
    """The 5x5 Wiener filter of one chroma plane and its per-CTB flags:
    (coeffs (6,), flags (Cy, Cx), filtered) int32."""
    orig = orig.to(torch.int32)
    recon = recon.to(torch.int32)
    h, w = orig.shape
    gram, rhs = normal_equations(_diff_planes(recon, CHROMA_DIAMOND),
                                 orig - recon)
    coeffs = _solve(gram, rhs)[0]
    all_on = torch.ones((-(-h // 32), -(-w // 32)), dtype=torch.int32,
                        device=orig.device)
    filt = apply_alf_chroma(recon, coeffs, all_on, bit_depth)
    flags = _ctb_flags(filt, recon, orig, 32, lam)
    return coeffs, flags, apply_alf_chroma(recon, coeffs, flags, bit_depth)
