"""Adaptive loop filter (C15), as x266_tpu/kernels/alf.py.

Normative and integer (equal to the reference bit for bit): the 4x4
block classification (``classify_full``: 25 classes and 4 transposes),
the 7x7-diamond luma filter (``apply_alf``: linear, or nonlinear with
per-class clip levels and the transposes), the 5x5-diamond chroma filter
(``apply_alf_chroma``) and the cross-component filter (``apply_ccalf``).
The reference looks the per-block coefficients up through a one-hot
matmul (a gather is slow on the TPU); here it is a gather.

The encoder's estimators -- linear luma and chroma (``estimate_alf``,
``estimate_alf_chroma``), nonlinear luma with clip levels and transposes
(``estimate_alf_nonlinear``), nonlinear chroma (``estimate_alf_chroma_nl``)
and CC-ALF (``estimate_ccalf``) -- compute what the reference computes in
float32 on XLA's CPU backend, bit for bit (ROADMAP queue 3, F9):

- the per-class normal equations (x266_tpu/kernels/alf.py:367-368,
  436-437, 278-279, 318-319, 538-539) are XLA dots whose float32 sums run
  in blocks of samples, each block in a few interleaved sequential lanes
  (``SUM_ORDERS``, measured by cancellation probes on XLA's dots and
  checked against them on random data of full magnitude);
- the solve (``jnp.linalg.solve``, :370, :438, :280, :318, :538) is
  LAPACK's sgetrf and two strsm calls of the OpenBLAS that jaxlib calls;
  ``solve_f32`` repeats their float32 operations in their order (``_fma``
  gives the fused multiply-adds from float64 ops);
- the per-CTB SSE (:335-338, :379-382, :467-470, :547-550) follows XLA's
  reduction order (``ctb_sse``);
- the nonlinear estimators' choices of clip level read the per-class SSE
  of 4x4 blocks (:454-456, ``class_sse``) and the chroma plane's SSE
  (:326, kernels.cost.plane_sse_f32), each in the order XLA CPU emits it;
  CC-ALF's whole-filter gate sums the gains of the CTBs it keeps on
  (:558, ``gain_total``) in its order.

The plain versions here are torch ops on any device
(``normal_solve_plain``, ``_ctb_flags``, ``class_sse_plain``,
``_ccalf_gate``); on CUDA tensors ``normal_solve``, ``ctb_flags``,
``class_sse`` and ``ccalf_gate`` run the hand-written kernels of
kernels/alf_cuda.py (csrc/alf.cu) instead, which form the features from
the recon themselves and sum exactly in integers wherever float32's order
cannot change a bit.
"""

from __future__ import annotations

import numpy as np
import torch

from x266_tpu_torch.kernels.cost import fma_f32 as _fma

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


_PERMS: dict = {}


def _perms(device) -> torch.Tensor:
    """TRANSPOSE_PERMS as an int64 tensor on device, copied there once: a
    copy from host memory is a host sync on the card."""
    key = str(device)
    if key not in _PERMS:
        _PERMS[key] = torch.from_numpy(TRANSPOSE_PERMS).long().to(device)
    return _PERMS[key]


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
        table = coeffs[:, _perms(y.device)].reshape(NUM_CLASSES * 4, 12)
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
    (0-3, an int or a scalar tensor) the plane's clip level in nonlinear
    mode."""
    c = c.to(torch.int32)
    h, w = c.shape
    if clip_lvl is not None:
        # picked as the reference picks it (:255): a device scalar level
        # needs no host sync
        v = sum((clip_lvl == i) * v_
                for i, v_ in enumerate(clip_levels(bit_depth)))
        feats = _clipped_diff_planes(c, v, CHROMA_DIAMOND)
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
#
# XLA CPU's float32 order for the estimators' four dots (measured on
# jaxlib 0.9's CPU backend: cancellation probes on each dot shape, then
# the model held to the live dot on random full-magnitude data from 8,192
# to 2,073,600 samples).  Per (class, entry), the samples run in
# blocks of ``block`` in raster order (0: one block); inside a block,
# lane l takes the samples at offsets l, l + lanes, ... one after another
# from 0; the lanes then combine in pairs ((l0 + l1) + (l2 + l3)) or in
# halves ((l0 + l4) + (l2 + l6)) + ..., and the block sums add up in
# order from 0.  A sample outside the class adds 0, which changes no
# float32 sum, so each class keeps only its own samples.  Checked for
# sample counts that are multiples of 8, which every picture here gives.
# The nonlinear estimators' dots (:436-437, :318-319) have the linear
# ones' shapes and take their orders; CC-ALF's (:538-539, seven taps) were
# probed the same way and take chroma's.  The per-class SSE of the 4x4
# blocks (:454-456) is a dot f32[25, N] . f32[N] over the N blocks, which
# XLA CPU emits two ways (read from its optimized LLVM IR at N = 384 to
# 518,400 and held to the live op): below 16 KiB of blocks (N < 4,096) it
# fuses the dot into a loop that LLVM vectorizes 8 wide, two vectors an
# iteration -- 16 lanes folded in halves; from there a tiled gemv, whose
# rows in tiles of 8 fold their 8 lanes in pairs and whose last row (the
# 25th) folds them in halves.
SUM_ORDERS = {
    "luma_gram": (1024, 2, "pairs"),    # f32[144, N] . f32[25, N]
    "luma_rhs": (2728, 4, "pairs"),     # f32[25, N] . f32[12, N]
    "chroma_gram": (4096, 4, "pairs"),  # f32[6, N] . f32[6, N]
    "chroma_rhs": (0, 8, "halves"),     # f32[6, N] . f32[N]
    "cc_gram": (4096, 4, "pairs"),      # f32[7, N] . f32[7, N]
    "cc_rhs": (0, 8, "halves"),         # f32[7, N] . f32[N]
    "class_sse_fused": (0, 16, "halves"),   # f32[25, N] . f32[N], N < 4096
    "class_sse_gemv": (0, 8, "pairs"),      # classes 0-23, N >= 4096
    "class_sse_gemv_last": (0, 8, "halves"),    # class 24, N >= 4096
}
CLASS_SSE_FUSED = 4096      # blocks below which XLA fuses the dot (16 KiB)


def _combine(lanes: torch.Tensor, how: str) -> torch.Tensor:
    """Add the trailing lane dim in XLA's order."""
    while lanes.shape[-1] > 1:
        if how == "pairs":
            lanes = lanes[..., 0::2] + lanes[..., 1::2]
        else:
            h = lanes.shape[-1] // 2
            lanes = lanes[..., :h] + lanes[..., h:]
    return lanes[..., 0]


def ordered_sums(x: torch.Tensor, cls: torch.Tensor | None, n_classes: int,
                 order: str) -> torch.Tensor:
    """Per-class float32 sums of x (E, N), exact products, in XLA's order
    SUM_ORDERS[order]: (n_classes, E).  cls (N,) int64 gives each
    sample's class (all class 0 when None)."""
    block, lanes, how = SUM_ORDERS[order]
    return _block_totals(_combine(_lane_sums(x, cls, n_classes, block,
                                             lanes), how))


def _block_totals(blocks: torch.Tensor) -> torch.Tensor:
    """(C, E, nb) block sums added in order from block 0: (C, E)."""
    tot = torch.zeros(blocks.shape[:2], dtype=torch.float32,
                      device=blocks.device)
    for b in range(blocks.shape[2]):
        tot = tot + blocks[..., b]
    return tot


def _lane_sums(x: torch.Tensor, cls: torch.Tensor | None, n_classes: int,
               block: int, lanes: int) -> torch.Tensor:
    """The lanes of XLA's order before they combine: (n_classes, E,
    blocks, lanes) float32.  An explicit loop over a block's lane steps
    on (classes, entries, blocks, lanes) tensors."""
    e, n = x.shape
    if n % 8:
        raise ValueError(f"XLA's sum order is pinned for sample counts "
                         f"that are multiples of 8, got {n}")
    block = min(block or n, n)
    nb = -(-n // block)
    pad = nb * block - n
    steps = block // lanes
    xs = torch.nn.functional.pad(x, (0, pad)).reshape(e, nb, steps, lanes)
    if cls is None:
        cls = torch.zeros(n, dtype=torch.int64, device=x.device)
    # padding samples go to a class of their own, dropped at the end
    cs = torch.nn.functional.pad(cls, (0, pad), value=n_classes).reshape(
        nb, steps, lanes)
    acc = torch.zeros((n_classes + 1, e, nb, lanes), dtype=torch.float32,
                      device=x.device)
    bi = torch.arange(nb, device=x.device)[:, None].expand(nb, lanes)
    li = torch.arange(lanes, device=x.device)[None, :].expand(nb, lanes)
    for q in range(steps):
        c = cs[:, q]                                   # (nb, lanes)
        acc[c, :, bi, li] = acc[c, :, bi, li] + xs[:, :, q].permute(1, 2, 0)
    return acc[:n_classes]


def _products(feats: torch.Tensor, err: torch.Tensor):
    """(T*T, N) and (T, N) float32 products f_i f_j and f_i e, exact
    (|f| <= 510, |e| <= 255 at 8 bits: every product is below 2^24)."""
    f = feats.reshape(feats.shape[0], -1).to(torch.int32)
    e = err.reshape(-1).to(torch.int32)
    gram = (f[:, None, :] * f[None, :, :]).reshape(-1, f.shape[1])
    return gram.to(torch.float32), (f * e).to(torch.float32)


def normal_sums(feats, err, cls_px=None, n_classes: int = 1,
                kind: str | None = None):
    """The reference's float32 normal equations of feats (T, H, W) and
    err (H, W): gram (C, T, T) and rhs (C, T) (the rhs before the
    reference's exact scaling by 128), per class of cls_px (H, W) when
    given (luma), else one class (chroma, CC-ALF); kind names the
    SUM_ORDERS pair ("luma" with cls_px, else "chroma" by default)."""
    t = feats.shape[0]
    pg, pr = _products(feats, err)
    cls = None if cls_px is None else cls_px.reshape(-1).long()
    kind = kind or ("luma" if cls_px is not None else "chroma")
    gram = ordered_sums(pg, cls, n_classes, kind + "_gram")
    rhs = ordered_sums(pr, cls, n_classes, kind + "_rhs")
    return gram.reshape(n_classes, t, t), rhs


def _fma_chain(a: torch.Tensor, x: torch.Tensor, cols) -> torch.Tensor:
    """sum over k in cols of a[..., k] * x[..., k], one FMA after another
    from 0."""
    acc = torch.zeros_like(a[..., 0])
    for k in cols:
        acc = _fma(a[..., k], x[..., k], acc)
    return acc


def _getf2(a: torch.Tensor):
    """OpenBLAS 0.3.30's sgetf2 on (B, n, n) float32 (SkylakeX kernels):
    left-looking, column by column.  Returns the packed LU and the row
    permutation."""
    a = a.clone()
    bsz, n, _ = a.shape
    rows = torch.arange(bsz, device=a.device)
    perm = torch.arange(n, device=a.device).repeat(bsz, 1)
    for j in range(n):
        col = a[:, :, j].clone()
        # U: b[i] -= sdot(L[i, :i], b[:i]); sdot's strided loop makes
        # float32 FMA pairs y0*x0 + (y1*x1) and adds them in float64
        for i in range(1, j):
            x, y = a[:, i, :i], col[:, :i]
            m = i // 2
            pairs = _fma(y[:, 0:2 * m:2], x[:, 0:2 * m:2],
                         y[:, 1:2 * m:2] * x[:, 1:2 * m:2]).double()
            acc = torch.zeros(bsz, dtype=torch.float64, device=a.device)
            for k in range(m):
                acc = acc + pairs[:, k]
            if i % 2:
                acc = acc + (y[:, i - 1] * x[:, i - 1]).double()
            col[:, i] = col[:, i] - acc.float()
        # L: b[j:] -= A[j:, :j] b[:j] (sgemv_n): one FMA chain per row,
        # except for 4 columns, where rows in whole groups of 4 take two
        # chains (columns 0, 2 and 1, 3) added at the end
        if j:
            lo, xb = a[:, j:, :j], col[:, None, :j]
            acc = _fma_chain(lo, xb, range(j))
            if j == 4:
                two = (_fma_chain(lo, xb, (0, 2)) + _fma_chain(lo, xb, (1, 3)))
                vec = torch.arange(n - j, device=a.device) < ((n - j) & ~3)
                acc = torch.where(vec, two, acc)
            col[:, j:] = col[:, j:] - acc
        a[:, :, j] = col
        # pivot: the first largest |b[j:]|; swap whole rows (the later
        # columns' swaps are the same exchanges, made now)
        jp = j + torch.argmax(col[:, j:].abs(), dim=1)
        rj, rp = a[rows, j].clone(), a[rows, jp].clone()
        a[rows, j], a[rows, jp] = rp, rj
        pj, pp = perm[rows, j].clone(), perm[rows, jp].clone()
        perm[rows, j], perm[rows, jp] = pp, pj
        inv = torch.ones_like(a[:, j, j]) / a[:, j, j]
        a[:, j + 1:, j] = a[:, j + 1:, j] * inv[:, None]
    return a, perm


def _trsm_blocks(n: int, lower: bool):
    """The row blocks OpenBLAS's trsm kernels solve, in order (GEMM
    unroll 16): forward from the top in blocks of 16, 8, 4, 2, 1, or
    backward from the bottom in blocks of 1, 2, 4, 8, then 16."""
    full, rem = divmod(n, 16)
    if lower:
        out, s = [], 0
        for _ in range(full):
            out.append((s, 16))
            s += 16
        for i in (8, 4, 2, 1):
            if rem & i:
                out.append((s, i))
                s += i
        return out
    out = [((n & ~(i - 1)) - i, i) for i in (1, 2, 4, 8) if n & i]
    return out + [((full - 1 - q) * 16, 16) for q in range(full)]


def _trsm(lu: torch.Tensor, c: torch.Tensor, lower: bool) -> torch.Tensor:
    """strsm (left side, no transpose; unit lower or non-unit upper) of
    (B, n) c by the packed LU (B, n, n): per block, an FMA chain over the
    solved rows (the GEMM kernel's update), then substitution inside the
    block by FMAs, the upper diagonal applied through its float32
    reciprocal."""
    c = c.clone()
    n = c.shape[1]
    for s0, sz in _trsm_blocks(n, lower):
        blk = slice(s0, s0 + sz)
        done = range(0, s0) if lower else range(s0 + sz, n)
        if len(done):
            cols = list(done)
            acc = _fma_chain(lu[:, blk][:, :, cols], c[:, None, cols],
                             range(len(cols)))
            c[:, blk] = c[:, blk] - acc
        order = range(s0, s0 + sz) if lower else reversed(range(s0, s0 + sz))
        for i in order:
            if not lower:
                c[:, i] = c[:, i] * (torch.ones_like(c[:, i]) / lu[:, i, i])
            rest = slice(i + 1, s0 + sz) if lower else slice(s0, i)
            bb = c[:, i:i + 1]
            c[:, rest] = _fma(-bb.expand_as(c[:, rest]), lu[:, rest, i],
                              c[:, rest])
    return c


def solve_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.solve(a, b) on XLA's CPU backend, bit for bit: a
    (..., n, n), b (..., n) float32.  jaxlib calls LAPACK's sgetrf, then
    strsm with the unit lower and the upper factor; these are the float32
    operations of OpenBLAS 0.3.30 (SkylakeX), held to jnp on thousands of
    systems of the estimators' sizes and magnitudes."""
    shape = b.shape
    n = a.shape[-1]
    lu, perm = _getf2(a.reshape(-1, n, n).to(torch.float32))
    x = torch.gather(b.reshape(-1, n).to(torch.float32), 1, perm)
    x = _trsm(lu, x, lower=True)
    return _trsm(lu, x, lower=False).reshape(shape)


def coefficients(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Round and clip the reference's solution of (gram + 64 I) c =
    128 rhs: (..., T) int32."""
    n = gram.shape[-1]
    g = gram + 64.0 * torch.eye(n, dtype=torch.float32, device=gram.device)
    sol = solve_f32(g, rhs * float(1 << COEF_BITS))
    return torch.round(sol).clamp(-COEF_MAX, COEF_MAX).to(torch.int32)


def _aligned_feats(feats: torch.Tensor, tr_px: torch.Tensor) -> torch.Tensor:
    """fa[i] = feats[PERMS[t, i]] at each sample, t its block's transpose
    (tr_px (H, W)): the reference's four selects per tap (:390-402) as a
    gather, exact."""
    idx = _perms(feats.device)[tr_px.long()].permute(2, 0, 1)  # (12, H, W)
    return torch.gather(feats, 0, idx)


def features(recon, cls=None, clip=None, transpose=None) -> torch.Tensor:
    """The estimator's feature planes of the post-SAO recon: the 12 of
    the 7x7 diamond with the class map cls, else the 6 of the 5x5; with
    clip (a clip value v) each difference clipped to +-v, and with
    transpose (H/4, W/4, luma only) aligned to the block's orientation
    (:433-434, :316)."""
    r = recon.to(torch.int32)
    diamond = DIAMOND if cls is not None else CHROMA_DIAMOND
    if clip is None:
        return _diff_planes(r, diamond)
    feats = _clipped_diff_planes(r, int(clip), diamond)
    return feats if transpose is None else _aligned_feats(feats,
                                                          _up4(transpose))


def normal_solve(recon, orig, cls=None, with_sums: bool = False,
                 bit_depth: int = 8, clip=None, transpose=None):
    """The estimator's coefficients (C, T) int32 (with_sums: and the
    float32 gram (C, T, T) and rhs (C, T)) from the post-SAO recon and
    the source (H, W): with the class map cls (H/4, W/4) the 25 luma
    systems of the 7x7 diamond, without it the one chroma system of the
    5x5 diamond; clip and transpose as features'.  The CUDA kernel
    (kernels/alf_cuda.py) for CUDA tensors, normal_solve_plain for CPU
    ones."""
    if recon.device.type == "cuda":
        from x266_tpu_torch.kernels import alf_cuda
        return alf_cuda.normal_solve(recon, orig, cls, with_sums, bit_depth,
                                     clip=clip, transpose=transpose)
    return normal_solve_plain(recon, orig, cls, with_sums, clip, transpose)


def normal_solve_plain(recon, orig, cls=None, with_sums: bool = False,
                       clip=None, transpose=None):
    """normal_solve in torch ops: the features, the normal equations in
    XLA's order and their float32 solve."""
    r = recon.to(torch.int32)
    luma = cls is not None
    feats = features(r, cls, clip, transpose)
    nc = NUM_CLASSES if luma else 1
    gram, rhs = normal_sums(feats, orig.to(torch.int32) - r,
                            _up4(cls) if luma else None, nc)
    coef = coefficients(gram, rhs)
    return (coef, gram, rhs) if with_sums else coef


def cc_normal_solve(luma, c, orig_c, with_sums: bool = False):
    """CC-ALF's coefficients (1, 7) int32 (with_sums: and the float32 gram
    (1, 7, 7) and rhs (1, 7)) of one chroma plane c (post chroma ALF)
    against its source orig_c, from the post-SAO, pre-ALF luma (H, W)
    (:534-541).  The CUDA kernel for CUDA tensors, cc_normal_solve_plain
    for CPU ones."""
    if c.device.type == "cuda":
        from x266_tpu_torch.kernels import alf_cuda
        return alf_cuda.cc_normal_solve(luma, c, orig_c, with_sums)
    return cc_normal_solve_plain(luma, c, orig_c, with_sums)


def cc_normal_solve_plain(luma, c, orig_c, with_sums: bool = False):
    """cc_normal_solve in torch ops."""
    c = c.to(torch.int32)
    ch, cw = c.shape
    feats = _cc_feats(luma.to(torch.int32), ch, cw)
    gram, rhs = normal_sums(feats, orig_c.to(torch.int32) - c, kind="cc")
    coef = coefficients(gram, rhs)
    return (coef, gram, rhs) if with_sums else coef


def _seq(v: torch.Tensor) -> torch.Tensor:
    """float32 sum over the trailing (r, c) dims, one sample after
    another in raster order from 0."""
    v = v.reshape(*v.shape[:-2], -1)
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def ctb_sse(a, orig, ctb: int) -> torch.Tensor:
    """The reference's float32 SSE of each CTB (:335-338, :379-382), in
    XLA CPU's order: the CTB kernel of kernels/alf_cuda.py for CUDA
    tensors, ctb_sse_plain for CPU ones."""
    if orig.device.type == "cuda":
        from x266_tpu_torch.kernels import alf_cuda
        return alf_cuda.ctb_sse(a, orig, ctb)
    return ctb_sse_plain(a, orig, ctb)


def ctb_sse_plain(a, orig, ctb: int) -> torch.Tensor:
    """ctb_sse in torch ops, in XLA CPU's order (read from its optimized
    LLVM IR, checked at 112x80 to 3840x2160): a 64x64 CTB is four 32x32
    windows (XLA's tree rewrite of reductions longer than 32), each
    summed in raster order, then added in raster order; a 32x32 CTB is
    summed in raster order when the plane's width is a multiple of 32,
    else row by row through eight-lane vectors (kernels.cost.row_vector_sum).
    """
    from x266_tpu_torch.kernels.cost import row_vector_sum

    h, w = orig.shape
    cy, cx = -(-h // ctb), -(-w // ctb)
    d = (a.to(torch.int32) - orig.to(torch.int32)).to(torch.float32) ** 2
    d = torch.nn.functional.pad(d, (0, cx * ctb - w, 0, cy * ctb - h))
    blocks = d.reshape(cy, ctb, cx, ctb).permute(0, 2, 1, 3)
    if ctb == 64:
        tot = torch.zeros((cy, cx), dtype=torch.float32, device=d.device)
        for y in (0, 32):
            for x in (0, 32):
                tot = tot + _seq(blocks[..., y:y + 32, x:x + 32])
        return tot
    if ctb != 32:
        raise ValueError(f"XLA's CTB-SSE order is pinned for 64 and 32, "
                         f"got {ctb}")
    return _seq(blocks) if w % 32 == 0 else row_vector_sum(blocks)


def ctb_flags(filt, recon, orig, ctb: int, lam: float) -> torch.Tensor:
    """Per-CTB on/off of the filtered plane: the CTB kernel of
    kernels/alf_cuda.py (one launch) for CUDA tensors, _ctb_flags for CPU
    ones."""
    if orig.device.type == "cuda":
        from x266_tpu_torch.kernels import alf_cuda
        return alf_cuda.ctb_flags(filt, recon, orig, ctb, lam)
    return _ctb_flags(filt, recon, orig, ctb, lam)


def _ctb_flags(filt, recon, orig, ctb: int, lam: float) -> torch.Tensor:
    """Per-CTB on/off: gain + lam * 1.5 < 0 on the reference's float32
    SSE gain, in torch ops."""
    gain = ctb_sse_plain(filt, orig, ctb) - ctb_sse_plain(recon, orig, ctb)
    return ((gain + float(np.float32(lam * 1.5))) < 0).to(torch.int32)


def estimate_alf(orig, recon, lam: float, bit_depth: int = 8):
    """Per-class Wiener filters and per-CTB flags: (coeffs (25, 12),
    ctb_flags (Cy, Cx), filtered (H, W)) int32."""
    orig = orig.to(torch.int32)
    recon = recon.to(torch.int32)
    h, w = orig.shape
    cls = classify(recon)
    coeffs = normal_solve(recon, orig, cls, bit_depth=bit_depth)
    all_on = torch.ones(((h + 63) // 64, (w + 63) // 64), dtype=torch.int32,
                        device=orig.device)
    filt = apply_alf(recon, cls, coeffs, all_on, bit_depth)
    flags = ctb_flags(filt, recon, orig, 64, lam)
    return coeffs, flags, apply_alf(recon, cls, coeffs, flags, bit_depth)


def estimate_alf_chroma(orig, recon, lam: float, bit_depth: int = 8):
    """The 5x5 Wiener filter of one chroma plane and its per-CTB flags:
    (coeffs (6,), flags (Cy, Cx), filtered) int32."""
    orig = orig.to(torch.int32)
    recon = recon.to(torch.int32)
    h, w = orig.shape
    coeffs = normal_solve(recon, orig, bit_depth=bit_depth)[0]
    all_on = torch.ones((-(-h // 32), -(-w // 32)), dtype=torch.int32,
                        device=orig.device)
    filt = apply_alf_chroma(recon, coeffs, all_on, bit_depth)
    flags = ctb_flags(filt, recon, orig, 32, lam)
    return coeffs, flags, apply_alf_chroma(recon, coeffs, flags, bit_depth)


# ---- nonlinear ALF and CC-ALF ----------------------------------------------

def block_sse(filt, orig) -> torch.Tensor:
    """(L, H, W) filtered planes against the source (H, W) -> (L, H/4,
    W/4) int32 SSE of each 4x4 block (:451-452; exact in float32 in any
    order: 16 * 255^2 < 2^24)."""
    d = filt.to(torch.int32) - orig.to(torch.int32)
    lv, h, w = d.shape
    return (d * d).reshape(lv, h // 4, 4, w // 4, 4).sum((2, 4),
                                                         dtype=torch.int32)


def class_sse(filt, orig, cls) -> torch.Tensor:
    """The per-class float32 SSE of the 4x4 blocks of each filtered plane
    filt (L, H, W) against orig (H, W) by the class map cls (H/4, W/4):
    (L, 25), in XLA CPU's order (:454-456, SUM_ORDERS "class_sse_*").  The
    class kernel of kernels/alf_cuda.py for CUDA tensors (filt uint8),
    class_sse_plain for CPU ones (any integer dtype)."""
    if orig.device.type == "cuda":
        from x266_tpu_torch.kernels import alf_cuda
        return alf_cuda.class_sse(filt, orig, cls)
    return class_sse_plain(filt, orig, cls)


def class_sse_plain(filt, orig, cls) -> torch.Tensor:
    """class_sse in torch ops."""
    x = block_sse(filt, orig).reshape(filt.shape[0], -1).to(torch.float32)
    n = x.shape[1]
    c = cls.reshape(-1).long()
    if n < CLASS_SSE_FUSED:
        if n % 16:
            raise ValueError(f"XLA's fused class-SSE order is pinned for "
                             f"block counts that are multiples of 16, got {n}")
        return ordered_sums(x, c, NUM_CLASSES, "class_sse_fused").T
    _, lanes, how = SUM_ORDERS["class_sse_gemv"]
    acc = _lane_sums(x, c, NUM_CLASSES, 0, lanes)      # (25, L, 1, lanes)
    out = _combine(acc, how)
    out[-1] = _combine(acc[-1], SUM_ORDERS["class_sse_gemv_last"][2])
    return out[..., 0].T.contiguous()


def gain_total(v: torch.Tensor) -> torch.Tensor:
    """The float32 sum of CC-ALF's per-CTB gains v (Cy, Cx) (:558) in the
    order of the loop fusion XLA CPU makes of the gain, the flag and the
    sum (read from its optimized LLVM IR at Cy = 1, 2, 4 and 17): with 8
    rows or more, lane l adds rows l, l + 8, ... (each in order, below
    the last whole group of 8), the lanes fold in halves and the
    remaining rows follow in raster order; with 4 rows each row is a
    lane, folded in halves; otherwise raster order."""
    r, c = v.shape
    if r != 4 and r < 8:
        return _seq(v)
    m = 4 if r == 4 else r - r % 8
    lanes = _seq(v[:m].reshape(-1, min(m, 8), c).permute(1, 0, 2))
    tot = _combine(lanes, "halves")
    for x in v[m:].reshape(-1):
        tot = tot + x
    return tot


def ccalf_gate(filt, c, orig_c, lam: float):
    """CC-ALF's per-CTB flags and whole-filter gate (:546-561): flags
    (Cy, Cx) int32 (gain + lam * 1.5 < 0 on 32x32 CTBs) and worth, a
    bool scalar tensor (the sum of the kept CTBs' gains + lam * (112 +
    Cy * Cx) < 0, the constant rounded to float32 as JAX's weak typing
    does).  One launch of the CTB kernel for CUDA tensors, _ccalf_gate
    for CPU ones."""
    if orig_c.device.type == "cuda":
        from x266_tpu_torch.kernels import alf_cuda
        return alf_cuda.ccalf_gate(filt, c, orig_c, lam)
    return _ccalf_gate(filt, c, orig_c, lam)


def _gate_constant(lam: float, cy: int, cx: int) -> float:
    return float(np.float32(lam * (112.0 + cy * cx)))


def _ccalf_gate(filt, c, orig_c, lam: float):
    """ccalf_gate in torch ops."""
    gain = ctb_sse_plain(filt, orig_c, 32) - ctb_sse_plain(c, orig_c, 32)
    flags = ((gain + float(np.float32(lam * 1.5))) < 0).to(torch.int32)
    total = gain_total(torch.where(flags > 0, gain, 0.0))
    cy, cx = flags.shape
    return flags, (total + _gate_constant(lam, cy, cx)) < 0


def level_plane(recon, cls, tr, coef, lvl: int, flags, bit_depth: int = 8):
    """The luma plane filtered by one clip level's coefficients coef (25,
    12), every class at level lvl.  The reference filters it in the
    aligned-feature form (:443-450); that equals apply_alf's transposed
    coefficient table, as every transpose permutation is an involution."""
    idx = torch.full((NUM_CLASSES,), lvl, dtype=torch.int32,
                     device=recon.device)
    return apply_alf(recon, cls, coef, flags, bit_depth, tr, idx)


def estimate_alf_nonlinear(orig, recon, lam: float, bit_depth: int = 8,
                           with_sse: bool = False):
    """Nonlinear, transposed luma estimation (:405-476): per clip level
    the clipped, aligned per-class Wiener filters and the plane they
    filter; each class keeps the level whose blocks' SSE is least (the
    first on a tie).  Returns (coeffs (25, 12), clip_idx (25,), ctb_flags
    (Cy, Cx), filtered (H, W)) int32, with_sse also the (4, 25) float32
    per-class SSEs."""
    orig = orig.to(torch.int32)
    recon = recon.to(torch.int32)
    h, w = orig.shape
    cls, tr = classify_full(recon)
    all_on = torch.ones((-(-h // 64), -(-w // 64)), dtype=torch.int32,
                        device=orig.device)
    levels = clip_levels(bit_depth)
    # each level's plane written straight into one buffer of the samples'
    # width (the class SSE kernel reads 8-bit levels as bytes)
    filts = torch.empty((len(levels), h, w), device=orig.device,
                        dtype=torch.uint8 if bit_depth <= 8 else torch.int16)
    coefs = []
    for lvl, v in enumerate(levels):
        coef = normal_solve(recon, orig, cls, bit_depth=bit_depth, clip=v,
                            transpose=tr)
        filts[lvl] = level_plane(recon, cls, tr, coef, lvl, all_on,
                                 bit_depth)
        coefs.append(coef)
    sse = class_sse(filts, orig, cls)
    clip_idx = torch.argmin(sse, 0).to(torch.int32)
    coeffs = torch.stack(coefs)[clip_idx.long(),
                                torch.arange(NUM_CLASSES, device=orig.device)]
    filt = apply_alf(recon, cls, coeffs, all_on, bit_depth, tr, clip_idx)
    flags = ctb_flags(filt, recon, orig, 64, lam)
    out = (coeffs, clip_idx, flags,
           apply_alf(recon, cls, coeffs, flags, bit_depth, tr, clip_idx))
    return out + (sse,) if with_sse else out


def estimate_alf_chroma_nl(orig, recon, lam: float, bit_depth: int = 8,
                           with_sse: bool = False):
    """Nonlinear chroma estimation (:302-344): the Wiener filter at each
    clip level; the plane keeps the level whose filtered plane's float32
    SSE (kernels.cost.plane_sse_f32, F4's order) is least.  Returns
    (coeffs (6,), clip_lvl () int32, flags (Cy, Cx), filtered), with_sse
    also the (4,) SSEs."""
    from x266_tpu_torch.kernels.cost import plane_sse_f32

    orig = orig.to(torch.int32)
    recon = recon.to(torch.int32)
    h, w = orig.shape
    all_on = torch.ones((-(-h // 32), -(-w // 32)), dtype=torch.int32,
                        device=orig.device)
    coefs, filts = [], []
    for lvl, v in enumerate(clip_levels(bit_depth)):
        coef = normal_solve(recon, orig, bit_depth=bit_depth, clip=v)[0]
        filts.append(apply_alf_chroma(recon, coef, all_on, bit_depth, lvl))
        coefs.append(coef)
    planes = torch.stack(filts).to(torch.uint8)
    sse = plane_sse_f32(planes, orig.to(torch.uint8).expand_as(planes)
                        .contiguous())
    lvl = torch.argmin(sse).to(torch.int32)
    # index_select: indexing by a 0-dim tensor reads it on the host
    coeffs = torch.stack(coefs).index_select(0, lvl.long().reshape(1))[0]
    filt = apply_alf_chroma(recon, coeffs, all_on, bit_depth, lvl)
    flags = ctb_flags(filt, recon, orig, 32, lam)
    out = (coeffs, lvl, flags,
           apply_alf_chroma(recon, coeffs, flags, bit_depth, lvl))
    return out + (sse,) if with_sse else out


def estimate_ccalf(orig_c, c, luma, lam: float, bit_depth: int = 8):
    """CC-ALF of one chroma plane (:526-563): the 7-tap Wiener filter from
    the post-SAO, pre-ALF luma, its per-CTB flags and the whole-filter
    gate, which zeroes coefficients and flags unless the kept CTBs' gain
    pays for them.  Returns (coeffs (7,), flags (Cy, Cx), filtered)
    int32."""
    orig_c = orig_c.to(torch.int32)
    c = c.to(torch.int32)
    luma = luma.to(torch.int32)
    ch, cw = orig_c.shape
    coeffs = cc_normal_solve(luma, c, orig_c)[0]
    all_on = torch.ones((-(-ch // 32), -(-cw // 32)), dtype=torch.int32,
                        device=c.device)
    filt = apply_ccalf(c, luma, coeffs, all_on, bit_depth)
    flags, worth = ccalf_gate(filt, c, orig_c, lam)
    coeffs = torch.where(worth, coeffs, 0)
    flags = torch.where(worth, flags, 0)
    return coeffs, flags, apply_ccalf(c, luma, coeffs, flags, bit_depth)
