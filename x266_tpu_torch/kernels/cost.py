"""Encoder cost metrics (C9), as x266_tpu/kernels/cost.py:14-45.

Encoder-only, so float32 is allowed, but the port must rank candidates
exactly as the reference does:

- ``sse`` / SAD of integer residuals are summed in int64 and cast to
  float32.  That equals the reference's float32 sum whenever the sum is
  below 2^24, which a block's SSE is unless its error is extreme.
- ``rate_estimate_levels`` reads each level's rate from Tables.rate and
  adds the float32 terms in the order XLA's CPU backend does for an
  (s, s) block, so the sums equal the reference's bit for bit
  (``xla_cpu_sum``).
- ``row_vector_sum`` is XLA CPU's order for a reduction that it fuses
  into a loop (B Pass A's transform-domain error sums, ROADMAP F10);
  ``rate_nested`` and ``rd_cost`` the rate sums and the fused D + lam * R
  of the argmin fusions (intra Pass A, F12; P and B Pass A, F13),
  ``fma_f32`` any float32 fused multiply-add, and
  ``rate_inter_residual`` the lossless inter rates (F13).
- ``plane_sse_f32`` is the reference's float32 SSE of a whole picture
  plane (x266_tpu/engine/fused.py:483-486) in XLA CPU's order, reported
  beside the exact int64 sum (ROADMAP F4).
"""

from __future__ import annotations

import numpy as np
import torch

from x266_tpu_torch.tables import Tables


def sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared integer differences over the trailing 2 dims."""
    d = a.to(torch.int64) - b.to(torch.int64)
    return (d * d).sum((-2, -1)).to(torch.float32)


# XLA CPU rewrites a reduction longer than 32 along a dimension into a
# tree: 32x32 windows, each summed in raster order, over the plane padded
# with zeros to whole windows (the pad split evenly, the odd element at
# the end), until both dimensions are at most 32 (read from its optimized
# HLO and LLVM IR; tests/test_torch_kernels_fn.py holds it to live XLA
# from 64x64 to 3840x2160).
_TREE_WINDOW = 32


def _fold(t: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing lanes by halving: (t0+t4)+(t2+t6) and so on."""
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """s <= 16: rows are lanes, eight at a time, each lane accumulating
    along its row; the lanes then fold in halves."""
    s = v.shape[-1]
    lanes = min(s, 8)
    blocks = v.reshape(*v.shape[:-2], s // lanes, lanes, s)
    acc = torch.zeros(v.shape[:-2] + (lanes,), dtype=torch.float32,
                      device=v.device)
    for yb in range(s // lanes):
        for x in range(s):
            acc = acc + blocks[..., yb, :, x]
    return _fold(acc)


def row_lane_sum(v: torch.Tensor) -> torch.Tensor:
    """float32 sum over the trailing (s, s) dims, s <= 16: each row is a
    lane that adds its samples in order from 0, then the s lanes fold in
    halves (_lane_sum's order at 8x8, with all 16 rows as lanes at
    16x16)."""
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    for x in range(v.shape[-1]):
        acc = acc + v[..., x]
    return _fold(acc)


def row_vector_sum(v: torch.Tensor, width: int = 8) -> torch.Tensor:
    """float32 sum over the trailing (s, s) dims, s a multiple of width,
    in the order LLVM gives XLA CPU's row loop of a reduction it emits
    element by element: row by row, the row's s/width width-wide vectors
    are added in order into a width-lane vector whose lane 0 starts at
    the running sum, which then folds in halves into the new running
    sum.  The other lanes do not depend on the running sum, so their
    partial sums that join lane 0 in the fold are formed for all rows at
    once.  XLA CPU emits a reduction so when it is nested in a loop
    fusion (B Pass A's error sums, F10; the rate sums of the argmin
    fusions, F12, F13) or for 32x32 sums (the rate sums, F2; the CTB SSE
    of 32-wide planes, F9): 8-wide vectors there, 16-wide in the lossless
    inter rates (F13)."""
    s = v.shape[-1]
    t = v[..., 0:width]
    for j in range(width, s, width):
        t = t + v[..., j:j + width]
    parts = []                     # what joins lane 0 at each fold step
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        parts.append(t[..., h])
        t = t[..., :h] + t[..., h:]
    acc = torch.zeros(v.shape[:-2], dtype=torch.float32, device=v.device)
    for r in range(v.shape[-2]):
        t0 = acc + v[..., r, 0]
        for j in range(width, s, width):
            t0 = t0 + v[..., r, j]
        for part in parts:
            t0 = t0 + part[..., r]
        acc = t0
    return acc


def xla_cpu_sum(v: torch.Tensor) -> torch.Tensor:
    """float32 sum over the trailing (s, s) dims in the order XLA's CPU
    backend emits for the reference's reduction (read from its optimized
    LLVM IR: 8-wide vectors, reassociated adds, a halving fold)."""
    return row_vector_sum(v) if v.shape[-1] == 32 else _lane_sum(v)


def rate_estimate_levels(tab: Tables, levels: torch.Tensor) -> torch.Tensor:
    """Surrogate coded bits of quantized levels over the trailing 2 dims:
    3 + 2*log2(|l|+1) per nonzero level, 1/16 per zero."""
    return xla_cpu_sum(tab.rate[levels.abs().long()])


def rate_nested(tab: Tables, levels: torch.Tensor) -> torch.Tensor:
    """rate_estimate_levels where XLA nests the sum in the loop fusion of
    the candidates' argmin or cost -- intra Pass A's and the transform
    select's costs (x266_tpu/engine/mode_decision.py:198-205, 495-508)
    and P and B Pass A's (x266_tpu/engine/inter.py:150-156, 377-383):
    added in row_vector_sum's order at every size.  Transposed residuals (modes
    17 and 51 of a symmetric block) tie in the standalone order and not
    in this one."""
    return row_vector_sum(tab.rate[levels.abs().long()])


def rd_cost(sse: torch.Tensor, lam: float, bits: torch.Tensor) -> torch.Tensor:
    """float32 D + lam * R as XLA CPU emits it in those argmin fusions:
    one fused multiply-add, rounded once.  Here the product and the sum
    in float64, exact (lam * bits has at most 48 significant bits, the
    integer SSE at most 24, within 53 of each other while the SSE stays
    below 2^25), then rounded to float32 once."""
    lam64 = float(np.float32(lam))
    return (sse.to(torch.float64) + lam64 * bits.to(torch.float64)).to(
        torch.float32)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (a fused multiply-add), from float64
    ops: the product is exact in float64; where the float64 sum lies
    exactly halfway between two float32 values its rounding error
    (TwoSum) decides, as the unrounded sum would."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    z = s - p
    t = (p - (s - z)) + (cd - z)
    r = s.float()
    rd = r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.where(s > rd, torch.nextafter(r, inf),
                        torch.nextafter(r, -inf))
    tie = (s != rd) & ((rd + other.double()) * 0.5 == s) & (t != 0)
    fix = torch.where(t > 0, torch.maximum(r, other),
                      torch.minimum(r, other))
    return torch.where(tie, fix, r)


def window_then_sum(v: torch.Tensor) -> torch.Tensor:
    """float32 sum over the trailing (s, s) dims in XLA CPU's order for
    Pass A's lossless rate (x266_tpu/engine/mode_decision.py:191-193),
    where XLA flattens the block: runs of 32 consecutive samples (raster
    order) are each added in order from 0, then the run sums are added
    in order from 0 (its reduce-window tree and the loop fusion of the
    cost, read from the optimized HLO and LLVM IR)."""
    flat = v.reshape(*v.shape[:-2], -1)
    n = flat.shape[-1]
    runs = flat.reshape(*flat.shape[:-1], -1, min(n, _TREE_WINDOW))
    acc = torch.zeros(runs.shape[:-1], dtype=torch.float32, device=v.device)
    for k in range(runs.shape[-1]):
        acc = acc + runs[..., k]
    tot = torch.zeros(acc.shape[:-1], dtype=torch.float32, device=v.device)
    for k in range(acc.shape[-1]):
        tot = tot + acc[..., k]
    return tot


def rate_inter_residual(tab: Tables, res: torch.Tensor,
                        bi: bool = False) -> torch.Tensor:
    """rate_estimate_levels of a lossless inter residual (P and B Pass A,
    x266_tpu/engine/inter.py:143, 360), summed in the order of the loop
    fusion XLA CPU makes of the MC gather, the surrogate and the sum
    (read from its optimized LLVM IR): for 8x8 and 16x16 blocks each row
    is a lane (row_lane_sum); for 32x32, and for the 16x16
    bi-prediction candidate (the average of two gathers), a fold of
    16-wide vectors per row (row_vector_sum with width 16)."""
    bits = tab.rate[res.abs().long()]
    s = res.shape[-1]
    if s == 8 or (s == 16 and not bi):
        return row_lane_sum(bits)
    return row_vector_sum(bits, 16)


def rate_estimate_residual(tab: Tables, res: torch.Tensor) -> torch.Tensor:
    """rate_estimate_levels of a lossless residual (the residual is
    coded as levels), summed in window_then_sum's order."""
    return window_then_sum(tab.rate[res.abs().long()])


def _window_sums(v: torch.Tensor) -> torch.Tensor:
    """One level of the tree: (N, H, W) float32 -> (N, ceil(H/32),
    ceil(W/32)) window sums, each window added in raster order from 0; a
    dimension of at most 32 is one window."""
    n, h, w = v.shape

    def geom(d):
        if d <= _TREE_WINDOW:
            return d, 0, 1
        m = -(-d // _TREE_WINDOW)
        return _TREE_WINDOW, (m * _TREE_WINDOW - d) // 2, m

    wh, ph, nh = geom(h)
    ww, pw, nw = geom(w)
    v = torch.nn.functional.pad(v, (pw, nw * ww - w - pw,
                                    ph, nh * wh - h - ph))
    blocks = v.reshape(n, nh, wh, nw, ww).permute(0, 1, 3, 2, 4).reshape(
        n, nh, nw, wh * ww)
    acc = torch.zeros((n, nh, nw), dtype=torch.float32, device=v.device)
    for k in range(wh * ww):
        acc = acc + blocks[..., k]
    return acc


def _final_sum(v: torch.Tensor) -> torch.Tensor:
    """(N, a, b) float32, a, b <= 32 -> (N,): the last reduction, which
    XLA CPU fuses into the loop that stacks the three planes' sums.  LLVM
    vectorizes it across rows when there are 2 or 4 of them (each lane
    adds its row in order, then the lanes fold in halves); otherwise the
    elements are added in raster order."""
    n, a, b = v.shape
    if a in (2, 4):
        rows = torch.zeros((n, a), dtype=torch.float32, device=v.device)
        for j in range(b):
            rows = rows + v[..., j]
        return _fold(rows)
    flat = v.reshape(n, a * b)
    acc = torch.zeros((n,), dtype=torch.float32, device=v.device)
    for k in range(a * b):
        acc = acc + flat[:, k]
    return acc


def plane_sse_f32(rec: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    """(N, H, W) uint8 planes -> (N,) float32 SSE in the reference's
    order: kernel SSE (kernels/sse_cuda.py) for CUDA tensors,
    plane_sse_f32_plain for CPU ones."""
    if orig.device.type == "cuda":
        from x266_tpu_torch.kernels import sse_cuda
        return sse_cuda.picture_sse([rec], [orig])[0][:, 0]
    return plane_sse_f32_plain(rec, orig)


def plane_sse_f32_plain(rec: torch.Tensor,
                        orig: torch.Tensor) -> torch.Tensor:
    """plane_sse_f32 in torch ops: the squares in float32, then XLA
    CPU's reduction tree (one op per element of a window)."""
    d = (rec.to(torch.int32) - orig.to(torch.int32)).to(torch.float32)
    v = d * d
    while max(v.shape[1:]) > _TREE_WINDOW:
        v = _window_sums(v)
    return _final_sum(v)
