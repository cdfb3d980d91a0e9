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
  into a loop (B Pass A's transform-domain error sums, ROADMAP F10).
"""

from __future__ import annotations

import torch

from x266_tpu_torch.tables import Tables


def sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared integer differences over the trailing 2 dims."""
    d = a.to(torch.int64) - b.to(torch.int64)
    return (d * d).sum((-2, -1)).to(torch.float32)


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


def row_vector_sum(v: torch.Tensor) -> torch.Tensor:
    """float32 sum over the trailing (s, s) dims, s a multiple of 8, in
    the order LLVM gives XLA CPU's row loop of a reduction it emits
    element by element: row by row, the row's s/8 8-wide vectors are
    added in order into an 8-lane vector whose lane 0 starts at the
    running sum, which then folds in halves into the new running sum.
    Lanes 1-7 do not depend on the running sum, so they are added for
    all rows at once.  XLA CPU emits a reduction so when it is nested in
    a loop fusion (B Pass A's error sums, F10) or for 32x32 sums (the
    rate sums, F2; the CTB SSE of 32-wide planes, F9)."""
    s = v.shape[-1]
    rows = v[..., 0:8]
    for j in range(8, s, 8):
        rows = rows + v[..., j:j + 8]
    l4 = rows[..., 4]
    l26 = rows[..., 2] + rows[..., 6]
    odd = (rows[..., 1] + rows[..., 5]) + (rows[..., 3] + rows[..., 7])
    acc = torch.zeros(v.shape[:-2], dtype=torch.float32, device=v.device)
    for r in range(v.shape[-2]):
        t0 = acc + v[..., r, 0]
        for j in range(8, s, 8):
            t0 = t0 + v[..., r, j]
        acc = ((t0 + l4[..., r]) + l26[..., r]) + odd[..., r]
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
