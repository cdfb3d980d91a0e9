"""Intra prediction (C6), as x266_tpu/kernels/intra.py:47-206.

All modes of B blocks are one matmul of the [raw, smoothed] reference
vectors against the stacked integer weights (Tables.intra_w).  The
matmul runs in float32: references <= 255 and per-row weights summing to
at most 2^6 keep every partial sum an integer below 2^24, so the result
is exact as long as TF32 is off (device.check_precision).  PDPC and MIP
are outside this slice.
"""

from __future__ import annotations

import numpy as np
import torch

from x266_tpu_torch.tables import Tables


def _subst_perm(size: int):
    """Substitution scan over the [corner, top 2s, left 2s] layout: the
    left column bottom->top, then the corner, then the top row."""
    s = size
    perm = np.concatenate([np.arange(4 * s, 2 * s, -1), [0],
                           np.arange(1, 2 * s + 1)])
    return perm, np.argsort(perm)


def substitute_refs(refs: torch.Tensor, mask: torch.Tensor,
                    mid: int) -> torch.Tensor:
    """HEVC-style reference substitution [STD 8.4.4.2.2]: each
    unavailable entry (mask False) takes the nearest preceding available
    entry in the scan order; entries before the first available take the
    first available; a fully unavailable vector reads mid."""
    s = (refs.shape[-1] - 1) // 4
    perm, inv = _subst_perm(s)
    perm = torch.from_numpy(perm).to(refs.device)
    inv = torch.from_numpy(inv).to(refs.device)
    v = refs[..., perm]
    m = mask[..., perm]
    j = torch.arange(v.shape[-1], device=refs.device)
    last_av = torch.cummax(torch.where(m, j, -1), dim=-1).values
    first_av = torch.argmax(m.to(torch.int32), dim=-1, keepdim=True)
    src = torch.where(last_av >= 0, last_av, first_av)
    filled = torch.gather(v, -1, src)
    filled = torch.where(m.any(-1, keepdim=True), filled,
                         torch.full_like(filled, mid))
    return filled[..., inv]


def extend_refs(tab: Tables, refs: torch.Tensor, size: int) -> torch.Tensor:
    """(B, R) int32 raw refs -> (B, 2R) [raw, smoothed]."""
    sm = torch.matmul(refs.to(torch.float32), tab.smooth[size].T)
    sm = (sm.to(torch.int32) + 2) >> 2
    return torch.cat([refs.to(torch.int32), sm], dim=-1)


def _check_tools(pdpc: bool) -> None:
    if pdpc:
        raise NotImplementedError("PDPC is not in the port's slices")


def predict_all_modes(tab: Tables, refs: torch.Tensor, size: int,
                      pdpc: bool = False) -> torch.Tensor:
    """(B, R) int32 reference vectors -> (B, n_modes, s, s) int32."""
    _check_tools(pdpc)
    w = tab.intra_w[size]                             # (nm, s*s, 2R)
    nm = w.shape[0]
    ext = extend_refs(tab, refs, size).to(torch.float32)
    p = torch.matmul(ext, w.reshape(nm * size * size, -1).T)
    p = p.to(torch.int32).reshape(-1, nm, size * size)
    sh = tab.intra_shift[size][None, :, None]
    p = (p + (1 << (sh - 1))) >> sh
    return p.reshape(-1, nm, size, size)


def predict_mode(tab: Tables, ref: torch.Tensor, mode: int, size: int,
                 pdpc: bool = False) -> torch.Tensor:
    """One (R,) reference vector and a mode -> (s, s) int32."""
    _check_tools(pdpc)
    ext = extend_refs(tab, ref[None], size)[0].to(torch.float32)
    p = torch.matmul(tab.intra_w[size][mode], ext).to(torch.int32)
    sh = tab.intra_shift_host[size][mode]
    return ((p + (1 << (sh - 1))) >> sh).reshape(size, size)
