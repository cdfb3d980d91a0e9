"""Intra prediction (C6), as x266_tpu/kernels/intra.py:47-206.

All modes of B blocks are one matmul of the [raw, smoothed] reference
vectors against the stacked integer weights (Tables.intra_w), MIP's
modes included (rows n_intra_modes and up).  The matmul runs in float32:
references <= 255 and |weights| summing to at most 2^14 per row
(tables.check_passa_exact) keep every partial sum an integer below
2^24, so the result is exact as long as TF32 is off
(device.check_precision).  The 64 weights are int8 (tables.Tables), widened
to float32 a few modes at a time.  PDPC (x266_tpu/kernels/intra.py:91-127,
162-190) blends planar, DC and pure H/V luma predictions with the raw
references after the shift.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from x266_tpu_torch.specmodel import intra as spec
from x266_tpu_torch.tables import Tables


def _subst_perm(size: int):
    """Substitution scan over the [corner, top 2s, left 2s] layout: the
    left column bottom->top, then the corner, then the top row."""
    s = size
    perm = np.concatenate([np.arange(4 * s, 2 * s, -1), [0],
                           np.arange(1, 2 * s + 1)])
    return perm, np.argsort(perm)


@functools.lru_cache(maxsize=None)
def _subst_perm_on(size: int, device: torch.device):
    """_subst_perm's (perm, inv) on device, uploaded once."""
    return tuple(torch.from_numpy(a).to(device) for a in _subst_perm(size))


def substitute_refs(refs: torch.Tensor, mask: torch.Tensor,
                    mid: int) -> torch.Tensor:
    """HEVC-style reference substitution [STD 8.4.4.2.2]: each
    unavailable entry (mask False) takes the nearest preceding available
    entry in the scan order; entries before the first available take the
    first available; a fully unavailable vector reads mid."""
    s = (refs.shape[-1] - 1) // 4
    perm, inv = _subst_perm_on(s, refs.device)
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


@functools.lru_cache(maxsize=None)
def _pdpc_consts(size: int, n_modes: int, device: torch.device):
    """(class per mode (nm,), weight per position (s,)) on device:
    specmodel.intra's PDPC classes and decay weights (wL = wT)."""
    cls = np.array([spec.pdpc_mode_class(m, n_modes)
                    for m in range(n_modes)], dtype=np.int32)
    wl, _ = spec.pdpc_weights(size)
    return (torch.from_numpy(cls).to(device),
            torch.from_numpy(wl.astype(np.int32)).to(device))


def apply_pdpc(pred: torch.Tensor, refs: torch.Tensor, modes: torch.Tensor,
               size: int, n_modes: int, left_ok: torch.Tensor,
               top_ok: torch.Tensor) -> torch.Tensor:
    """PDPC blend of (B, M, s, s) int32 predictions of modes (M,) with
    the RAW refs (B, R); left_ok / top_ok (B,) bool gate a side's terms
    off when its references lie outside the picture (x0 = 0 / y0 = 0),
    and the H/V gradient forms need both (specmodel.intra.apply_pdpc)."""
    s = size
    cls_all, w = _pdpc_consts(s, n_modes, refs.device)
    cls = cls_all[modes][None, :, None, None]               # (1, M, 1, 1)
    lok = left_ok.to(torch.int32)[:, None, None, None]
    tok = top_ok.to(torch.int32)[:, None, None, None]
    wl = w[None, None, None, :] * lok                       # by column x
    wt = w[None, None, :, None] * tok                       # by row y
    corner = refs[:, 0][:, None, None, None]
    top = refs[:, 1:1 + s][:, None, None, :]
    left = refs[:, 2 * s + 1:2 * s + 1 + s][:, None, :, None]
    both = (lok & tok) == 1
    pd = (wl * left + wt * top + (64 - wl - wt) * pred + 32) >> 6
    ver = (64 * pred + wl * (left - corner) + 32) >> 6
    hor = (64 * pred + wt * (top - corner) + 32) >> 6
    out = torch.where(cls == spec.PDPC_PD, pd, pred)
    out = torch.where(both & (cls == spec.PDPC_VER), ver, out)
    return torch.where(both & (cls == spec.PDPC_HOR), hor, out)


# the int8 64 weights' modes a product takes at once (67 MB widened)
_INT8_MODES = 8


def predict_all_modes(tab: Tables, refs: torch.Tensor, size: int,
                      pdpc: bool = False, left_ok=None,
                      top_ok=None) -> torch.Tensor:
    """(B, R) int32 reference vectors -> (B, n_modes, s, s) int32; with
    pdpc the blend of apply_pdpc, gated by left_ok / top_ok (B,) bool."""
    w = tab.intra_w[size]                             # (nm, s*s, 2R)
    nm = w.shape[0]
    ext = extend_refs(tab, refs, size).to(torch.float32)
    if w.dtype == torch.float32:
        p = torch.matmul(ext, w.reshape(nm * size * size, -1).T).to(
            torch.int32)
    else:
        # the int8 64 weights (564 MB as float32), a few modes at a time
        n = size * size
        p = torch.empty((ext.shape[0], nm * n), dtype=torch.int32,
                        device=ext.device)
        for m0 in range(0, nm, _INT8_MODES):
            c = w[m0:m0 + _INT8_MODES]
            p[:, m0 * n:(m0 + c.shape[0]) * n] = torch.matmul(
                ext, c.reshape(-1, c.shape[-1]).to(torch.float32).T)
    p = p.reshape(-1, nm, size * size)
    sh = tab.intra_shift[size][None, :, None]
    p = (p + (1 << (sh - 1))) >> sh
    p = p.reshape(-1, nm, size, size)
    if pdpc:
        modes = torch.arange(nm, device=refs.device)
        p = apply_pdpc(p, refs.to(torch.int32), modes, size, nm,
                       left_ok, top_ok)
    return p


def predict_mode(tab: Tables, ref: torch.Tensor, mode: int, size: int,
                 pdpc: bool = False, left_ok: bool = True,
                 top_ok: bool = True) -> torch.Tensor:
    """One (R,) reference vector and a mode -> (s, s) int32; with pdpc
    the blend of apply_pdpc, gated by left_ok / top_ok."""
    ext = extend_refs(tab, ref[None], size)[0].to(torch.float32)
    p = torch.matmul(tab.intra_w[size][mode].to(torch.float32), ext).to(
        torch.int32)
    sh = tab.intra_shift_host[size][mode]
    p = ((p + (1 << (sh - 1))) >> sh).reshape(size, size)
    if pdpc:
        dev = ref.device
        p = apply_pdpc(p[None, None], ref[None].to(torch.int32),
                       torch.tensor([mode], device=dev), size, tab.n_modes,
                       torch.tensor([left_ok], device=dev),
                       torch.tensor([top_ok], device=dev))[0, 0]
    return p
