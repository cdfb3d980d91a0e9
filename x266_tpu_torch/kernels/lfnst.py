"""LFNST (C10): the secondary non-separable transform on the top-left
4x4 of a luma TU's DCT-II coefficients, forward between the primary
transform and the quantizer, inverse between dequantization and the
primary inverse.

Counterpart of x266_tpu/kernels/lfnst.py:39-115.  Four transform sets by
the intra mode's angular class (planar/DC, then three classes of the
angular range folded across the diagonal; MIP modes take the planar
class), two trained 16x16 kernels a set (kernels/lfnst_tables.py, the
reference's own integers at 1 << 7 scale), lfnst_idx 1 or 2 a TU; modes
past the diagonal transpose the 4x4 region.  The rest of the block
passes through, and so does a TU with lfnst_idx 0.  The matrix-vector
product is exact integer arithmetic (|m| <= 127, |v| <= 2^15, so 16
products sum below 2^27), here in float64, exact below 2^53 (CUDA has
no integer matmul); the reference's float32 limbs give the same
integers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from x266_tpu_torch.kernels.lfnst_tables import TABLES  # (8, 16, 16)

LFNST_SCALE_BITS = 7
N_SETS = 4


def mode_class(mode: torch.Tensor, n_modes: int):
    """intra modes -> (set 0..3 int64, transpose bool): planar and DC set
    0; angular modes past the diagonal transpose, fold back across it and
    split [2, diag] into three equal classes; with MIP's alphabet
    (n_modes > 67) modes >= 67 count as planar."""
    diag = 18 if n_modes == 35 else 34
    mode = mode.to(torch.int64)
    if n_modes > 67:
        mode = torch.where(mode >= 67, torch.zeros_like(mode), mode)
    t = mode > diag
    a = torch.where(t, 2 * diag - mode, mode).clamp(2, diag)
    s = 1 + torch.clamp((3 * (a - 2)) // (diag - 1), max=2)
    s = torch.where(mode <= 1, torch.zeros_like(s), s)
    return s, t & (mode > 1)


@functools.cache
def _tables(device: torch.device) -> torch.Tensor:
    """TABLES as float64 on device, uploaded once."""
    return torch.from_numpy(np.ascontiguousarray(TABLES, np.float64)).to(
        device)


def _select_mats(modes: torch.Tensor, lfnst_idx: torch.Tensor,
                 n_modes: int, inverse: bool) -> torch.Tensor:
    """Each block's kernel, (B, 16, 16) float64 of integers: set * 2 +
    idx - 1 (idx 0 selects kernel 0 of its set, unused), transposed for
    the inverse."""
    s, _ = mode_class(modes, n_modes)
    kidx = s * 2 + (lfnst_idx.to(torch.int64).clamp(min=1) - 1)
    tabs = _tables(modes.device)
    if inverse:
        tabs = tabs.transpose(1, 2)
    return tabs[kidx]


def _apply(coef: torch.Tensor, modes, lfnst_idx, n_modes: int,
           inverse: bool) -> torch.Tensor:
    """(B, s, s) coefficients (or one (s, s) block with scalar mode and
    index): the top-left 4x4 transformed where lfnst_idx > 0."""
    if coef.dim() == 2:
        return _apply(coef[None], torch.as_tensor(modes).reshape(1),
                      torch.as_tensor(lfnst_idx).reshape(1), n_modes,
                      inverse)[0]
    b = coef.shape[0]
    modes = torch.as_tensor(modes, device=coef.device)
    lfnst_idx = torch.as_tensor(lfnst_idx, device=coef.device)
    _, t = mode_class(modes, n_modes)
    low = coef[:, :4, :4]
    tt = t[:, None, None]
    lowt = torch.where(tt, low.transpose(1, 2), low)
    vec = lowt.reshape(b, 16, 1).to(torch.float64)
    # exact in float64 (|sum| < 2^27), which CUDA multiplies where it has
    # no integer matmul
    out = torch.matmul(_select_mats(modes, lfnst_idx, n_modes, inverse),
                       vec)[..., 0].to(torch.int64)
    out = (out + (1 << (LFNST_SCALE_BITS - 1))) >> LFNST_SCALE_BITS
    out = out.clamp(-32768, 32767).reshape(b, 4, 4).to(coef.dtype)
    out = torch.where(tt, out.transpose(1, 2), out)
    new_low = torch.where((lfnst_idx > 0)[:, None, None], out, low)
    res = coef.clone()
    res[:, :4, :4] = new_low
    return res


def lfnst_fwd(coef, modes, lfnst_idx, n_modes: int) -> torch.Tensor:
    """Encoder: primary coefficients -> secondary, where lfnst_idx > 0."""
    return _apply(coef, modes, lfnst_idx, n_modes, inverse=False)


def lfnst_inv(coef, modes, lfnst_idx, n_modes: int) -> torch.Tensor:
    """Decoder and encoder recon: dequantized -> primary-domain
    coefficients, where lfnst_idx > 0."""
    return _apply(coef, modes, lfnst_idx, n_modes, inverse=True)
