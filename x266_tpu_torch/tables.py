"""The codec's parameters, carried across from the reference.

A codec has no learned weights: its parameters are the static integer
tables built with numpy in ``specmodel`` (the port's copy of the
reference's).
``from_reference(cfg, device)`` turns them into the port's tensors once
per session; the torch functions take the resulting ``Tables`` as an
argument, and the CUDA kernel reads the flat int32 copies (``k_*``).

Two tables are new: ``rate`` (data/rate_f32.npy), the float32 rate
surrogate evaluated by JAX (tools/make_torch_rate_table.py), because
float32 ``log2`` differs between XLA and PyTorch in the last bit; and
``k_mip``, MIP's trained matrices over the 16 boundary group sums, which
the kernel applies directly instead of their 4s-tap raw-reference rows.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from x266_tpu_torch.config import CodecConfig
from x266_tpu_torch.kernels.lfnst_tables import TABLES as LFNST_TABLES
from x266_tpu_torch.specmodel import intra as spec_intra
from x266_tpu_torch.specmodel import transforms as spec_tx
from x266_tpu_torch.specmodel.mip_tables import TABLES as MIP_TABLES
from x266_tpu_torch.specmodel.quant import DEQUANT_SCALES, QUANT_SCALES

RATE_PATH = os.path.join(os.path.dirname(__file__), "data", "rate_f32.npy")

# MTS candidate set (C10, VVC-shaped): index -> (vertical, horizontal);
# 0 is the DCT-II pair, as in x266_tpu/kernels/transforms.py.
MTS_COMBOS = ((spec_tx.TX_DCT2, spec_tx.TX_DCT2),
              (spec_tx.TX_DST7, spec_tx.TX_DST7),
              (spec_tx.TX_DCT8, spec_tx.TX_DST7),
              (spec_tx.TX_DST7, spec_tx.TX_DCT8),
              (spec_tx.TX_DCT8, spec_tx.TX_DCT8))
TX_TYPES = (spec_tx.TX_DCT2, spec_tx.TX_DST7, spec_tx.TX_DCT8)
TU_SIZES = (4, 8, 16, 32)
CU64 = 64         # the luma TU of a 64x64 CU (max_cu_size=64), DCT-II only
MIP_SIZES = (8, 16, 32)   # luma TU sizes; a chroma TU of a MIP CU is planar
N_TAPS = 4        # nonzero weights per predicted sample, DC excepted


def tu_sizes(cfg: CodecConfig) -> tuple:
    """The TU sizes of cfg's tables: TU_SIZES, and CU64 when
    cfg.max_cu_size is 64 (its weights are 141 M entries, so they are
    built for such configurations only)."""
    return TU_SIZES + ((CU64,) if cfg.max_cu_size == CU64 else ())


@functools.lru_cache(maxsize=8)
def _stacked(size: int, n_modes: int):
    """specmodel.intra.stacked_weights, made once a process (the 64
    weights take about a second)."""
    return spec_intra.stacked_weights(size, n_modes)


@functools.lru_cache(maxsize=8)
def intra_taps(size: int, n_modes: int) -> np.ndarray:
    """(n_modes, s*s, N_TAPS) int32 sparse form of the stacked weights of
    the analytic modes (n_modes <= 67; MIP's signed rows are k_mip's):
    each entry packs (index into [raw, smoothed] << 8) | weight, 0 for
    an unused slot.  DC (mode 1) rows have 2s taps and are left empty:
    the kernel sums its references directly (checked here)."""
    assert n_modes <= spec_intra.NUM_MODES_VVC
    w, _ = _stacked(size, n_modes)
    r = spec_intra.ref_len(size)
    dc = np.zeros(2 * r, np.int8)
    dc[1:1 + size] = 1
    dc[1 + 2 * size:1 + 3 * size] = 1
    assert (w[spec_intra.DC] == dc).all()
    m, p, c = np.nonzero(w)                   # sorted by (mode, sample)
    keep = m != spec_intra.DC
    m, p, c = m[keep], p[keep], c[keep]
    v = w[m, p, c].astype(np.int32)
    row = m * size * size + p
    rank = np.arange(row.size) - np.searchsorted(row, row)
    assert rank.max() < N_TAPS and (v > 0).all()
    taps = np.zeros((n_modes, size * size, N_TAPS), np.int32)
    taps[m, p, rank] = (c << 8) | v
    return taps


def smooth_taps(size: int) -> np.ndarray:
    """(R, 3) int32 sparse rows of the [1,2,1] smoothing matrix, packed
    as intra_taps (index << 8 | weight)."""
    sm = spec_intra.smoothing_matrix(size)
    taps = np.zeros((sm.shape[0], 3), np.int32)
    for i in range(sm.shape[0]):
        nz = np.flatnonzero(sm[i])
        assert len(nz) <= 3 and sm[i].sum() == 4
        taps[i, :len(nz)] = (nz << 8) | sm[i, nz]
    return taps


def mip_matrices(size: int) -> np.ndarray:
    """(MIP_K, s*s, 16) int32: MIP mode k's weights over the 16 boundary
    group sums (group g adds the s/4 raw references body[g*s/4:(g+1)*s/4],
    body = [top 2s, left 2s]); pred = (M @ sums + 2^(sh-1)) >> sh with
    sh = log2 s + 4.  The same integers as specmodel.intra's dense
    raw-reference rows (checked here), so both forms give the same
    prediction bit for bit."""
    m = MIP_TABLES[size].astype(np.int32)
    g = size // 4
    for k in range(m.shape[0]):
        dense = spec_intra.mip_weight_matrix(size, k)
        assert (dense[:, 1:] == np.repeat(m[k], g, axis=1)).all()
        assert (dense[:, 0] == 0).all()
    return m


def check_passa_exact(w: np.ndarray) -> None:
    """Pass A's float32 product of (n_modes, s*s, 2R) integer weights
    with references <= 255 is exact when every partial sum is an
    integer of magnitude below 2^24: assert sum |w| * 255 < 2^24 per
    row (the MIP rows at s = 32 reach ~4.1e6; DC's 128 references at
    s = 64 reach 32,640), a mode at a time (the 64 weights are 141 M
    entries)."""
    assert max(int(np.abs(wm.astype(np.int32)).sum(-1).max())
               for wm in w) * 255 < 1 << 24


@dataclass
class Tables:
    """Per-session tensors on one device.

    intra_w[s]: (n_modes, s*s, 2R) float32 stacked weights (exact: all
    products and partial sums are integers below 2^24, check_passa_exact;
    MIP's modes are rows n_intra_modes and up), int8 at s = 64 (564 MB
    as float32; kernels.intra widens them a few modes at a time), which
    only a max_cu_size=64 configuration has (tu_sizes); intra_shift[s]:
    (n_modes,) int32 (intra_shift_host[s]: the same as a tuple, so a
    per-TU lookup needs no device read); smooth[s]: (R, R) float32;
    tx[(type, s)]: (s, s) float64 transform matrices; rate: (32768,)
    float32.  k_taps / k_smooth / k_tx / k_shift / k_mip: the flat int32
    tables of the CUDA kernel (kernel_tables); k_lfnst: LFNST's (8, 16,
    16) int32 kernels (kernels/lfnst_tables.py, |m| <= 127).  cu64: the
    64 tables are there, in tu_sizes and appended to the kernel's
    (kernel_tables)."""
    device: torch.device
    n_modes: int
    intra_w: dict
    intra_shift: dict
    intra_shift_host: dict
    smooth: dict
    tx: dict
    rate: torch.Tensor
    quant_scales: tuple
    dequant_scales: tuple
    k_taps: torch.Tensor
    k_smooth: torch.Tensor
    k_tx: torch.Tensor
    k_shift: torch.Tensor
    k_mip: torch.Tensor
    k_lfnst: torch.Tensor
    cu64: bool = False


def kernel_tables(n_modes: int, cu64: bool = False):
    """Flat int32 tables for the CUDA kernel, sizes in TU_SIZES order:
    taps of the analytic modes (sum_s n_std*s*s*N_TAPS, n_std =
    min(n_modes, 67)), smoothing taps (sum_s (4s+1)*3), transform
    matrices (3 types x sum_s s*s), shifts (4 x n_modes) and the MIP
    matrices (MIP_K x sum over MIP_SIZES of s*s*16; all zero without
    MIP modes, never read).  cu64 appends the 64 size to the first four:
    its taps, its smoothing taps, the DCT-II matrix (a 64 TU takes no
    other) and its shifts, so the other sizes keep their offsets."""
    n_std = min(n_modes, spec_intra.NUM_MODES_VVC)
    big = (CU64,) if cu64 else ()
    taps = np.concatenate([intra_taps(s, n_std).ravel()
                           for s in TU_SIZES + big])
    smooth = np.concatenate([smooth_taps(s).ravel()
                             for s in TU_SIZES + big])
    tx = np.concatenate([spec_tx.matrix_for(t, s).astype(np.int32).ravel()
                         for t in TX_TYPES for s in TU_SIZES]
                        + [spec_tx.matrix_for(spec_tx.TX_DCT2, s).astype(
                            np.int32).ravel() for s in big])
    # the recon kernel keeps the matrices in shared memory as int8
    assert np.abs(tx).max() <= 127
    shift = np.concatenate([_stacked(s, n_modes)[1]
                            for s in TU_SIZES + big]).astype(np.int32)
    mip = np.concatenate([mip_matrices(s).ravel() for s in MIP_SIZES])
    if n_modes <= spec_intra.NUM_MODES_VVC:
        mip = np.zeros_like(mip)
    return taps, smooth, tx, shift, mip


def from_reference(cfg: CodecConfig, device) -> Tables:
    device = torch.device(device)
    n_modes = cfg.n_pred_modes
    intra_w, intra_shift, shift_host, smooth, tx = {}, {}, {}, {}, {}
    for s in tu_sizes(cfg):
        w, sh = _stacked(s, n_modes)
        check_passa_exact(w)
        intra_w[s] = torch.from_numpy(
            w if s == CU64 else w.astype(np.float32)).to(device)
        intra_shift[s] = torch.from_numpy(sh.astype(np.int32)).to(device)
        shift_host[s] = tuple(int(v) for v in sh)
        smooth[s] = torch.from_numpy(
            spec_intra.smoothing_matrix(s).astype(np.float32)).to(device)
        for t in TX_TYPES:
            m = spec_tx.matrix_for(t, s).astype(np.float64)
            assert np.abs(m).max() <= 255
            tx[(t, s)] = torch.from_numpy(m).to(device)
    rate = torch.from_numpy(np.load(RATE_PATH)).to(device)
    cu64 = CU64 in tu_sizes(cfg)
    k = [torch.from_numpy(a).to(device)
         for a in kernel_tables(n_modes, cu64)]
    # the recon kernel keeps the LFNST kernels in shared memory as int8
    assert np.abs(LFNST_TABLES).max() <= 127
    lfnst = torch.from_numpy(np.ascontiguousarray(LFNST_TABLES,
                                                  np.int32)).to(device)
    return Tables(device, n_modes, intra_w, intra_shift, shift_host, smooth,
                  tx, rate,
                  tuple(int(v) for v in QUANT_SCALES),
                  tuple(int(v) for v in DEQUANT_SCALES), *k, lfnst, cu64)
