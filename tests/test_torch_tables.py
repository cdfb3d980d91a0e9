"""The port's parameter tables equal the reference's (exact equality).

tables.from_reference must carry the JAX package's intra weights,
smoothing matrices, transform matrices and quantizer scales across
unchanged; rate_f32.npy must equal the JAX rate expression evaluated
again; the CUDA kernel's sparse tables must expand back to the dense
weights; the vectorized availability masks must equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu.config import CodecConfig, Profile
from x266_tpu.engine import availability as javail
from x266_tpu.kernels import intra as jintra
from x266_tpu.kernels import transforms as jtx
from x266_tpu.specmodel import intra as spec_intra
from x266_tpu.specmodel.quant import DEQUANT_SCALES, QUANT_SCALES
from x266_tpu_torch import tables
from x266_tpu_torch.engine import availability as tavail

PROFILES = [Profile.HEVC_SUBSET, Profile.VVC]


@pytest.mark.parametrize("profile", PROFILES, ids=lambda p: p.name)
def test_from_reference_equals_jax_tables(profile):
    cfg = CodecConfig(width=64, height=64, profile=profile)
    tab = tables.from_reference(cfg, "cpu")
    assert tab.n_modes == cfg.n_pred_modes
    for s in tables.TU_SIZES:
        w, sh, sm = jintra._consts(s, cfg.n_pred_modes)
        assert np.array_equal(tab.intra_w[s].numpy(), w.astype(np.float32))
        assert np.array_equal(tab.intra_shift[s].numpy(), sh)
        assert tab.intra_shift_host[s] == tuple(int(v) for v in sh)
        assert np.array_equal(tab.smooth[s].numpy(), sm.astype(np.float32))
        for t in tables.TX_TYPES:
            assert np.array_equal(tab.tx[(t, s)].numpy(),
                                  jtx._mat(t, s).astype(np.float64))
    assert tab.quant_scales == tuple(int(v) for v in QUANT_SCALES)
    assert tab.dequant_scales == tuple(int(v) for v in DEQUANT_SCALES)
    assert tables.MTS_COMBOS == jtx.MTS_COMBOS


def test_rate_table_equals_jax_expression():
    tab = np.load(tables.RATE_PATH)
    assert tab.dtype == np.float32 and tab.shape == (32768,)

    @jax.jit
    def rate(levels):
        al = jnp.abs(levels).astype(jnp.float32)
        return jnp.where(al > 0, 3.0 + 2.0 * jnp.log2(al + 1.0), 0.0625)

    want = np.asarray(rate(jnp.arange(32768, dtype=jnp.int32)))
    assert np.array_equal(tab, want)


@pytest.mark.parametrize("profile", PROFILES, ids=lambda p: p.name)
def test_kernel_tables_expand_to_dense_weights(profile):
    n_modes = CodecConfig(width=64, height=64, profile=profile).n_pred_modes
    taps, smooth, tx, shift = tables.kernel_tables(n_modes)
    off_t = off_s = off_x = 0
    for i, s in enumerate(tables.TU_SIZES):
        w, sh = spec_intra.stacked_weights(s, n_modes)
        r = spec_intra.ref_len(s)
        t = taps[off_t:off_t + n_modes * s * s * 4].reshape(n_modes, s * s, 4)
        dense = np.zeros_like(w, dtype=np.int32)
        m, p, k = np.nonzero(t)
        np.add.at(dense, (m, p, t[m, p, k] >> 8), t[m, p, k] & 255)
        dc = spec_intra.DC
        assert not t[dc].any()
        assert np.array_equal(np.delete(dense, dc, 0),
                              np.delete(w.astype(np.int32), dc, 0))
        sm = smooth[off_s:off_s + r * 3].reshape(r, 3)
        dsm = np.zeros((r, r), np.int32)
        rows = np.repeat(np.arange(r), 3)
        np.add.at(dsm, (rows, sm.ravel() >> 8), sm.ravel() & 255)
        assert np.array_equal(dsm, spec_intra.smoothing_matrix(s))
        assert np.array_equal(shift[i * n_modes:(i + 1) * n_modes], sh)
        off_t += n_modes * s * s * 4
        off_s += r * 3
    per_type = sum(s * s for s in tables.TU_SIZES)
    for ti, t in enumerate(tables.TX_TYPES):
        off_x = ti * per_type
        for s in tables.TU_SIZES:
            assert np.array_equal(tx[off_x:off_x + s * s].reshape(s, s),
                                  jtx._mat(t, s))
            off_x += s * s


@pytest.mark.parametrize("wh", [(104, 72), (128, 64), (96, 64)])
def test_vectorized_ref_masks_equal_reference(wh):
    w, h = wh
    for s, scale in ((8, 1), (16, 1), (32, 1), (4, 2), (8, 2), (16, 2)):
        assert np.array_equal(tavail.ref_masks(w, h, s, scale),
                              javail.ref_masks(w, h, s, scale=scale))


def test_tables_follow_device():
    tab = tables.from_reference(CodecConfig(width=64, height=64), "cpu")
    assert tab.device == torch.device("cpu")
    assert all(t.device.type == "cpu"
               for t in (tab.rate, tab.k_taps, tab.k_tx, tab.intra_w[32]))
