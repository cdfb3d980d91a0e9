"""Port kernel functions against x266_tpu.kernels and specmodel.

Same numpy inputs (seeded) through the JAX function and its PyTorch
counterpart.  Tolerance: exact equality everywhere, the float32 rate
sums included (the port adds them in XLA CPU's order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu.config import CodecConfig, Profile
from x266_tpu.kernels import cost as jcost
from x266_tpu.kernels import intra as jintra
from x266_tpu.kernels import quant as jquant
from x266_tpu.kernels import transforms as jtx
from x266_tpu.specmodel import transforms as spec_tx
from x266_tpu_torch import tables
from x266_tpu_torch.kernels import cost as tcost
from x266_tpu_torch.kernels import intra as tintra
from x266_tpu_torch.kernels import quant as tquant
from x266_tpu_torch.kernels import transforms as ttx

SIZES = (4, 8, 16, 32)
TX_PAIRS = [(v, h) for v in tables.TX_TYPES for h in tables.TX_TYPES]


@pytest.fixture(scope="module")
def tabs():
    return {p: tables.from_reference(CodecConfig(width=64, height=64,
                                                 profile=p), "cpu")
            for p in (Profile.HEVC_SUBSET, Profile.VVC)}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("size", SIZES)
def test_transforms_match_jax_and_spec(size, tabs):
    tab = tabs[Profile.VVC]
    rng = np.random.default_rng(size)
    res = rng.integers(-255, 256, (6, size, size)).astype(np.int32)
    # the largest-magnitude inputs: full-scale residual signs and the
    # int16 coefficient extremes
    res[0] = 255
    res[1] = np.where(rng.random((size, size)) < 0.5, -255, 255)
    coef = rng.integers(-32768, 32768, (6, size, size)).astype(np.int32)
    coef[0] = 32767
    coef[1] = -32768
    for tv, th in TX_PAIRS:
        f_j = np.asarray(jtx.forward_transform(jnp.asarray(res), size,
                                               tv, th))
        f_t = ttx.forward_transform(tab, _t(res), size, tv, th).numpy()
        assert np.array_equal(f_j, f_t), (tv, th)
        i_j = np.asarray(jtx.inverse_transform(jnp.asarray(coef), size,
                                               tv, th))
        i_t = ttx.inverse_transform(tab, _t(coef), size, tv, th).numpy()
        assert np.array_equal(i_j, i_t), (tv, th)
        for b in range(2):
            assert np.array_equal(
                f_t[b], spec_tx.forward_transform(res[b], tv, th))
            assert np.array_equal(
                i_t[b], spec_tx.inverse_transform(coef[b], tv, th))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("qp", [22, 32, 37])
def test_quant_and_rdoq_match_jax(size, qp, tabs):
    tab = tabs[Profile.VVC]
    rng = np.random.default_rng(qp * 100 + size)
    coef = (rng.laplace(0, 200, (8, size, size))
            .clip(-32768, 32767).astype(np.int32))
    coef[0, 0, :4] = [32767, -32768, 0, 1]
    lam = CodecConfig(width=64, height=64, qp=qp).lambda_mode
    q_j = np.asarray(jquant.quantize(jnp.asarray(coef), qp, size))
    q_t = tquant.quantize(tab, _t(coef), qp, size).numpy()
    assert np.array_equal(q_j, q_t)
    d_j = np.asarray(jquant.dequantize(jnp.asarray(q_j), qp, size))
    d_t = tquant.dequantize(tab, _t(q_j), qp, size).numpy()
    assert np.array_equal(d_j, d_t)
    r_j = np.asarray(jax.jit(lambda c: jquant.rd_quantize(
        c, qp, size, lam))(jnp.asarray(coef)))
    r_t = tquant.rd_quantize(tab, _t(coef), qp, size, lam).numpy()
    assert np.array_equal(r_j, r_t)


@pytest.mark.parametrize("size", SIZES)
def test_cost_matches_jax(size, tabs):
    tab = tabs[Profile.VVC]
    rng = np.random.default_rng(7 + size)
    a = rng.integers(0, 256, (300, size, size)).astype(np.int32)
    b = rng.integers(0, 256, (300, size, size)).astype(np.int32)
    s_j = np.asarray(jax.jit(jcost.sse)(a, b))
    assert np.array_equal(s_j, tcost.sse(_t(a), _t(b)).numpy())
    lv = (rng.integers(-6, 7, (300, size, size))
          * (rng.random((300, size, size)) < 0.3)).astype(np.int32)
    lv[0, 0, 0] = 32767
    lv[1] = rng.integers(-2000, 2001, (size, size))
    for batch in (lv, lv[:7], lv[:1]):
        r_j = np.asarray(jax.jit(jcost.rate_estimate_levels)(batch))
        r_t = tcost.rate_estimate_levels(tab, _t(batch)).numpy()
        assert np.array_equal(r_j, r_t)


@pytest.mark.parametrize("profile", [Profile.HEVC_SUBSET, Profile.VVC],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("size", SIZES)
def test_intra_matches_jax(size, profile, tabs):
    tab = tabs[profile]
    nm = tab.n_modes
    rng = np.random.default_rng(size + 3 * nm)
    r = 4 * size + 1
    refs = rng.integers(0, 256, (12, r)).astype(np.int32)
    refs[0] = 255
    mask = rng.random((12, r)) < 0.6
    mask[1] = False                    # nothing available: mid-gray
    mask[2] = True
    mask[3, :r // 2] = False           # one contiguous run
    s_j = np.asarray(jintra.substitute_refs(jnp.asarray(refs),
                                            jnp.asarray(mask), 128))
    s_t = tintra.substitute_refs(_t(refs), _t(mask), 128).numpy()
    assert np.array_equal(s_j, s_t)
    e_j = np.asarray(jintra.extend_refs(jnp.asarray(s_j), size))
    assert np.array_equal(e_j, tintra.extend_refs(tab, _t(s_j),
                                                  size).numpy())
    p_j = np.asarray(jintra.predict_all_modes(jnp.asarray(s_j), size, nm))
    p_t = tintra.predict_all_modes(tab, _t(s_j), size).numpy()
    assert np.array_equal(p_j, p_t)
    for mode in (0, 1, 2, nm // 2, nm - 1):
        one = tintra.predict_mode(tab, _t(s_j[4]), mode, size).numpy()
        assert np.array_equal(one, p_j[4, mode])


def test_out_of_slice_tools_raise(tabs):
    refs = torch.zeros((1, 17), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tintra.predict_all_modes(tabs[Profile.VVC], refs, 4, pdpc=True)
