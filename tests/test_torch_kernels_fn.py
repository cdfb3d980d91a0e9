"""Port kernel functions against x266_tpu.kernels and specmodel.

Same numpy inputs (seeded) through the JAX function and its PyTorch
counterpart.  Tolerance: exact equality everywhere, the float32 sums
included (the port adds them in XLA CPU's order): the rate sums, Pass
A's costs where XLA nests them in the argmin's loop fusion, the lossless
rate of a flattened block, and the picture SSE's reduction tree (F4).
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

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)

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
    if profile != Profile.VVC:
        return
    # PDPC (VVC): the blend with the raw refs under every gate pattern
    lok = np.array([1, 0, 1, 0] * 3, bool)
    tok = np.array([1, 1, 0, 0] * 3, bool)
    p_j = np.asarray(jintra.predict_all_modes(
        jnp.asarray(s_j), size, nm, pdpc=True, left_ok=jnp.asarray(lok),
        top_ok=jnp.asarray(tok)))
    p_t = tintra.predict_all_modes(tab, _t(s_j), size, pdpc=True,
                                   left_ok=_t(lok), top_ok=_t(tok)).numpy()
    assert np.array_equal(p_j, p_t)
    for b in range(4):
        for mode in (0, 1, 18, 50, 30):
            one = tintra.predict_mode(tab, _t(s_j[b]), mode, size, True,
                                      bool(lok[b]), bool(tok[b])).numpy()
            assert np.array_equal(one, p_j[b, mode])


def test_mip_prediction_matches_jax():
    """MIP's modes (67-74) through the stacked float32 product: the
    reference's predictions of every MIP mode at the luma sizes, on
    full-range references (the signed weights' largest sums)."""
    tab = tables.from_reference(CodecConfig(width=64, height=64,
                                            profile=Profile.VVC, mip=True),
                                "cpu")
    rng = np.random.default_rng(11)
    for size in (8, 16, 32):
        refs = rng.integers(0, 256, (6, 4 * size + 1)).astype(np.int32)
        refs[0, 1::2] = 255
        refs[0, 0::2] = 0
        p_j = np.asarray(jintra.predict_all_modes(jnp.asarray(refs), size,
                                                  75))
        p_t = tintra.predict_all_modes(tab, _t(refs), size).numpy()
        assert np.array_equal(p_j, p_t)
        one = tintra.predict_mode(tab, _t(refs[0]), 70, size).numpy()
        assert np.array_equal(one, p_j[0, 70])


def test_out_of_slice_tools_raise(tabs):
    """Reference pyramids above 8 bits are outside the port's slices."""
    from x266_tpu_torch.kernels import interp

    plane = torch.zeros((16, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        interp.build_pyramid(plane, max_val=1023)


@pytest.mark.parametrize("wh", [(64, 64), (96, 64), (104, 72), (416, 240),
                                (1920, 1080)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_plane_sse_follows_xla(wh):
    """The reference's per-plane float32 SSE (x266_tpu/engine/fused.py:
    483-486, the live op) against kernels.cost.plane_sse_f32, on planes
    far from their source so that the sums round (F4)."""
    from x266_tpu.engine.fused import _filters_and_stats
    from x266_tpu.engine.mode_decision import pad_plane

    w, h = wh
    cfg = CodecConfig(width=w, height=h)
    rng = np.random.default_rng(w + h)
    src = [rng.integers(0, 256, s).astype(np.uint8)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    rec = [np.where(a < 128, 255, 0).astype(np.uint8)
           ^ rng.integers(0, 64, a.shape).astype(np.uint8) for a in src]
    size = np.full((h // 8, w // 8), 8, np.int32)
    sse_j = np.asarray(jax.jit(
        lambda y, cb, cr, sm, yp, cbp, crp: _filters_and_stats(
            cfg, y, cb, cr, sm, yp, cbp, crp)[-1])(
        *rec, size, *(pad_plane(a).astype(np.int32) for a in src)))
    for k in range(3):
        got = tcost.plane_sse_f32(_t(rec[k])[None], _t(src[k])[None])
        exact = int(((rec[k].astype(np.int64) - src[k]) ** 2).sum())
        assert got.item() == sse_j[k]
        assert exact > 1 << 24 and float(sse_j[k]) != exact


@pytest.mark.parametrize("size", (8, 16, 32))
def test_lossless_rate_follows_xla(size, tabs):
    """Lossless Pass A's rate (x266_tpu/engine/mode_decision.py:191-193):
    XLA flattens the selected residual blocks of the one-hot product and
    sums 32-sample runs, then the runs (kernels.cost.window_then_sum)."""
    tab = tabs[Profile.HEVC_SUBSET]
    nm, k, nb = 35, 8, 16
    rng = np.random.default_rng(size)
    res = (rng.integers(-255, 256, (nb, nm, size, size))
           * (rng.random((nb, nm, size, size)) < 0.6)).astype(np.int32)
    top = np.stack([rng.permutation(nm)[:k] for _ in range(nb)]).astype(
        np.int32)
    lam = np.float32(36.48)

    def ref(res, top):
        onehot = (top[:, :, None] == jnp.arange(nm)[None, None, :]).astype(
            jnp.float32)
        rk = jnp.einsum("bkm,bmp->bkp", onehot, res.reshape(
            nb, nm, size * size).astype(jnp.float32),
            precision=jax.lax.Precision.HIGHEST)
        rk = rk.astype(jnp.int32).reshape(nb, k, size, size)
        return lam * (jcost.rate_estimate_levels(rk) + 6.0)

    c_j = np.asarray(jax.jit(ref)(res, top))
    rk = _t(np.take_along_axis(res, top[:, :, None, None], axis=1))
    c_t = torch.tensor(lam) * (tcost.rate_estimate_residual(tab, rk) + 6.0)
    assert np.array_equal(c_j, c_t.numpy())
