"""The port's loop filters against the JAX package (kernels/deblock.py,
sao.py, alf.py), on the CPU at 112x80 and 128x64.

Exact equality for everything normative -- deblock (intra and inter
boundary strengths), SAO apply, ALF classification and every ALF filter
(linear, nonlinear with transposes, chroma, CC-ALF) -- and for the SAO
estimator, which the port makes in float32 exactly as the reference
does.  The ALF estimators are held to the F9 rule (ROADMAP queue 3):
the port sums the normal equations exactly and solves in float64, the
reference in float32, so a coefficient may differ only where the
reference's unrounded solution lies within EPS of a half-integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu.core.yuv import synthetic_frame
from x266_tpu.kernels import alf as jalf
from x266_tpu.kernels import deblock as jdb
from x266_tpu.kernels import sao as jsao
from x266_tpu_torch.kernels import alf as talf
from x266_tpu_torch.kernels import deblock as tdb
from x266_tpu_torch.kernels import sao as tsao

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)

EPS = 0.1           # F9: distance of the reference's solution to .5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _size_map(uy, ux, seed):
    """A random valid CU-size map (8, 16 and 32, aligned)."""
    rng = np.random.default_rng(seed)
    sm = np.full((uy, ux), 8, np.int32)
    for y in range(0, uy - 1, 2):
        for x in range(0, ux - 1, 2):
            if rng.random() < 0.4:
                sm[y:y + 2, x:x + 2] = 16
    for y in range(0, uy - 3, 4):
        for x in range(0, ux - 3, 4):
            if rng.random() < 0.3:
                sm[y:y + 4, x:x + 4] = 32
    return sm


def _noisy(w, h, seed, amp=6):
    """A synthetic picture (Y, Cb, Cr int32) and a noisy recon of it."""
    f = synthetic_frame(w, h, 0, "mixed", seed)
    rng = np.random.default_rng(seed)
    orig = [p.astype(np.int32) for p in (f.y, f.cb, f.cr)]
    rec = [np.clip(p + rng.integers(-amp, amp + 1, p.shape), 0, 255
                   ).astype(np.int32) for p in orig]
    return orig, rec


@pytest.mark.parametrize("qp", [27, 37])
@pytest.mark.parametrize("inter", [False, True], ids=["intra", "inter"])
def test_deblock_matches_jax(qp, inter):
    rng = np.random.default_rng(qp)
    h, w = 80, 112
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    cb, cr = (rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
              for _ in range(2))
    sm = _size_map(h // 8, w // 8, qp)
    kw = {}
    if inter:
        # kinds 0-4, MVs differing by more and less than a full pel,
        # luma levels in some units
        kw = dict(pred_map=rng.integers(0, 5, sm.shape).astype(np.int32),
                  mvx=rng.integers(-6, 7, sm.shape).astype(np.int32),
                  mvy=rng.integers(-6, 7, sm.shape).astype(np.int32),
                  coef_y=(rng.random((h, w)) < 0.02).astype(np.int32))
    want = jdb.deblock_picture(y, cb, cr, sm, qp, xp=np, **kw)
    got = tdb.deblock_picture(_t(y), _t(cb), _t(cr), _t(sm), qp,
                              **{k: _t(v) for k, v in kw.items()})
    for a, b in zip(want, got):
        assert np.array_equal(a, b.numpy())


def _sao_params(cy, cx, seed):
    rng = np.random.default_rng(seed)
    st = rng.integers(0, 6, (cy, cx)).astype(np.int32)
    sb = rng.integers(0, 29, (cy, cx)).astype(np.int32)
    so = rng.integers(0, 8, (cy, cx, 4)).astype(np.int32)
    sign = np.where(np.arange(4)[None, None] < 2, 1, -1)
    so = np.where((st[..., None] >= 1) & (st[..., None] <= 4), so * sign,
                  so * rng.choice([-1, 1], (cy, cx, 4))).astype(np.int32)
    return st, sb, so


@pytest.mark.parametrize("ctb", [64, 32], ids=["luma", "chroma"])
def test_sao_apply_matches_jax(ctb):
    rng = np.random.default_rng(ctb)
    y = rng.integers(0, 256, (80, 112)).astype(np.int32)
    cy, cx = -(-80 // ctb), -(-112 // ctb)
    params = _sao_params(cy, cx, ctb)
    want = jsao.apply_sao(y, *params, xp=np, ctb=ctb)
    got = tsao.apply_sao(_t(y), *map(_t, params), ctb=ctb)
    assert np.array_equal(want, got.numpy())


def _sao_estimates_equal(orig, recon, lam, ctb):
    want = jsao.estimate_sao(orig, recon, lam, ctb=ctb)
    got = tsao.estimate_sao(_t(orig), _t(recon), lam, ctb=ctb)
    for n, a, b in zip(("type", "band", "off"), want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), n
    return [b.numpy() for b in got]


@pytest.mark.parametrize("seed", [1, 2])
def test_sao_estimate_matches_jax(seed):
    (oy, ocb, _), (ry, rcb, _) = _noisy(112, 80, seed, amp=5 + seed)
    st, _, _ = _sao_estimates_equal(oy, ry, 57.0, 64)
    _sao_estimates_equal(ocb, rcb, 57.0, 32)
    assert st.any()


def test_sao_order_sensitive_sums_match_jax():
    """The two float32 sums the reference accumulates in a fixed order
    -- the edge gain over categories 1-4 and each band window's four
    gains -- on a picture that drives them to their largest magnitude:
    one CTB's samples spread over four adjacent bands (and over all
    edge categories) with the recon as far from the source as 8 bits
    allow.  Their partial sums then reach about 14.8e6: every term is
    an integer and the sum of their magnitudes stays below
    49 * 4096 + 14 * 4096 * 255 < 2^24, so at 8 bits float32 adds them
    exactly in any order; the port keeps the reference's order all the
    same (kernels/sao.py _window4), and this test holds both estimators
    to each other at that extreme."""
    h, w = 64, 128
    rng = np.random.default_rng(9)
    recon = np.zeros((h, w), np.int32)
    recon[:, :64] = (rng.integers(0, 4, (h, 64)) * 8 + 4)    # bands 0-3
    recon[:, 64:] = rng.integers(0, 256, (h, 64))           # edges
    orig = np.where(recon < 128, 255, 0).astype(np.int32)
    diff = (orig - recon).astype(np.float32)
    gain_b = []
    for b in range(4):
        m = (recon[:, :64] >> 3) == b
        e, n = diff[:, :64][m].sum(), float(m.sum())
        off = np.clip(np.round(e / n), -7, 7)
        gain_b.append(n * off * off - 2.0 * off * e)
    assert abs(sum(gain_b)) > 1.0e7        # the window sum's magnitude
    _sao_estimates_equal(orig, recon, 57.0, 64)
    _sao_estimates_equal(orig, recon, 57.0, 32)


def test_alf_classify_matches_jax():
    _, (ry, _, _) = _noisy(112, 80, 3, amp=20)
    want = jalf.classify_full(ry, xp=np)
    got = talf.classify_full(_t(ry))
    for a, b in zip(want, got):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("variant", ["linear", "nonlinear", "chroma",
                                     "chroma-nl", "ccalf"])
def test_alf_apply_matches_jax(variant):
    rng = np.random.default_rng(len(variant))
    _, (ry, rcb, _) = _noisy(112, 80, 4, amp=20)
    cy, cx = 2, 2
    flags = rng.integers(0, 2, (cy, cx)).astype(np.int32)
    flags[0, 0] = 1
    if variant in ("linear", "nonlinear"):
        cls, tr = jalf.classify_full(ry, xp=np)
        coef = rng.integers(-60, 61, (25, 12)).astype(np.int32)
        kw = {}
        if variant == "nonlinear":
            kw = dict(transpose_map=tr,
                      clip_idx=rng.integers(0, 4, 25).astype(np.int32))
        want = jalf.apply_alf(ry, cls, coef, flags, xp=np, **kw)
        got = talf.apply_alf(_t(ry), _t(cls), _t(coef), _t(flags),
                             **{k: _t(v) for k, v in kw.items()})
    elif variant.startswith("chroma"):
        coef = rng.integers(-60, 61, 6).astype(np.int32)
        lvl = 2 if variant == "chroma-nl" else None
        want = jalf.apply_alf_chroma(rcb, coef, flags, xp=np, clip_lvl=lvl)
        got = talf.apply_alf_chroma(_t(rcb), _t(coef), _t(flags),
                                    clip_lvl=lvl)
    else:
        coef = rng.integers(-60, 61, 7).astype(np.int32)
        want = jalf.apply_ccalf(rcb, ry, coef, flags, xp=np)
        got = talf.apply_ccalf(_t(rcb), _t(ry), _t(coef), _t(flags))
    assert np.array_equal(want, got.numpy())


def _ref_solution(feats, err, cls_px=None):
    """The reference's unrounded float32 solution, by its own lines
    (x266_tpu/kernels/alf.py:357-370, 275-281)."""
    f = jnp.asarray(feats, jnp.float32).reshape(feats.shape[0], -1)
    e = jnp.asarray(err, jnp.float32).reshape(-1)
    n = f.shape[0]
    if cls_px is None:
        sol = jnp.linalg.solve(f @ f.T + 64.0 * jnp.eye(n),
                               (f @ e) * 128.0)[None]
    else:
        import jax
        o = jax.nn.one_hot(cls_px, 25, axis=0, dtype=jnp.float32
                           ).reshape(25, -1)
        gram = jnp.einsum("cn,in,jn->cij", o, f, f)
        rhs = jnp.einsum("cn,in,n->ci", o, f, e) * 128.0
        sol = jnp.linalg.solve(gram + 64.0 * jnp.eye(n)[None],
                               rhs[..., None])[..., 0]
    return np.asarray(sol)


def _check_f9(want, got, sol):
    """Coefficients equal except near a half-integer of sol; returns the
    largest |coefficient difference|."""
    want, got = np.asarray(want).reshape(sol.shape), got.reshape(sol.shape)
    diff = want != got
    frac = np.abs(np.abs(sol - np.floor(sol)) - 0.5)
    assert (frac[diff] < EPS).all(), (sol[diff], want[diff], got[diff])
    return int(np.abs(want - got).max())


def _idr_before_alf():
    """Source and pre-ALF recon (deblocked, SAO) of the IDR of the
    ra128x64 clip (data/ra128x64_ref.json), by the port's I step."""
    from x266_tpu_torch import config as tconfig
    from x266_tpu_torch import tables
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import fused

    cfg = tconfig.preset_cfg4(128, 64).replace(gop_size=4, intra_period=8,
                                               alf=False, alf_chroma=False)
    f = synthetic_clip(128, 64, 1, "mixed", seed=4)[0]
    planes = [_t(getattr(f, p)[None]) for p in ("y", "cb", "cr")]
    out = fused.make_encode_step_i(cfg, tables.from_reference(cfg, "cpu"),
                                   True)(*planes)
    return ([p.astype(np.int32) for p in (f.y, f.cb, f.cr)],
            [r[0].numpy().astype(np.int32) for r in out["recon"]])


@pytest.mark.parametrize("case", ["noise5", "noise6", "ra128x64-idr"])
def test_alf_estimator_rule(case):
    """estimate_alf and estimate_alf_chroma against the reference under
    the F9 rule (EPS = 0.1), with the flags and filtered planes exact
    wherever the coefficients agree.  Largest coefficient difference
    seen: 0 on the noisy 112x80 pictures; 1 on the IDR of the ra128x64
    clip (one luma coefficient of 300: the reference's float32 solution
    185.409, 0.091 from a half-integer, rounds to 185, the exact one to
    186)."""
    if case == "ra128x64-idr":
        orig, rec = _idr_before_alf()
    else:
        seed = int(case[-1])
        orig, rec = _noisy(112, 80, seed, amp=4 + seed)
    lam = 57.0
    jc, jf, jo = jalf.estimate_alf(orig[0], rec[0], lam)
    tc, tf, to = talf.estimate_alf(_t(orig[0]), _t(rec[0]), lam)
    cls_px = np.repeat(np.repeat(np.asarray(jalf.classify(rec[0])), 4, 0),
                       4, 1)
    sol = _ref_solution(jalf._diff_planes(rec[0], np), orig[0] - rec[0],
                        cls_px)
    worst = _check_f9(jc, tc.numpy(), sol)
    if worst == 0:
        assert np.array_equal(np.asarray(jf), tf.numpy())
        assert np.array_equal(np.asarray(jo), to.numpy())
    for k in (1, 2):
        jc, jf, jo = jalf.estimate_alf_chroma(orig[k], rec[k], lam)
        tc, tf, to = talf.estimate_alf_chroma(_t(orig[k]), _t(rec[k]), lam)
        sol = _ref_solution(jalf._diff_planes_chroma(rec[k], np),
                            orig[k] - rec[k])
        if _check_f9(jc, tc.numpy(), sol) == 0:
            assert np.array_equal(np.asarray(jf), tf.numpy())
            assert np.array_equal(np.asarray(jo), to.numpy())
        worst = max(worst, _check_f9(jc, tc.numpy(), sol))
    assert worst <= 1, f"largest coefficient difference {worst}"


@pytest.mark.parametrize("seed", [5, 6])
def test_alf_normal_equations_and_solve(seed):
    """The per-class normal equations equal their int64 sums pixel by
    pixel; the LDL^T solve equals LAPACK's float64 solution to 1e-12
    relative, and the numpy copy that tools/make_torch_refs.py solves
    the exact-estimator references with bit for bit."""
    import importlib.util
    import os

    orig, rec = _noisy(112, 80, seed, amp=4 + seed)
    y = _t(rec[0])
    cls = talf.classify(y)
    feats = talf._diff_planes(y)
    err = _t(orig[0] - rec[0])
    gram, rhs = talf.normal_equations(feats, err, cls, talf.NUM_CLASSES)
    f = feats.reshape(12, -1).numpy().astype(np.int64)
    e = err.reshape(-1).numpy().astype(np.int64)
    c = np.repeat(np.repeat(cls.numpy(), 4, 0), 4, 1).reshape(-1)
    for k in range(talf.NUM_CLASSES):
        fk = f[:, c == k]
        assert np.array_equal(gram[k].numpy(), (fk @ fk.T).astype(np.float64))
        assert np.array_equal(rhs[k].numpy(), (fk @ e[c == k]).astype(
            np.float64))
    g = gram + 64.0 * torch.eye(12, dtype=torch.float64)
    b = rhs * 128.0
    got = talf.ldl_solve(g, b).numpy()
    want = np.linalg.solve(g.numpy(), b.numpy()[..., None])[..., 0]
    assert np.abs(got - want).max() < 1e-12 * max(1.0, np.abs(want).max())
    spec = importlib.util.spec_from_file_location(
        "make_torch_refs", os.path.join(os.path.dirname(__file__), "..",
                                        "tools", "make_torch_refs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert np.array_equal(tool._ldl_solve(g.numpy(), b.numpy()), got)
