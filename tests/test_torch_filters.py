"""The port's loop filters against the JAX package (kernels/deblock.py,
sao.py, alf.py), on the CPU at 112x80 and 128x64.

Exact equality for everything normative -- deblock (intra and inter
boundary strengths), SAO apply, ALF classification and every ALF filter
(linear, nonlinear with transposes, chroma, CC-ALF) -- and for the SAO
estimator, which the port makes in float32 exactly as the reference
does, and for the ALF estimators: their normal equations in XLA CPU's
float32 order, their float32 solve (LAPACK's order) and their per-CTB
SSE in XLA's reduction order, held to live jnp bit for bit (ROADMAP
queue 3, F9).
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
    """estimate_alf and estimate_alf_chroma equal the reference's in
    coefficients, flags and filtered planes (before the float32 order was
    matched, the IDR of the ra128x64 clip differed in one luma
    coefficient: 186 against the reference's 185)."""
    if case == "ra128x64-idr":
        orig, rec = _idr_before_alf()
    else:
        seed = int(case[-1])
        orig, rec = _noisy(112, 80, seed, amp=4 + seed)
    lam = 57.0
    want = jalf.estimate_alf(orig[0], rec[0], lam)
    got = talf.estimate_alf(_t(orig[0]), _t(rec[0]), lam)
    for n, a, b in zip(("coeffs", "flags", "filtered"), want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), n
    for k in (1, 2):
        want = jalf.estimate_alf_chroma(orig[k], rec[k], lam)
        got = talf.estimate_alf_chroma(_t(orig[k]), _t(rec[k]), lam)
        for n, a, b in zip(("coeffs", "flags", "filtered"), want, got):
            assert np.array_equal(np.asarray(a), b.numpy()), n


def _jax_sums(feats, err, cls_px=None):
    """The reference's float32 normal equations and unrounded solution,
    by its own lines (x266_tpu/kernels/alf.py:357-370, 275-281)."""
    import jax

    f = jnp.asarray(feats, jnp.float32).reshape(feats.shape[0], -1)
    e = jnp.asarray(err, jnp.float32).reshape(-1)
    n = f.shape[0]
    if cls_px is None:
        gram, rhs = (f @ f.T)[None], (f @ e)[None]
    else:
        o = jax.nn.one_hot(cls_px, 25, axis=0, dtype=jnp.float32
                           ).reshape(25, -1)
        gram = jnp.einsum("cn,in,jn->cij", o, f, f)
        rhs = jnp.einsum("cn,in,n->ci", o, f, e)
    sol = jnp.linalg.solve(gram + 64.0 * jnp.eye(n)[None],
                           (rhs * 128.0)[..., None])[..., 0]
    return np.asarray(gram), np.asarray(rhs), np.asarray(sol)


def _port_sums(rec, orig, plane):
    y = _t(rec)
    if plane == "luma":
        cls = talf.classify(y)
        out = talf.normal_solve(y, _t(orig), cls, with_sums=True)
        return out, talf._diff_planes(y).numpy(), talf._up4(cls).numpy()
    out = talf.normal_solve(y, _t(orig), with_sums=True)
    return out, talf._diff_planes(y, talf.CHROMA_DIAMOND).numpy(), None


@pytest.mark.parametrize("seed", [5, 6])
def test_alf_normal_equations_and_solve(seed):
    """On the noisy pictures of the estimator test: the per-class normal
    equations equal the reference's float32 gram and rhs bit for bit, and
    the coefficients its rounded float32 solution."""
    orig, rec = _noisy(112, 80, seed, amp=4 + seed)
    for k, plane in ((0, "luma"), (1, "chroma"), (2, "chroma")):
        (coef, gram, rhs), feats, cls = _port_sums(rec[k], orig[k], plane)
        jg, jr, sol = _jax_sums(feats, orig[k] - rec[k], cls)
        assert np.array_equal(jg, gram.numpy()), plane
        assert np.array_equal(jr, rhs.numpy()), plane
        assert np.array_equal(np.clip(np.round(sol), -511, 511).astype(
            np.int32), coef.numpy()), plane


@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("size", [(128, 64), (416, 240)],
                         ids=["8192", "99840"])
def test_alf_sums_follow_xla_order(plane, size):
    """The normal equations at full magnitude -- a recon far from its
    source, features near +-510 and errors near +-255, so that every
    order of the float32 sums rounds differently -- equal live jnp bit
    for bit: at 128x64 (8,192 luma samples, whole blocks of 1,024) and
    416x240 (99,840, a partial last block; 24,960 chroma samples)."""
    w, h = size if plane == "luma" else (size[0] // 2, size[1] // 2)
    rng = np.random.default_rng(h)
    orig = rng.integers(0, 256, (h, w)).astype(np.int32)
    rec = np.where(rng.random((h, w)) < 0.5, 0, 255).astype(np.int32)
    (_, gram, rhs), feats, cls = _port_sums(rec, orig, plane)
    jg, jr, _ = _jax_sums(feats, orig - rec, cls)
    assert np.array_equal(jg, gram.numpy())
    assert np.array_equal(jr, rhs.numpy())


@pytest.mark.parametrize("n", [12, 6], ids=["luma", "chroma"])
def test_alf_solve_matches_jnp(n):
    """solve_f32 (OpenBLAS's sgetrf and strsm, in float32) equals
    jnp.linalg.solve bit for bit on systems of the estimators' sizes and
    magnitudes: normal equations of synthetic pictures and noise."""
    rng = np.random.default_rng(n)
    a, b = [], []
    for i in range(12):
        f = synthetic_frame(64, 64, 0, ("mixed", "motion")[i % 2], i)
        o = f.y.astype(np.int32)
        r = np.clip(o + rng.integers(-3 - 5 * i, 4 + 5 * i, o.shape), 0,
                    255).astype(np.int32)
        (_, gram, rhs), _, _ = _port_sums(r, o, "luma" if n == 12
                                          else "chroma")
        a.append(gram.numpy() + 64.0 * np.eye(n, dtype=np.float32))
        b.append(rhs.numpy() * 128.0)
    a, b = np.concatenate(a), np.concatenate(b)
    want = np.asarray(jnp.linalg.solve(a, b[..., None])[..., 0])
    got = talf.solve_f32(_t(a), _t(b)).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("shape,ctb", [((80, 112), 64), ((64, 128), 64),
                                       ((120, 208), 32), ((32, 64), 32)])
def test_ctb_sse_follows_xla_order(shape, ctb):
    """The per-CTB float32 SSE equals the reference's (alf.py:379-382,
    jitted as the encoder runs it: XLA fuses the difference, square, pad
    and reduction) bit for bit where its sums pass 2^24: luma 64x64 CTBs
    and chroma 32x32 ones, on planes whose width is and is not a multiple
    of 32."""
    import jax

    h, w = shape
    rng = np.random.default_rng(w)
    a = rng.integers(0, 256, (h, w)).astype(np.int32)
    o = rng.integers(0, 256, (h, w)).astype(np.int32)
    a[::3], o[::3] = 255, 0
    cy, cx = -(-h // ctb), -(-w // ctb)

    def ctb_sse(a, o):
        d = (a - o).astype(jnp.float32) ** 2
        pad = jnp.pad(d, ((0, cy * ctb - h), (0, cx * ctb - w)))
        return pad.reshape(cy, ctb, cx, ctb).sum(axis=(1, 3))

    want = jax.jit(ctb_sse)(a, o)
    got = talf.ctb_sse_plain(_t(a), _t(o), ctb)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert (np.asarray(want) > 2.0 ** 24).any()
