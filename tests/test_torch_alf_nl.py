"""The port's nonlinear-ALF and CC-ALF estimators against the JAX package
(x266_tpu/kernels/alf.py estimate_alf_nonlinear, estimate_alf_chroma_nl,
estimate_ccalf), on the CPU at 128x64 and 112x80, bit for bit.

The reference runs them jitted inside the encoder's step, so each is held
to its jitted self: coefficients, clip indices or levels, flags and
filtered planes, and -- through jitted probes of the reference's own
lines -- the float32 sums whose near-ties pick a syntax element: the
per-class SSE of the 4x4 blocks (:454-456), the chroma plane's SSE at
each clip level (:326) and CC-ALF's whole-filter gain (:558).  The new
float32 orders (kernels/alf.py SUM_ORDERS, gain_total) are held to their
live XLA ops on data whose sums round, and solve_f32 to jnp.linalg.solve
at CC-ALF's n = 7 and at the clipped features' magnitudes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu.kernels import alf as jalf
from x266_tpu_torch.kernels import alf as talf

torch.set_num_threads(1)

LAM = 57.0
SIZES = {"128x64": (128, 64), "112x80": (112, 80)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _encoder_planes(w, h):
    """Source and post-SAO recon (Y, Cb, Cr int32) of a config-4 IDR at
    w x h, by the port's I step with ALF off."""
    from x266_tpu_torch import config as tconfig
    from x266_tpu_torch import tables
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import fused

    cfg = tconfig.preset_cfg4(w, h).replace(gop_size=4, intra_period=8,
                                            alf=False, alf_chroma=False)
    f = synthetic_clip(w, h, 1, "motion", seed=3)[0]
    planes = [_t(getattr(f, p)[None]) for p in ("y", "cb", "cr")]
    out = fused.make_encode_step_i(cfg, tables.from_reference(cfg, "cpu"),
                                   True)(*planes)
    return ([p.astype(np.int32) for p in (f.y, f.cb, f.cr)],
            [r[0].numpy().astype(np.int32) for r in out["recon"]])


def _planes(case, size):
    """(orig, recon) Y, Cb, Cr int32: "noise", a recon within +-255 of a
    noise source (features near +-510, errors near +-255: the float32
    sums round in every order); "encoder", the encoder's post-SAO planes;
    "mixed", the encoder's planes on the top 45 % of the rows and noise
    below, so that sums cross 2^24 partway."""
    w, h = SIZES[size]
    orig, rec = _encoder_planes(w, h)
    if case == "encoder":
        return orig, rec
    rng = np.random.default_rng(w + h)
    out_o, out_r = [], []
    for o, r in zip(orig, rec):
        no = rng.integers(0, 256, o.shape)
        nr = np.clip(no + rng.integers(-255, 256, o.shape), 0, 255)
        if case == "noise":
            out_o.append(no.astype(np.int32))
            out_r.append(nr.astype(np.int32))
        else:
            low = np.arange(o.shape[0])[:, None] >= int(o.shape[0] * 0.45)
            out_o.append(np.where(low, no, o).astype(np.int32))
            out_r.append(np.where(low, nr, r).astype(np.int32))
    return out_o, out_r


# The reference's lines that decide the clip levels, jitted as the encoder
# runs them, returning the float32 sums the argmins read
@functools.lru_cache(maxsize=None)
def _jax_class_sse():
    def f(orig, recon):
        """x266_tpu/kernels/alf.py:417-457, returning blocksse_l."""
        orig = jnp.asarray(orig, jnp.int32)
        recon = jnp.asarray(recon, jnp.int32)
        h, w = orig.shape
        cls, tr = jalf.classify_full(recon)
        tr_px = jnp.repeat(jnp.repeat(tr, 4, axis=0), 4, axis=1)
        e = (orig - recon).astype(jnp.float32).reshape(-1)
        cls_px = jnp.repeat(jnp.repeat(cls, 4, axis=0), 4, axis=1)
        o = jax.nn.one_hot(cls_px, 25, axis=0,
                           dtype=jnp.float32).reshape(25, -1)
        reg = 64.0 * jnp.eye(12)[None]
        blocksse_l = []
        for v in jalf.clip_levels(8):
            fa = jalf._aligned_feats(jalf._clipped_diff_planes(recon, v),
                                     tr_px)
            f = fa.astype(jnp.float32).reshape(12, -1)
            gram = jnp.einsum("cn,in,jn->cij", o, f, f)
            rhs = jnp.einsum("cn,in,n->ci", o, f, e) * 128.0
            sol = jnp.linalg.solve(gram + reg, rhs[..., None])[..., 0]
            cf = jnp.clip(jnp.round(sol), -511, 511).astype(jnp.int32)
            oh_blk = jax.nn.one_hot(cls, 25, dtype=jnp.float32)
            cblk = jnp.einsum("hwc,ck->khw", oh_blk, cf.astype(jnp.float32),
                              precision=jax.lax.Precision.HIGHEST
                              ).astype(jnp.int32)
            cpx = jnp.repeat(jnp.repeat(cblk, 4, axis=1), 4, axis=2)
            acc = jnp.sum(cpx * fa, axis=0)
            filt = jnp.clip(recon + ((acc + 64) >> 7), 0, 255)
            d = (filt - orig).astype(jnp.float32) ** 2
            dblk = d.reshape(h // 4, 4, w // 4, 4).sum(axis=(1, 3))
            blocksse_l.append(jnp.einsum(
                "hwc,hw->c", jax.nn.one_hot(cls, 25, dtype=jnp.float32),
                dblk))
        sse = jnp.stack(blocksse_l)
        return sse, jnp.argmin(sse, axis=0).astype(jnp.int32)
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _jax_plane_sse():
    def f(orig, recon):
        """x266_tpu/kernels/alf.py:308-327, returning sse_l."""
        orig = jnp.asarray(orig, jnp.int32)
        recon = jnp.asarray(recon, jnp.int32)
        e = (orig - recon).astype(jnp.float32).reshape(-1)
        reg = 64.0 * jnp.eye(6)
        sse_l = []
        for v in jalf.clip_levels(8):
            feats = jalf._clipped_diff_planes_chroma(recon, v)
            f = feats.astype(jnp.float32).reshape(6, -1)
            sol = jnp.linalg.solve(f @ f.T + reg, (f @ e) * 128.0)
            cf = jnp.clip(jnp.round(sol), -511, 511).astype(jnp.int32)
            acc = jnp.sum(cf[:, None, None] * feats, axis=0)
            filt = jnp.clip(recon + ((acc + 64) >> 7), 0, 255)
            sse_l.append(jnp.sum((filt - orig).astype(jnp.float32) ** 2))
        sse = jnp.stack(sse_l)
        return sse, jnp.argmin(sse).astype(jnp.int32)
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _jax_estimator(name):
    return jax.jit(functools.partial(getattr(jalf, name), lam=LAM))


def _equal(names, want, got):
    for n, a, b in zip(names, want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), n


@pytest.mark.parametrize("v", [256, 32, 8, 2])
def test_clipped_chroma_features_are_the_shared_ones(v):
    """The port keeps one clipped-feature function for both diamonds: with
    CHROMA_DIAMOND it is the reference's _clipped_diff_planes_chroma
    (:232), and with DIAMOND its _clipped_diff_planes (:131)."""
    rng = np.random.default_rng(v)
    c = rng.integers(0, 256, (40, 56)).astype(np.int32)
    got = talf._clipped_diff_planes(_t(c), v, talf.CHROMA_DIAMOND)
    assert np.array_equal(jalf._clipped_diff_planes_chroma(c, v, xp=np),
                          got.numpy())
    got = talf._clipped_diff_planes(_t(c), v)
    assert np.array_equal(jalf._clipped_diff_planes(c, v, xp=np), got.numpy())


def test_aligned_features_match_jax():
    """_aligned_feats, a gather on the transpose map, equals the
    reference's four selects per tap (:390-402)."""
    _, (ry, _, _) = _planes("noise", "112x80")
    _, tr = jalf.classify_full(ry, xp=np)
    tr_px = np.repeat(np.repeat(tr, 4, 0), 4, 1)
    feats = jalf._clipped_diff_planes(ry, 32, xp=np)
    want = jalf._aligned_feats(feats, tr_px, xp=np)
    got = talf._aligned_feats(_t(feats), _t(tr_px))
    assert np.array_equal(want, got.numpy())
    assert len(np.unique(tr)) == 4


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("case", ["noise", "encoder", "mixed"])
def test_nonlinear_luma_estimator_matches_jax(case, size):
    """estimate_alf_nonlinear: the per-class block SSEs of every clip
    level (bit for bit, so no near-tie can pick another level), the clip
    indices, coefficients, flags and the filtered plane."""
    orig, rec = _planes(case, size)
    want = _jax_estimator("estimate_alf_nonlinear")(orig[0], rec[0])
    got = talf.estimate_alf_nonlinear(_t(orig[0]), _t(rec[0]), LAM,
                                      with_sse=True)
    _equal(("coeffs", "clip_idx", "flags", "filtered"), want, got)
    sse, idx = _jax_class_sse()(orig[0], rec[0])
    assert np.array_equal(np.asarray(sse), got[4].numpy())
    assert np.array_equal(np.asarray(idx), got[1].numpy())
    if case != "encoder":
        assert (np.asarray(sse) > 2.0 ** 24).any()


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("case", ["noise", "encoder", "mixed"])
def test_nonlinear_chroma_estimator_matches_jax(case, size):
    """estimate_alf_chroma_nl on both chroma planes: the plane SSE of
    every clip level, the level, coefficients, flags and filtered plane."""
    orig, rec = _planes(case, size)
    for k in (1, 2):
        want = _jax_estimator("estimate_alf_chroma_nl")(orig[k], rec[k])
        got = talf.estimate_alf_chroma_nl(_t(orig[k]), _t(rec[k]), LAM,
                                          with_sse=True)
        _equal(("coeffs", "clip_lvl", "flags", "filtered"), want, got)
        sse, lvl = _jax_plane_sse()(orig[k], rec[k])
        assert np.array_equal(np.asarray(sse), got[4].numpy())
        assert int(lvl) == int(got[1])


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("case", ["noise", "encoder", "mixed"])
def test_ccalf_estimator_matches_jax(case, size):
    """estimate_ccalf on both chroma planes from the luma: coefficients,
    flags and the filtered plane, and its normal equations against the
    reference's float32 dots."""
    orig, rec = _planes(case, size)
    for k in (1, 2):
        want = _jax_estimator("estimate_ccalf")(orig[k], rec[k], rec[0])
        got = talf.estimate_ccalf(_t(orig[k]), _t(rec[k]), _t(rec[0]), LAM)
        _equal(("coeffs", "flags", "filtered"), want, got)
        feats = jalf._cc_feats(rec[0], *rec[k].shape, xp=np)
        f = jnp.asarray(feats, jnp.float32).reshape(7, -1)
        e = jnp.asarray(orig[k] - rec[k], jnp.float32).reshape(-1)
        _, gram, rhs = talf.cc_normal_solve_plain(_t(rec[0]), _t(rec[k]),
                                                  _t(orig[k]), True)
        assert np.array_equal(np.asarray(jax.jit(lambda f: f @ f.T)(f)),
                              gram[0].numpy())
        assert np.array_equal(np.asarray(jax.jit(lambda f, e: f @ e)(f, e)),
                              rhs[0].numpy())


def test_ccalf_gate_zeroes_the_filter():
    """With a lambda whose header cost no CTB's gain pays, the gate of
    :558-561 zeroes CC-ALF's coefficients and flags, as the reference's."""
    orig, rec = _planes("encoder", "128x64")
    lam = 4.0e4
    want = jax.jit(functools.partial(jalf.estimate_ccalf, lam=lam))(
        orig[1], rec[1], rec[0])
    got = talf.estimate_ccalf(_t(orig[1]), _t(rec[1]), _t(rec[0]), lam)
    _equal(("coeffs", "flags", "filtered"), want, got)
    assert not got[0].any() and not got[1].any()


@pytest.mark.parametrize("n", [8192, 24960, 129600])
def test_cc_sums_follow_xla_order(n):
    """SUM_ORDERS "cc_gram" and "cc_rhs": CC-ALF's f32[7, N] dots at full
    positive magnitude, where every order rounds differently."""
    rng = np.random.default_rng(n)
    f = rng.integers(150, 256, (7, n)).astype(np.float32)
    e = rng.integers(150, 256, n).astype(np.float32)
    ft = _t(f).to(torch.int32)
    pg = (ft[:, None] * ft[None]).reshape(49, n).float()
    pr = (ft * _t(e).to(torch.int32)).float()
    g = talf.ordered_sums(pg, None, 1, "cc_gram")[0].reshape(7, 7)
    r = talf.ordered_sums(pr, None, 1, "cc_rhs")[0]
    assert np.array_equal(np.asarray(jax.jit(lambda f: f @ f.T)(f)),
                          g.numpy())
    assert np.array_equal(np.asarray(jax.jit(lambda f, e: f @ e)(f, e)),
                          r.numpy())


@pytest.mark.parametrize("shape", [(16, 32), (20, 28), (32, 64), (60, 104),
                                   (64, 64)])
def test_class_sse_follows_xla_order(shape):
    """SUM_ORDERS "class_sse_*": the per-class dot of :454-456, with the
    class map computed from the recon in the same jit as the reference
    does (XLA fuses the classification into the dot's loop, which sets
    how LLVM vectorizes it), on block SSEs of full magnitude: both of
    XLA's emissions (the fused loop below 4,096 blocks: 512, 560 and
    2,048; the tiled gemv from there: 4,096 and 6,240), class 24 among
    the classes."""
    h, w = shape
    rng = np.random.default_rng(h * w)
    recon = rng.integers(0, 256, (4 * h, 4 * w)).astype(np.int32)
    filt = rng.integers(0, 256, (2, 4 * h, 4 * w)).astype(np.int32)
    orig = np.where(filt[0] < 128, 255, 0).astype(np.int32)

    def live(filt, orig, recon):
        cls, _ = jalf.classify_full(recon)
        d = (filt - orig).astype(jnp.float32) ** 2
        dblk = d.reshape(h, 4, w, 4).sum(axis=(1, 3))
        return jnp.einsum("hwc,hw->c",
                          jax.nn.one_hot(cls, 25, dtype=jnp.float32), dblk)

    want = np.stack([np.asarray(jax.jit(live)(f, orig, recon))
                     for f in filt])
    cls = talf.classify(_t(recon))
    got = talf.class_sse_plain(_t(filt), _t(orig), cls)
    assert np.array_equal(want, got.numpy())
    assert (want > 2.0 ** 24).any() and (cls == 24).any()


@pytest.mark.parametrize("rows,cols", [(1, 2), (2, 2), (4, 7), (17, 30)])
def test_gain_total_follows_xla_order(rows, cols):
    """gain_total: the sum of the kept CTBs' gains (:552-558) as XLA CPU
    fuses it with the gain and the flag, at the CTB grids of 128x64,
    112x80, 416x240 and 1920x1080 chroma, on SSEs whose sums round."""
    rng = np.random.default_rng(rows * cols)
    a = rng.integers(0, 2 ** 26, (rows, cols)).astype(np.float32)
    b = rng.integers(0, 2 ** 26, (rows, cols)).astype(np.float32)

    def live(a, b):
        gain = a - b
        flags = (gain + LAM * 1.5 < 0).astype(jnp.int32)
        return jnp.sum(jnp.where(flags > 0, gain, 0.0))

    want = np.asarray(jax.jit(live)(a, b))
    gain = _t(a) - _t(b)
    got = talf.gain_total(torch.where(gain + float(np.float32(LAM * 1.5))
                                      < 0, gain, 0.0))
    assert want == got.numpy()


def _systems(n, kind, count, seed):
    """count normal-equation systems (gram + 64 I, 128 rhs) of the
    estimators' kind: "cc" from CC-ALF's features of synthetic pictures
    and noise, "clipped" from the clipped (and for 12 taps aligned)
    features at the levels 1-3."""
    from x266_tpu.core.yuv import synthetic_frame

    rng = np.random.default_rng(seed)
    a, b = [], []
    for i in range(count):
        f = synthetic_frame(64, 64, 0, ("mixed", "motion")[i % 2], i)
        o = f.y.astype(np.int32)
        r = np.clip(o + rng.integers(-3 - 5 * (i % 12), 4 + 5 * (i % 12),
                                     o.shape), 0, 255).astype(np.int32)
        if kind == "cc":
            c = r[::2, ::2].copy()
            oc = o[::2, ::2].copy()
            _, g, rh = talf.cc_normal_solve_plain(_t(r), _t(c), _t(oc),
                                                  True)
        else:
            v = talf.clip_levels()[1 + i % 3]
            if n == 12:
                cls, tr = talf.classify_full(_t(r))
                _, g, rh = talf.normal_solve_plain(_t(r), _t(o), cls, True,
                                                   v, tr)
            else:
                _, g, rh = talf.normal_solve_plain(_t(r), _t(o), None, True,
                                                   v)
        a.append(g.numpy() + 64.0 * np.eye(n, dtype=np.float32))
        b.append(rh.numpy() * 128.0)
    return np.concatenate(a), np.concatenate(b)


@pytest.mark.parametrize("n,kind,count", [(7, "cc", 400), (12, "clipped", 24),
                                          (6, "clipped", 60)],
                         ids=["cc7", "luma-clipped", "chroma-clipped"])
def test_solve_matches_jnp(n, kind, count):
    """solve_f32 equals jnp.linalg.solve bit for bit: at n = 7 on CC-ALF's
    systems (with noisier pictures' systems among them), and the 12x12
    and 6x6 solves at the clipped features' smaller magnitudes."""
    a, b = _systems(n, kind, count, n)
    if n == 7:
        rng = np.random.default_rng(1)
        f = rng.integers(-255, 256, (2000, 7, 64)).astype(np.float32)
        a = np.concatenate([a, f @ f.transpose(0, 2, 1)
                            + 64.0 * np.eye(7, dtype=np.float32)])
        b = np.concatenate([b, 128.0 * (f @ rng.integers(
            -255, 256, (2000, 64)).astype(np.float32)[..., None])[..., 0]])
    want = np.asarray(jnp.linalg.solve(a, b[..., None])[..., 0])
    got = talf.solve_f32(_t(a), _t(b)).numpy()
    assert np.array_equal(want, got)
