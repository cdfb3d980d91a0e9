"""The B half of the port's inter engine against the JAX package: B Pass
A's seven maps, the plain B recon scan (the oracle of kernel K3-B) in
its encode and decode forms with Pass B isolated by feeding both the JAX
maps, the random-access coding order and QP offsets, and the float32
order of B Pass A's transform-domain error sum.  Tolerance: exact
equality.

The picture and references are those of tests/test_recon_pallas.py
(test_inter_b_matches_scan): the frame, and its shifts as L0 and L1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu import config as jconfig
from x266_tpu.engine import fused as jfused
from x266_tpu.engine import picture as jpicture
from x266_tpu.engine.inter import (make_mode_decision_b_raw as jmdb,
                                   make_recon_inter_raw as jrecon)
from x266_tpu.engine.mode_decision import pad_plane
from x266_tpu_torch import config as tconfig
from x266_tpu_torch import tables
from x266_tpu_torch.engine import inter as tinter
from x266_tpu_torch.engine import picture as tpicture
from x266_tpu_torch.kernels import cost as tcost

from tests.test_torch_inter import NAMES, _assert_equal, _frame, _t

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)

BCFGS = [
    dict(width=112, height=80, qp=30, intra_period=8, gop_size=4),
    dict(width=128, height=64, qp=32, intra_period=8, gop_size=4,
         merge_cands=True, ref_substitute=True),
]
MAP_NAMES = ["size", "mode", "pred", "mvx", "mvy", "mvx1", "mvy1"]


def _id(kw):
    return f"{kw['width']}x{kw['height']}" + (
        "-merge-subst" if kw.get("merge_cands") else "")


def _b_inputs(kw):
    """Padded planes, L0/L1 pyramids (JAX-built) and the JAX B Pass-A
    maps, after asserting the port's maps equal them."""
    jcfg, tcfg = jconfig.CodecConfig(**kw), tconfig.CodecConfig(**kw)
    w, h = kw["width"], kw["height"]
    y0, cb0, cr0 = _frame(w, h, seed=21)
    build = jax.jit(lambda a, b, c: jfused._build_pyramids_device(
        a.astype(jnp.int32), b.astype(jnp.int32), c.astype(jnp.int32)))
    p0 = [np.asarray(p) for p in build(np.roll(y0, (2, -3), (0, 1)),
                                       np.roll(cb0, 1, 0),
                                       np.roll(cr0, 1, 0))]
    p1 = [np.asarray(p) for p in build(np.roll(y0, (-1, 2), (0, 1)),
                                       np.roll(cb0, -1, 1),
                                       np.roll(cr0, -1, 1))]
    planes = [pad_plane(p).astype(np.int32) for p in (y0, cb0, cr0)]
    want = [np.asarray(m) for m in jax.jit(jmdb(jcfg))(planes[0], p0[0],
                                                       p1[0])]
    tab = tables.from_reference(tcfg, "cpu")
    got = tinter.make_mode_decision_b_raw(tcfg, tab)(
        _t(planes[0]), _t(p0[0]), _t(p1[0]))
    for n, a, b in zip(MAP_NAMES, want, got):
        assert np.array_equal(a, b.numpy()), n
    return jcfg, tcfg, tab, planes, want, p0, p1


@pytest.mark.parametrize("kw", BCFGS, ids=_id)
def test_b_pass_a_and_plain_b_scan_match_jax(kw):
    """B Pass A's maps (asserted in _b_inputs), then the plain B scan on
    the JAX maps: encode, and decode of the reference's levels with its
    final MVs, equal to the JAX scan with b_mode=True."""
    jcfg, tcfg, tab, planes, maps, p0, p1 = _b_inputs(kw)
    kinds = maps[2]
    if kw is BCFGS[0]:
        assert (kinds == tinter.PRED_L1).any() and (
            kinds == tinter.PRED_BI).any(), "test setup: no L1 and bi CUs"
    assert (kinds >= tinter.PRED_L1).any(), "test setup: no B kinds"
    mts = np.zeros_like(maps[0])
    jargs = (maps[0], maps[1], mts, *maps[2:5], *p0, *p1, maps[5], maps[6])
    want = jax.jit(jrecon(jcfg, True, b_mode=True))(*planes, *jargs)

    def targs(m):
        return ([_t(a[None], np.int32) for a in m[:6]]
                + [_t(p) for p in (*p0, *p1)]
                + [_t(a[None], np.int32) for a in m[6:]])

    tm = [maps[0], maps[1], mts, *maps[2:5], maps[5], maps[6]]
    got = tinter.make_recon_inter_raw(tcfg, tab, True, b_mode=True)(
        *(_t(p[None], np.uint8) for p in planes), *targs(tm))
    _assert_equal(NAMES, want, got)

    dm = tm[:4] + [np.asarray(m).astype(np.int32) for m in want[6:]] + tm[6:]
    dgot = tinter.make_recon_inter_raw(tcfg, tab, False, b_mode=True)(
        *(_t(np.asarray(c)[None], np.int16) for c in want[3:6]), *targs(dm))
    _assert_equal(NAMES, want, dgot)


@pytest.mark.parametrize("s", [8, 16, 32])
def test_transform_domain_error_sum_follows_xla(s):
    """B Pass A's jnp.sum((coefs - deq)**2, axis=(-2, -1)) in float32
    (x266_tpu/engine/inter.py:380) against kernels.cost.xla_cpu_sum,
    with the subtraction fused into the reduction as in Pass A.  For
    8x8 blocks XLA CPU sums in the 8-lane order of the rate sums (F2),
    so the two agree on values whose block sums pass 2^24.  For 16x16
    and 32x32 XLA's order depends on what it fuses into the reduction
    (ROADMAP queue 3, F10); every term is an integer, so the sums agree
    exactly whenever a block's sum stays below 2^24, which these values
    keep."""
    rng = np.random.default_rng(s)
    hi = {8: 2900, 16: 170, 32: 85}[s]
    c = rng.integers(-hi, hi, (64, s, s)).astype(np.int32)
    q = rng.integers(-hi, hi, (64, s, s)).astype(np.int32) // 2
    want = np.asarray(jax.jit(lambda a, b: jnp.sum(
        (a - b).astype(jnp.float32) ** 2, axis=(-2, -1)))(c, q))
    got = tcost.xla_cpu_sum(torch.from_numpy(c - q).to(torch.float32) ** 2)
    assert ((np.abs(want) > 2 ** 24) == (s == 8)).all()
    assert np.array_equal(want, got.numpy())


def test_gop_coding_order_and_qp_offset_match_jax():
    for n, ip, gop in ((17, 32, 16), (9, 8, 4), (7, 4, 4), (5, 8, 4),
                       (12, 16, 8), (3, 0, 2)):
        assert tpicture.gop_coding_order(n, ip, gop) == \
            jpicture.gop_coding_order(n, ip, gop)
    for kw in (dict(), dict(lossless=True)):
        jcfg = jconfig.CodecConfig(width=64, height=64, **kw)
        tcfg = tconfig.CodecConfig(width=64, height=64, **kw)
        assert [tpicture.b_qp_offset(tcfg, p) for p in range(17)] == \
            [jpicture.b_qp_offset(jcfg, p) for p in range(17)]


def test_f10_exposed_blocks_are_counted():
    """On noise against noisy references at QP 51 every 16x16 and 32x32
    block's transform-domain error sum passes 2^24 for some candidate,
    where the port's order of addition may differ from XLA's (F10):
    inter.F10_BLOCKS counts every such block, and here the maps still
    equal JAX's (the sums decide only in near-ties)."""
    from x266_tpu_torch.engine import fused as tfused

    kw = dict(width=64, height=64, qp=51, intra_period=8, gop_size=4)
    tcfg = tconfig.CodecConfig(**kw)
    rng = np.random.default_rng(1)

    def noise(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))

    y, c = noise(1, 64, 64), noise(1, 32, 32)
    plane = tfused._unpack_padded(tcfg, y, c, c)[0][0]
    p0 = tfused.build_pyramids_device(noise(64, 64), c[0], c[0])[0]
    p1 = tfused.build_pyramids_device(noise(64, 64), c[0], c[0])[0]
    tinter.F10_BLOCKS.clear()
    got = tinter.make_mode_decision_b_raw(
        tcfg, tables.from_reference(tcfg, "cpu"))(plane, p0, p1)
    assert tinter.f10_blocks() == {16: 16, 32: 4}
    want = jax.jit(jmdb(jconfig.CodecConfig(**kw)))(
        plane.numpy(), p0.numpy(), p1.numpy())
    for n, a, b in zip(MAP_NAMES, want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), n
    tinter.F10_BLOCKS.clear()
