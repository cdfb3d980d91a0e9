"""The P half of the port's inter engine against the JAX package: P Pass
A's maps, and the plain P recon scan (the oracle of kernel K3-P) in its
encode and decode forms, final MV maps included, with Pass B isolated by
feeding both the JAX Pass-A maps and pyramids.  Tolerance: exact
equality.

The configs and inputs are those of tests/test_me_pallas.py:66-83 and
tests/test_recon_pallas.py:84-118, so the JAX compilations are shared;
one config is also held against the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu import config as jconfig
from x266_tpu.engine import fused as jfused
from x266_tpu.engine.inter import (make_mode_decision_p_raw as jmdp,
                                   make_recon_inter_raw as jrecon)
from x266_tpu.engine.mode_decision import pad_plane
from x266_tpu.engine.recon_pallas import make_recon_inter_pallas_raw
from x266_tpu_torch import config as tconfig
from x266_tpu_torch import tables
from x266_tpu_torch.engine import inter as tinter

NAMES = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr",
         "mvx_fin", "mvy_fin"]
PCFGS = [
    dict(width=112, height=80, qp=30, intra_period=8),
    dict(width=128, height=64, qp=35, intra_period=8, max_cu_size=16),
    dict(width=112, height=80, qp=30, intra_period=8, merge_cands=True),
    dict(width=112, height=80, qp=30, intra_period=8, ref_substitute=True),
]


def _cfgs(kw):
    return jconfig.CodecConfig(**kw), tconfig.CodecConfig(**kw)


def _id(kw):
    return (f"{kw['width']}x{kw['height']}-cu{kw.get('max_cu_size', 32)}"
            f"{'-merge' if kw.get('merge_cands') else ''}"
            f"{'-subst' if kw.get('ref_substitute') else ''}")


def _t(a, dtype=None):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(dtype) if dtype else a.copy())


def _frame(w, h, seed):
    """tests/test_recon_pallas.py's picture: gradient + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 3 + yy * 2) // 4 % 256).astype(np.uint8)
    y = np.clip(y.astype(np.int32)
                + rng.integers(-24, 25, (h, w)), 0, 255).astype(np.uint8)
    cb = np.clip(128 + (xx[::2, ::2] % 64) - 32
                 + rng.integers(-10, 11, (h // 2, w // 2)),
                 0, 255).astype(np.uint8)
    cr = np.clip(128 - (yy[::2, ::2] % 48) + 24
                 + rng.integers(-10, 11, (h // 2, w // 2)),
                 0, 255).astype(np.uint8)
    return y, cb, cr


def _pass_a(kw, planes, ref):
    """Both P Pass As on padded planes and the reference pictures (Y,
    Cb, Cr); returns the JAX maps and pyramids after asserting that the
    port's maps equal them."""
    jcfg, tcfg = _cfgs(kw)
    pyrs = jax.jit(lambda a, b, c: jfused._build_pyramids_device(
        a.astype(jnp.int32), b.astype(jnp.int32), c.astype(jnp.int32)))(
        *ref)
    want = [np.asarray(m) for m in jax.jit(jmdp(jcfg))(planes[0], pyrs[0])]
    tab = tables.from_reference(tcfg, "cpu")
    got = tinter.make_mode_decision_p_raw(tcfg, tab)(
        _t(planes[0]), _t(pyrs[0]))
    for n, a, b in zip(["size", "mode", "pred", "mvx", "mvy"], want, got):
        assert np.array_equal(a, b.numpy()), n
    return want, pyrs


def _scan_inputs(kw, picture="frame"):
    """tests/test_recon_pallas.py's P picture (or, for "ramp", that of
    tests/test_me_pallas.py:66-83) with the frame shifted as its
    reference: the padded planes, the JAX Pass-A maps (mts inserted) and
    pyramids."""
    w, h = kw["width"], kw["height"]
    y0, cb0, cr0 = _frame(w, h, seed=3)
    if picture == "ramp":
        rng = np.random.default_rng(5)
        yy, xx = np.mgrid[0:h, 0:w]
        y0 = np.clip((xx * 2 + yy) % 256 + rng.integers(-15, 16, (h, w)),
                     0, 255).astype(np.uint8)
    elif picture == "flat":
        y0 = np.full((h, w), 100, np.uint8)
        y0[:16, :16] = np.random.default_rng(0).integers(0, 256, (16, 16))
    ref = (np.roll(y0, (2, -3), (0, 1)) if picture != "flat" else y0,
           np.roll(cb0, (1, -1), (0, 1)), np.roll(cr0, (1, -1), (0, 1)))
    planes = [pad_plane(p).astype(np.int32) for p in (y0, cb0, cr0)]
    maps, pyrs = _pass_a(kw, planes, ref)
    maps.insert(2, np.zeros_like(maps[0]))          # mts
    return planes, maps, pyrs


@pytest.mark.parametrize("maxcu", [16, 32])
def test_p_pass_a_maps_match_jax(maxcu):
    """The ramp picture of tests/test_me_pallas.py:66-83 and its shift."""
    _, maps, _ = _scan_inputs(PCFGS[0 if maxcu == 32 else 1], "ramp")
    assert (maps[3] == tinter.PRED_INTER).any()


def test_p_pass_a_flat_ties_match_jax():
    """A flat picture with one textured corner against itself: skip,
    inter and intra costs tie on most blocks, so the tie rules alone
    decide."""
    _, maps, _ = _scan_inputs(PCFGS[0], "flat")
    assert (maps[3] == tinter.PRED_SKIP).any()


def _port_args(maps, pyrs):
    return ([_t(m[None], np.int32) for m in maps]
            + [_t(p) for p in pyrs])


def _assert_equal(names, want, got):
    for n, a, b in zip(names, want, got):
        a, b = np.asarray(a), b[0].numpy()
        bad = np.argwhere(a != b)
        assert bad.size == 0, f"{n}: {bad.shape[0]} diffs, first {bad[:4]}"


@pytest.mark.parametrize("kw", PCFGS, ids=_id)
def test_plain_inter_scan_matches_jax(kw):
    planes, maps, pyrs = _scan_inputs(kw)
    assert (maps[3] > 0).any(), "test setup: no inter CUs chosen"
    jcfg, tcfg = _cfgs(kw)
    tab = tables.from_reference(tcfg, "cpu")
    want = jax.jit(jrecon(jcfg, True))(*planes, *maps, *pyrs)
    got = tinter.make_recon_inter_raw(tcfg, tab, True)(
        *(_t(p[None], np.uint8) for p in planes), *_port_args(maps, pyrs))
    _assert_equal(NAMES, want, got)

    # decode of the reference's levels, with its final MVs as the maps
    # (what the entropy walker resolves): the reference's recon and
    # final MVs again, which its own decode reproduces by construction
    dmaps = maps[:4] + [np.asarray(m).astype(np.int32) for m in want[6:]]
    dgot = tinter.make_recon_inter_raw(tcfg, tab, False)(
        *(_t(c[None], np.int16) for c in want[3:6]),
        *_port_args(dmaps, pyrs))
    _assert_equal(NAMES, want, dgot)


def test_plain_inter_scan_matches_pallas_interpret():
    planes, maps, pyrs = _scan_inputs(PCFGS[0])
    jcfg, tcfg = _cfgs(PCFGS[0])
    tab = tables.from_reference(tcfg, "cpu")
    want = jax.jit(make_recon_inter_pallas_raw(jcfg, True))(
        *planes, *maps, *pyrs)
    got = tinter.recon_inter_pass(tcfg, tab, True)(
        *(_t(p[None], np.uint8) for p in planes), *_port_args(maps, pyrs))
    _assert_equal(NAMES, want, got)
