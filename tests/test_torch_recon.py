"""Pass B: the port's plain scan (the oracle of kernels K1/K2) against
the JAX reference, with Pass B isolated by feeding both the JAX Pass-A
maps.  Tolerance: exact equality of recon and coefficient planes.

The configs are the in-slice entries of tests/test_recon_pallas.py's
CFGS (indices 0, 1, 3 and 7) plus a config-2 shaped 128x64 VVC
MTS+RDOQ+substitution config; one config is also held against the
Pallas kernel itself (interpret mode).  The CUDA kernels are compared
with the plain scan on the card in tests/test_torch_gpu.py.
"""

import jax
import numpy as np
import pytest
import torch

from x266_tpu.config import CodecConfig, Profile, preset_cfg2
from x266_tpu.core.yuv import synthetic_clip
from x266_tpu.engine.mode_decision import (make_mode_decision,
                                           make_mts_select, pad_plane)
from x266_tpu.engine.recon import make_recon_pass
from x266_tpu.engine.recon_pallas import make_recon_pallas_raw
from x266_tpu_torch import tables
from x266_tpu_torch.engine import recon as trecon

CFGS = [
    CodecConfig(width=104, height=72, qp=30),
    CodecConfig(width=128, height=64, qp=37, profile=Profile.VVC, mts=True),
    CodecConfig(width=64, height=64, qp=22, max_cu_size=16),
    CodecConfig(width=104, height=72, qp=30, ref_substitute=True),
    preset_cfg2(128, 64),
]
NAMES = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr"]


def _cfg_id(c):
    return (f"{c.width}x{c.height}-qp{c.qp}-{c.profile.name}"
            f"{'-mts' if c.mts else ''}{'-rdoq' if c.rdoq else ''}"
            f"{'-subst' if c.ref_substitute else ''}-cu{c.max_cu_size}")


def _jax_inputs(cfg, seed):
    f = synthetic_clip(cfg.width, cfg.height, 1, "mixed", seed=seed)[0]
    planes = [pad_plane(p).astype(np.int32) for p in (f.y, f.cb, f.cr)]
    # the jitted, functools-cached reference passes, shared with
    # tests/test_torch_mode_decision.py and tests/test_recon_pallas.py
    size_map, mode_map = make_mode_decision(cfg)(planes[0])
    mts_map = (make_mts_select(cfg)(planes[0], size_map, mode_map)
               if cfg.mts else np.zeros_like(np.asarray(size_map)))
    maps = [np.asarray(m).astype(np.int32)
            for m in (size_map, mode_map, mts_map)]
    return planes, maps


def _batch(a, dtype):
    return torch.from_numpy(np.asarray(a).astype(dtype)[None])


def _assert_equal(names, ref, got):
    for n, r, g in zip(names, ref, got):
        r = np.asarray(r)
        g = g[0].numpy()
        bad = np.argwhere(r != g)
        assert bad.size == 0, (f"{n}: {bad.shape[0]} mismatches, first at "
                               f"{bad[:5].tolist()}")


@pytest.mark.parametrize("cfg", CFGS, ids=_cfg_id)
def test_plain_scan_matches_jax(cfg):
    planes, maps = _jax_inputs(cfg, seed=7)
    tab = tables.from_reference(cfg, "cpu")
    ref = make_recon_pass(cfg, encode=True)(*planes, *maps)
    src = [_batch(p, np.uint8) for p in planes]
    tmaps = [_batch(m, np.int32) for m in maps]
    got = trecon.make_recon_pass_raw(cfg, tab, True)(*src, *tmaps)
    _assert_equal(NAMES, ref, got)

    # decode (K2's oracle) of the reference's levels gives back the
    # reference's recon, which its own decode reproduces by construction
    coefs = [_batch(c, np.int16) for c in ref[3:]]
    dgot = trecon.make_recon_pass_raw(cfg, tab, False)(*coefs, *tmaps)
    _assert_equal(NAMES, ref, dgot)


def test_plain_scan_matches_pallas_interpret():
    cfg = preset_cfg2(128, 64)
    planes, maps = _jax_inputs(cfg, seed=3)
    tab = tables.from_reference(cfg, "cpu")
    tmaps = [_batch(m, np.int32) for m in maps]
    ref = jax.jit(make_recon_pallas_raw(cfg, encode=True))(*planes, *maps)
    got = trecon.make_recon_pass_raw(cfg, tab, True)(
        *(_batch(p, np.uint8) for p in planes), *tmaps)
    _assert_equal(NAMES, ref, got)
    coefs = [np.asarray(c).astype(np.int32) for c in ref[3:]]
    dref = jax.jit(make_recon_pallas_raw(cfg, encode=False))(*coefs, *maps)
    dgot = trecon.make_recon_pass_raw(cfg, tab, False)(
        *(_batch(c, np.int16) for c in coefs), *tmaps)
    _assert_equal(NAMES[:3], dref, dgot)


def test_recon_pass_routes_cpu_to_plain_scan():
    cfg = CFGS[0]
    planes, maps = _jax_inputs(cfg, seed=5)
    tab = tables.from_reference(cfg, "cpu")
    args = ([_batch(p, np.uint8) for p in planes]
            + [_batch(m, np.int32) for m in maps])
    want = trecon.make_recon_pass_raw(cfg, tab, True)(*args)
    got = trecon.recon_pass(cfg, tab, True)(*args)
    for w, g in zip(want, got):
        assert torch.equal(w, g)

