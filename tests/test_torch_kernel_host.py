"""The CUDA kernels' sources, compiled for the host, against their plain
versions (exact equality): K1/K2 against the plain intra scan, K3-P
(encode and decode, final MVs included) against the plain P scan, K4
against warp_frames_ref and K5 against refine_search_ref.

csrc/*.cu launch through cudaLaunchKernel, so g++ compiles them as C++
against tests/cuda_host/cuda_runtime.h, a host stand-in that runs each
thread block as 256 threads meeting at a barrier and turns the kernels'
range checks (X266_ASSERT) into a launch error.  This checks the
kernels' indexing, tables and integer/float arithmetic on any machine
with g++; the card itself is tested by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from x266_tpu_torch import _build, tables
from x266_tpu_torch.config import CodecConfig, preset_cfg2
from x266_tpu_torch.core.yuv import synthetic_clip
from x266_tpu_torch.engine import fused, inter, recon, recon_cuda
from x266_tpu_torch.kernels import interp, me, me_cuda

HERE = os.path.dirname(os.path.abspath(__file__))
CFGS = [
    preset_cfg2(128, 64),
    CodecConfig(width=104, height=72, qp=30),
    CodecConfig(width=64, height=64, qp=22, max_cu_size=16),
]
PCFGS = [
    CodecConfig(width=128, height=64, qp=32, intra_period=4, rdoq=True),
    CodecConfig(width=128, height=64, qp=32, intra_period=4, rdoq=True,
                ref_substitute=True, merge_cands=True),
]
NAMES = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr",
         "mvx_fin", "mvy_fin"]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    import ctypes

    so = str(tmp_path_factory.mktemp("kernel_host") / "libx266k_host.so")
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
           "-ffp-contract=off", "-I", os.path.join(HERE, "cuda_host"),
           "-x", "c++", *_build.SOURCES, "-o", so]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return _build.declare(ctypes.CDLL(so))


def _planes(frame):
    return [torch.from_numpy(getattr(frame, p)[None].copy())
            for p in ("y", "cb", "cr")]


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: (
    f"{c.width}x{c.height}-{c.profile.name}-cu{c.max_cu_size}"))
def test_kernel_source_matches_plain_scan(cfg, host_lib):
    tab = tables.from_reference(cfg, "cpu")
    frames = synthetic_clip(cfg.width, cfg.height, 2, "mixed", seed=3)
    planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
              for p in ("y", "cb", "cr")]
    src = fused._unpack_padded(cfg, *planes)
    maps = fused.make_pass_a(cfg, tab)(src[0])

    err, got = recon_cuda._launch(host_lib, 0, cfg, tab, True, *src, *maps)
    assert err == 0
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    err, dec = recon_cuda._launch(host_lib, 0, cfg, tab, False, *got[3:],
                                  *maps)
    assert err == 0
    for n, w, g in zip(NAMES, want, dec):
        assert torch.equal(w, g), n


@pytest.mark.parametrize("cfg", PCFGS, ids=["plain", "merge-subst"])
def test_inter_kernel_source_matches_plain_scan(cfg, host_lib):
    """K3-P on the second picture of a motion clip, its reference the
    first picture's recon, on the port's own P Pass-A maps."""
    tab = tables.from_reference(cfg, "cpu")
    f0, f1 = synthetic_clip(cfg.width, cfg.height, 2, "motion", seed=3)
    pyrs = fused.make_encode_step_i(cfg, tab, False, True)(
        *_planes(f0))["pyramids"]
    src = fused._unpack_padded(cfg, *_planes(f1))
    maps = [m[None] for m in inter.make_mode_decision_p_raw(cfg, tab)(
        src[0][0], pyrs[0])]
    assert (maps[2] > 0).any()
    args = (maps[0], maps[1], torch.zeros_like(maps[0]), *maps[2:], *pyrs)
    err, got = recon_cuda._launch_inter(host_lib, 0, cfg, tab, True, *src,
                                        *args)
    assert err == 0
    want = inter.make_recon_inter_raw(cfg, tab, True)(*src, *args)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    dargs = (*args[:4], got[6].int(), got[7].int(), *pyrs)
    err, dec = recon_cuda._launch_inter(host_lib, 0, cfg, tab, False,
                                        *got[3:6], *dargs)
    assert err == 0
    for n, w, g in zip(NAMES, want, dec):
        assert torch.equal(w, g), n


def _pyramid(w, h, seed):
    y = np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)
    return interp.build_pyramid(interp.pad_ref(torch.from_numpy(y))), y


def test_warp_kernel_source_matches_plain(host_lib):
    pyr, _ = _pyramid(112, 72, 1)
    mvs = torch.from_numpy(np.random.default_rng(2).integers(
        -288, 289, (3, 5, 7, 2)).astype(np.int32))
    err, got = me_cuda._launch_warp(host_lib, 0, pyr, mvs)
    assert err == 0
    assert torch.equal(got, me_cuda.warp_frames_ref(pyr, mvs))
    # a read past the pyramid is caught by the kernel's range check
    err, _ = me_cuda._launch_warp(host_lib, 0, pyr, mvs + 4 * 90)
    assert err != 0


def test_refine_kernel_source_matches_plain(host_lib):
    pyr, y = _pyramid(112, 72, 3)
    rng = np.random.default_rng(4)
    cur = me._ceil_pad(torch.from_numpy(np.clip(
        np.roll(y.astype(np.int32), (1, -2), (0, 1))
        + rng.integers(-9, 10, y.shape), 0, 255).astype(np.int32)))
    base = torch.from_numpy(rng.integers(-10, 11, (5, 7, 2)).astype(
        np.int32))
    err, got = me_cuda._launch_refine(host_lib, 0, cur.contiguous(), pyr,
                                      base)
    assert err == 0
    assert torch.equal(got, me.refine_search_ref(cur, pyr, base))
