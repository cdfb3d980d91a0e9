"""Kernels K1/K2's CUDA source, compiled for the host, against the plain
scan (exact equality of recon and coefficient planes).

csrc/recon_intra.cu launches through cudaLaunchKernel, so g++ compiles
it as C++ against tests/cuda_host/cuda_runtime.h, a host stand-in that
runs each thread block as 256 threads meeting at a barrier.  This
checks the kernel's indexing, tables and integer/float arithmetic on
any machine with g++; the card itself is tested by tests/test_torch_gpu.py
and chip_smoke.py.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from x266_tpu.config import CodecConfig, preset_cfg2
from x266_tpu.core.yuv import synthetic_clip
from x266_tpu_torch import _build, tables
from x266_tpu_torch.engine import fused, recon, recon_cuda

HERE = os.path.dirname(os.path.abspath(__file__))
CFGS = [
    preset_cfg2(128, 64),
    CodecConfig(width=104, height=72, qp=30),
    CodecConfig(width=64, height=64, qp=22, max_cu_size=16),
]
NAMES = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr"]


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
