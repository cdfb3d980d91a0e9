"""The CUDA kernels' sources, compiled for the host, against their plain
versions (exact equality): K1/K2 against the plain intra scan, K3-P and
K3-B (encode and decode, final MVs included) against the plain P and B
scans, K4 against warp_frames_ref, K5 against refine_search_ref and the
ALF kernels against kernels/alf.py's normal_solve_plain (the normal
equations from the recon and the source, and their float32 solve) and
_ctb_flags (the per-CTB decision), on data that takes their exact int32
path, their ordered float32 path, and both in one launch; the intra
tools' branches of K1/K2 (lossless, transform skip, PDPC, MIP) against
the plain scan; kernel SSE against cost.plane_sse_f32_plain.

csrc/*.cu launch through cudaLaunchKernel, so g++ compiles them as C++
against tests/cuda_host/cuda_runtime.h, a host stand-in that runs each
thread block as its threads meeting at a barrier and turns the kernels'
range checks (X266_ASSERT) into a launch error.  The recon kernels run
one block per CTU row that waits on the row above: with X266_HOST_BLOCKS
set, the stand-in runs that many blocks at once, so the row tickets,
progress waits and fences run concurrently on pictures of 3x3 CTUs.
This checks the kernels' indexing, tables, ordering and integer/float
arithmetic on any machine with g++; the card itself is tested by
tests/test_torch_gpu.py and chip_smoke.py.
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
from x266_tpu_torch.kernels import alf, alf_cuda, interp, me, me_cuda

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)

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


def b_references(planes, amp=8, seed=5):
    """The L0 and L1 pyramids of a B test picture: planes (each (1, h,
    w)) shifted two ways, with noise of +-amp on L0's left two thirds
    and L1's right two thirds."""
    gen = torch.Generator().manual_seed(seed)

    def ref(p, sh, cols):
        p = torch.roll(p[0], sh, (0, 1)).int()
        w = p.shape[1]
        n = torch.randint(-amp, amp + 1, p.shape, generator=gen)
        keep = torch.zeros(w, dtype=torch.bool)
        keep[cols(w)] = True
        return (p + torch.where(keep, 0, n)).clamp(0, 255).to(torch.uint8)

    return (fused.build_pyramids_device(*(
        ref(p, sh, cols) for p, sh in zip(planes, shifts)))
        for shifts, cols in (
            (((2, -3), (1, 0), (1, 0)), lambda w: slice(2 * w // 3, w)),
            (((-1, 2), (0, -1), (0, -1)), lambda w: slice(0, w // 3))))


BCFGS = [
    CodecConfig(width=112, height=80, qp=30, intra_period=8, gop_size=4),
    CodecConfig(width=128, height=64, qp=32, intra_period=8, gop_size=4,
                rdoq=True, ref_substitute=True, merge_cands=True),
]


@pytest.mark.parametrize("cfg", BCFGS, ids=["plain", "merge-subst"])
def test_b_kernel_source_matches_plain_scan(cfg, host_lib):
    """K3-B on a B picture whose L0 and L1 references are the frame
    shifted two ways, noisy in L0 on the left third, in both in the
    middle and in L1 on the right (so each of L1, bi and L0 pays
    somewhere), on the port's own B Pass-A maps."""
    tab = tables.from_reference(cfg, "cpu")
    planes = _planes(synthetic_clip(cfg.width, cfg.height, 1, "mixed",
                                    seed=21)[0])
    p0, p1 = b_references(planes)
    src = fused._unpack_padded(cfg, *planes)
    maps = [m[None] for m in inter.make_mode_decision_b_raw(cfg, tab)(
        src[0][0], p0[0], p1[0])]
    assert (maps[2] == inter.PRED_L1).any() and (
        maps[2] == inter.PRED_BI).any()
    args = (maps[0], maps[1], torch.zeros_like(maps[0]), *maps[2:5], *p0,
            *p1, maps[5], maps[6])
    err, got = recon_cuda._launch_inter(host_lib, 0, cfg, tab, True, *src,
                                        *args)
    assert err == 0
    want = inter.make_recon_inter_raw(cfg, tab, True, b_mode=True)(*src,
                                                                   *args)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    dargs = (*args[:4], got[6].int(), got[7].int(), *args[6:])
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


WAVE = {
    "intra": CodecConfig(width=192, height=160, qp=30),
    "p": CodecConfig(width=192, height=160, qp=32, intra_period=4,
                     rdoq=True, ref_substitute=True, merge_cands=True),
    "b": CodecConfig(width=192, height=160, qp=30, intra_period=8,
                     gop_size=4),
}


@pytest.mark.parametrize("kind", list(WAVE))
def test_wavefront_rows_run_concurrently(kind, host_lib, monkeypatch):
    """K1/K2, K3-P and K3-B on a picture of 3x3 CTUs (the last row
    partial) with every CTU row's block running at once: the rows take
    their tickets, wait on the row above and publish their progress
    concurrently, and the result is the plain raster scan's."""
    monkeypatch.setenv("X266_HOST_BLOCKS", "8")
    cfg = WAVE[kind]
    tab = tables.from_reference(cfg, "cpu")
    if kind == "intra":
        frames = synthetic_clip(cfg.width, cfg.height, 2, "mixed", seed=5)
        planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
                  for p in ("y", "cb", "cr")]
        src = fused._unpack_padded(cfg, *planes)
        maps = fused.make_pass_a(cfg, tab)(src[0])
        err, got = recon_cuda._launch(host_lib, 0, cfg, tab, True, *src,
                                      *maps)
        want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
        assert err == 0
        for n, w, g in zip(NAMES, want, got):
            assert torch.equal(w, g), n
        err, dec = recon_cuda._launch(host_lib, 0, cfg, tab, False,
                                      *got[3:], *maps)
        assert err == 0
        for n, w, g in zip(NAMES, want, dec):
            assert torch.equal(w, g), n
        return
    if kind == "p":
        f0, f1 = synthetic_clip(cfg.width, cfg.height, 2, "motion", seed=5)
        pyrs = fused.make_encode_step_i(cfg, tab, False, True)(
            *_planes(f0))["pyramids"]
        src = fused._unpack_padded(cfg, *_planes(f1))
        maps = [m[None] for m in inter.make_mode_decision_p_raw(cfg, tab)(
            src[0][0], pyrs[0])]
        args = (maps[0], maps[1], torch.zeros_like(maps[0]), *maps[2:],
                *pyrs)
        raw = inter.make_recon_inter_raw(cfg, tab, True)
    else:
        planes = _planes(synthetic_clip(cfg.width, cfg.height, 1, "mixed",
                                        seed=23)[0])
        p0, p1 = b_references(planes)
        src = fused._unpack_padded(cfg, *planes)
        maps = [m[None] for m in inter.make_mode_decision_b_raw(cfg, tab)(
            src[0][0], p0[0], p1[0])]
        assert (maps[2] == inter.PRED_BI).any()
        args = (maps[0], maps[1], torch.zeros_like(maps[0]), *maps[2:5],
                *p0, *p1, maps[5], maps[6])
        raw = inter.make_recon_inter_raw(cfg, tab, True, b_mode=True)
    err, got = recon_cuda._launch_inter(host_lib, 0, cfg, tab, True, *src,
                                        *args)
    assert err == 0
    want = raw(*src, *args)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    dargs = (*args[:4], got[6].int(), got[7].int(), *args[6:])
    err, dec = recon_cuda._launch_inter(host_lib, 0, cfg, tab, False,
                                        *got[3:6], *dargs)
    assert err == 0
    for n, w, g in zip(NAMES, want, dec):
        assert torch.equal(w, g), n


def _alf_planes(kind, w, h, seed):
    """A source and a post-SAO recon of w x h: "realistic", a smooth
    source (not periodic, so the wrap at the edges matters) and a recon
    within +-3 of it; "noise", a noise source and a recon within +-255
    of it (features near +-510, errors near +-255); "crossing", realistic
    on the top 45 % of the rows and noise below, so the (class, entry)
    chains of the lower blocks, and the whole-plane lane chains of the
    chroma rhs partway, pass 2^24."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (128 + 60 * np.sin(xx / 7.0) + 40 * np.cos(yy / 5.0)
              + xx * 0.2).astype(np.int32)
    noise = rng.integers(0, 256, (h, w)).astype(np.int32)
    small = rng.integers(-3, 4, (h, w))
    big = rng.integers(-255, 256, (h, w))
    if kind == "realistic":
        orig, d = smooth, small
    elif kind == "noise":
        orig, d = noise, big
    else:
        low = yy >= int(h * 0.45)
        orig, d = np.where(low, noise, smooth), np.where(low, big, small)
    rec = np.clip(orig + d, 0, 255).astype(np.int32)
    return torch.from_numpy(orig), torch.from_numpy(rec)


ALF_CASES = {          # luma size; chroma is half of it, or the same
    "realistic": (112, 80), "noise": (112, 80), "crossing": (112, 80),
    "tiny": (32, 16),
}


@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("case", list(ALF_CASES))
def test_alf_kernel_source_matches_plain(plane, case, host_lib):
    """The ALF kernel's coefficients, gram and rhs, from the recon and
    the source, equal normal_solve_plain's bit for bit: realistic planes
    (every chain exact in int32), full-magnitude noise (many chains in
    the ordered path), planes whose chains cross 2^24 partway (both
    paths in one launch; the chroma plane of 208x120 spans four of the
    rhs's segments, so its plane-long lane chains start their ordered
    part past an exact prefix) and tiny planes (one partial block, the
    diamond's rows wrapping around the plane).  112x80 is 8,960 luma
    samples, not a multiple of the 1,024- and 2,728-sample blocks; the
    sources are not periodic, so the wrap at the edges matters."""
    w, h = ALF_CASES[case]
    kind = "realistic" if case == "tiny" else case
    if plane == "chroma":
        w, h = (208, 120) if case == "crossing" else (w // 2, h // 2)
    o, r = _alf_planes(kind, w, h, w + h)
    cls = alf.classify(r).contiguous() if plane == "luma" else None
    code, got = alf_cuda._launch(host_lib, 0, r, o, cls)
    assert code == 0
    want = alf.normal_solve_plain(r, o, cls, with_sums=True)
    for n, a, b in zip(("coef", "gram", "rhs"), want, got):
        assert torch.equal(a, b), n
    exact, ordered = got[3][:2].tolist()
    assert exact > 0
    assert (ordered > 0) == (kind != "realistic")


@pytest.mark.parametrize("kind", ["crafted", "realistic"])
@pytest.mark.parametrize("shape,ctb", [((80, 112), 64), ((120, 208), 32),
                                       ((64, 128), 32)])
def test_alf_sse_kernel_source_matches_plain(shape, ctb, kind, host_lib):
    """The CTB decision kernel's two per-CTB SSEs equal alf.ctb_sse_plain
    and its flags alf._ctb_flags in all three of XLA's orders (64x64
    windows; 32x32 with a plane width that is not and is a multiple of
    32): "crafted" planes whose windows' sums pass 2^24 (the ordered
    path), "realistic" ones where every window is exact."""
    h, w = shape
    rng = np.random.default_rng(w)
    o = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.int32))
    if kind == "crafted":
        a = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.int32))
        a[::3], o[::3] = 255, 0
        r = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.int32))
    else:
        # the filtered plane closer to the source on the left, further
        # on the right, so that both flags occur
        amp = np.where(np.arange(w) < w // 2, 2, 8)
        a = (o + torch.from_numpy(rng.integers(-amp, amp + 1, (h, w)))
             ).clamp(0, 255)
        r = (o + torch.from_numpy(rng.integers(-5, 6, (h, w)))).clamp(0, 255)
    a, r = a.int().contiguous(), r.int().contiguous()
    code, (flags, sse, stats) = alf_cuda._launch_flags(host_lib, 0, a, r, o,
                                                       ctb, 2.0)
    assert code == 0
    want = alf.ctb_sse_plain(a, o, ctb)
    assert torch.equal(want, sse[0])
    assert torch.equal(alf.ctb_sse_plain(r, o, ctb), sse[1])
    assert torch.equal(alf._ctb_flags(a, r, o, ctb, 2.0), flags)
    assert (want > 2.0 ** 24).any() == (kind == "crafted")
    assert (stats[1] > 0) == (kind == "crafted")
    assert 0 < flags.sum() < flags.numel() or kind == "crafted"


# 3x3 CTUs, the last row and column 8 samples wide; tool -> (config,
# content on which Pass A picks the tool)
TOOLS = {
    "lossless": (CodecConfig(width=136, height=136, qp=30, lossless=True),
                 "text"),
    "ts": (CodecConfig(width=136, height=136, qp=30, rdoq=True,
                       transform_skip=True), "text"),
    "pdpc": (preset_cfg2(136, 136).replace(pdpc=True), "text"),
    "mip": (preset_cfg2(136, 136).replace(mip=True), "motion"),
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_intra_tools_kernel_source_matches_plain_scan(tool, host_lib):
    """K1/K2's lossless, transform-skip, PDPC and MIP branches on a
    3x3-CTU picture, on the port's own Pass-A maps, which use the tool:
    the result is the plain scan's.  The CTU rows run one after another here (the wavefront's
    concurrency is test_wavefront_rows_run_concurrently's: under a
    loaded host a row's capped wait can run out before the row above
    is done)."""
    cfg, kind = TOOLS[tool]
    tab = tables.from_reference(cfg, "cpu")
    planes = _planes(synthetic_clip(cfg.width, cfg.height, 1, kind,
                                    seed=9)[0])
    src = fused._unpack_padded(cfg, *planes)
    maps = fused.make_pass_a(cfg, tab)(src[0])
    if cfg.transform_skip:
        assert (maps[2] == 5).any()
    if cfg.mip:
        assert (maps[1] >= cfg.n_intra_modes).any()
    if cfg.pdpc:
        assert torch.isin(maps[1], torch.tensor([0, 1, 18, 50])).any()
    err, got = recon_cuda._launch(host_lib, 0, cfg, tab, True, *src, *maps)
    assert err == 0
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    if cfg.lossless:
        for n, w, p in zip(NAMES, want, planes):
            assert torch.equal(w, p), n
    err, dec = recon_cuda._launch(host_lib, 0, cfg, tab, False, *got[3:],
                                  *maps)
    assert err == 0
    for n, w, g in zip(NAMES, want, dec):
        assert torch.equal(w, g), n


@pytest.mark.parametrize("wh", [(64, 64), (104, 72), (416, 240),
                                (1920, 1080)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_sse_kernel_source_matches_plain(wh, host_lib):
    """Kernel SSE (csrc/sse.cu) against cost.plane_sse_f32_plain, luma
    and chroma planes of two frames: one near its source (exact sums) and
    one far from it (the sums round, so only the order matches)."""
    from x266_tpu_torch.kernels import cost, sse_cuda

    w, h = wh
    rng = np.random.default_rng(w)
    rounded = []
    for ph, pw in ((h, w), (h // 2, w // 2)):
        orig = rng.integers(0, 256, (2, ph, pw)).astype(np.uint8)
        rec = orig.copy()
        rec[0] = np.clip(orig[0] + rng.integers(-3, 4, (ph, pw)), 0, 255)
        rec[1] = np.where(orig[1] < 128, 255, 0) ^ rng.integers(
            0, 64, (ph, pw))
        rec, orig = torch.from_numpy(rec), torch.from_numpy(orig)
        err, got = sse_cuda._launch(host_lib, 0, rec, orig)
        assert err == 0
        want = cost.plane_sse_f32_plain(rec, orig)
        assert torch.equal(got, want)
        exact = ((rec.long() - orig.long()) ** 2).sum((1, 2))
        assert float(want[0]) == float(exact[0])
        rounded.append(float(want[1]) != float(exact[1]))
    assert any(rounded)
