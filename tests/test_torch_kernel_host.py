"""The CUDA kernels' sources, compiled for the host, against their plain
versions (exact equality): K1/K2 against the plain intra scan, K3-P and
K3-B (encode and decode, final MVs included) against the plain P and B
scans, K4 against warp_frames_ref, K5 against refine_search_ref and the
ALF kernels against kernels/alf.py's normal_solve_plain (the normal
equations from the recon and the source, and their float32 solve) and
_ctb_flags (the per-CTB decision), on data that takes their exact int32
path, their ordered float32 path, and both in one launch; the intra
tools' branches (lossless, transform skip, PDPC, MIP) of K1/K2 and of
K3-P/K3-B against the plain scan; kernel SSE's float32 and int64
outputs against cost.plane_sse_f32_plain and fused.frame_sse; the recon
kernel's warp-scan substitution
against the serial scan and kernels.intra.substitute_refs; and a build
of the recon kernel whose luma, Cb or Cr warp group skips its named
barriers, which the concurrent wavefront case must catch.

csrc/*.cu launch through cudaLaunchKernel, so g++ compiles them as C++
against tests/cuda_host/cuda_runtime.h, a host stand-in that runs each
thread block as its threads (fibers of one OS thread) meeting at
barriers and turns the kernels' range checks (X266_ASSERT) into a launch
error.  The recon kernels run
one block per CTU row that waits on the row above: with X266_HOST_BLOCKS
set, the stand-in runs that many blocks at once, so the row tickets,
progress waits and fences run concurrently on pictures of 3x3 CTUs.
This checks the kernels' indexing, tables, ordering and integer/float
arithmetic on any machine with g++; the card itself is tested by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from x266_tpu_torch import _build, tables
from x266_tpu_torch.config import CodecConfig, Profile, preset_cfg2
from x266_tpu_torch.core.yuv import synthetic_clip
from x266_tpu_torch.engine import fused, inter, recon, recon_cuda
from x266_tpu_torch.kernels import alf, alf_cuda, interp, me, me_cuda
from x266_tpu_torch.utils.clips import luma_chroma

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
# K1/K2's: under CCLM K1's seventh output is the mts map with its choices
INAMES = NAMES[:6] + ["mts_out"]


def _dec_args(cfg, got, maps):
    """K2's inputs after K1's outputs got: the levels and the maps, under
    CCLM the mts map K1 wrote."""
    return (*got[3:6], maps[0], maps[1], got[6] if cfg.cclm else maps[2])


def _host_build(tmp_path_factory, sources, defines=()):
    """Path of sources built for the host into one library, once per
    test session: parallel workers share the session's base directory,
    and the first to take its lock builds the library the others load."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    import fcntl
    import hashlib

    shim = os.path.join(HERE, "cuda_host", "cuda_runtime.h")
    csrc = os.path.dirname(_build.SOURCES[0])
    key = hashlib.sha256(" ".join((*sources, *defines)).encode())
    for path in (*sorted(os.path.join(csrc, n) for n in os.listdir(csrc)),
                 shim):
        with open(path, "rb") as f:
            key.update(f.read())
    root = tmp_path_factory.getbasetemp().parent
    so = root / f"libx266k_host_{key.hexdigest()[:16]}.so"
    with open(root / "kernel_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            # one g++ per source, all at once, then the link
            flags = ["-std=c++20", "-O1", "-pthread", "-fPIC",
                     "-ffp-contract=off", "-I", os.path.dirname(shim),
                     "-I", csrc, *(f"-D{d}" for d in defines)]
            objs = [str(so) + f".{i}.o" for i in range(len(sources))]
            jobs = [subprocess.Popen(
                [gxx, *flags, "-c", "-x", "c++", src, "-o", obj],
                stderr=subprocess.PIPE, text=True)
                for src, obj in zip(sources, objs)]
            for job in jobs:
                _, err = job.communicate(timeout=300)
                assert job.returncode == 0, err
            part = str(so) + ".part"
            out = subprocess.run([gxx, "-shared", "-pthread", *objs, "-o",
                                  part], capture_output=True, text=True,
                                 timeout=300)
            assert out.returncode == 0, out.stderr
            os.replace(part, so)
    return str(so)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernels built for the host, once per test session."""
    return _build.declare(ctypes.CDLL(_host_build(tmp_path_factory,
                                                  _build.SOURCES)))


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


# the device functions csrc/me.cu and csrc/sse.cu build on, in the op
# order of tests/cuda_host/device_primitives.cu
PRIMITIVES = ["vsadu4", "funnelshift_r", "byte_perm", "reduce_add",
              "reduce_min", "cp_async4", "vabsdiffu4", "dp4a",
              "bulk_copy"]
PRIMITIVES_SRC = os.path.join(HERE, "cuda_host", "device_primitives.cu")


def declare_primitives(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.x266_primitives.argtypes = [i, i, p, p, p, p]
    lib.x266_primitives.restype = i
    return lib


def primitive_case(op, n=4096, seed=0):
    """Random words a, b, c (uint32, n of them) for PRIMITIVES[op] and
    what the function's definition gives for them.  reduce_min's second
    half of warps holds (sad << 6) | k for the first 25 lanes, with many
    tied SADs, and ~0 in the others, as K5 packs its candidates."""
    rng = np.random.default_rng(seed)
    a, b, c = (rng.integers(0, 2**32, n, dtype=np.uint64)
               .astype(np.uint32) for _ in range(3))
    u64 = np.uint64

    def byte(x, i):
        return ((x.astype(u64) >> u64(8 * i)) & u64(255)).astype(np.int64)

    name = PRIMITIVES[op]
    if name == "vsadu4":
        b[::3] = a[::3] ^ (a[::3] & 0x01010101)        # near-equal bytes
        want = sum(np.abs(byte(a, i) - byte(b, i)) for i in range(4))
    elif name == "funnelshift_r":
        want = ((b.astype(u64) << u64(32)) | a) >> (c & 31).astype(u64)
    elif name == "byte_perm":
        c &= 0x7777                # 3-bit selectors; the upper half unused
        both = (b.astype(u64) << u64(32)) | a
        want = sum((((both >> (u64(8) * ((c.astype(u64) >> u64(4 * i))
                                          & u64(7)))) & u64(255))
                    << u64(8 * i)) for i in range(4))
    elif name == "reduce_add":
        want = np.repeat(a.reshape(-1, 32).astype(u64).sum(1), 32)
    elif name == "reduce_min":
        w = a.reshape(-1, 32)
        half = len(w) // 2
        sad = rng.integers(0, 4, (len(w) - half, 25)).astype(np.uint32)
        w[half:, :25] = (sad * (256 * 255 // 3)) << 6 | np.arange(25)
        w[half:, 25:] = 0xffffffff
        want = np.repeat(w.min(1), 32)
    elif name == "vabsdiffu4":
        b[::3] = a[::3] ^ (a[::3] & 0x01010101)        # near-equal bytes
        want = sum(np.abs(byte(a, i) - byte(b, i)) << (8 * i)
                   for i in range(4))
    elif name == "dp4a":
        want = c.astype(np.int64) + sum(byte(a, i) * byte(b, i)
                                        for i in range(4))
    else:
        want = a.reshape(-1, 32)[:, (np.arange(32) + 7) % 32]
    return a, b, c, (np.asarray(want).astype(u64) & u64(0xffffffff)
                     ).astype(np.uint32).ravel()


@pytest.fixture(scope="module")
def prim_lib(tmp_path_factory):
    """tests/cuda_host/device_primitives.cu built for the host."""
    return declare_primitives(ctypes.CDLL(_host_build(tmp_path_factory,
                                                      [PRIMITIVES_SRC])))


@pytest.mark.parametrize("op", PRIMITIVES)
def test_device_primitives_match_definitions(op, prim_lib):
    """The host stand-in's __vsadu4, __funnelshift_r, __byte_perm,
    __reduce_add_sync, __reduce_min_sync, x266_cp_async4, __vabsdiffu4,
    __dp4a (unsigned, wrapping) and x266_bulk_copy on an mbarrier
    against their definitions on random words
    (tests/test_torch_gpu.py holds the card's to the same); the packed
    minimum is the first minimum."""
    k = PRIMITIVES.index(op)
    a, b, c, want = primitive_case(k)
    out = np.zeros_like(a)
    assert prim_lib.x266_primitives(k, a.size, a.ctypes.data, b.ctypes.data,
                                    c.ctypes.data, out.ctypes.data) == 0
    np.testing.assert_array_equal(out, want)
    if op == "reduce_min":
        w = a.reshape(-1, 32)[len(a) // 64:, :25]
        first = (w >> 6).argmin(1)
        assert (out.reshape(-1, 32)[len(a) // 64:, 0] & 63 == first).all()


def _pyramid(w, h, seed):
    y = np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)
    return interp.build_pyramid(interp.pad_ref(torch.from_numpy(y))), y


def _reach(pyr, by, bx, reach):
    """The least and the greatest full-pel MV component (x, then y) whose
    16x16 reads, +-reach full-pel, the plain versions accept."""
    hi_x = pyr.shape[2] - 1 - interp.REF_PAD - 16 * bx - reach
    hi_y = pyr.shape[1] - 1 - interp.REF_PAD - 16 * by - reach
    return reach - interp.REF_PAD, hi_x, hi_y


# K4 cases: (width, height, T, MVs); "edge" MVs reach the pyramid's
# bounds in every direction (quarter-pel fractions 0 and 3 there)
WARP_CASES = {
    "random-T3": (112, 72, 3, "random"),
    "edge-T1": (112, 72, 1, "edge"),
    "edge-T2": (128, 64, 2, "edge"),
    "ragged-416x240-T6": (416, 240, 6, "random"),
}


@pytest.mark.parametrize("case", list(WARP_CASES))
def test_warp_kernel_source_matches_plain(case, host_lib):
    w, h, t, kind = WARP_CASES[case]
    pyr, _ = _pyramid(w, h, 1)
    by, bx = -(-h // 16), -(-w // 16)
    rng = np.random.default_rng(2)
    if kind == "random":
        mvs = rng.integers(-288, 289, (t, by, bx, 2))
    else:
        lo, hi_x, hi_y = _reach(pyr, by, bx, 0)
        mvs = np.stack([rng.integers(4 * lo, 4 * hi_x + 4, (t, by, bx)),
                        rng.integers(4 * lo, 4 * hi_y + 4, (t, by, bx))], -1)
        mvs[:, :, 0, 0] = 4 * lo
        mvs[:, 0, :, 1] = 4 * lo
        mvs[:, :, -1, 0] = 4 * hi_x + 3
        mvs[:, -1, :, 1] = 4 * hi_y + 3
    mvs = torch.from_numpy(mvs.astype(np.int32))
    err, got = me_cuda._launch_warp(host_lib, 0, pyr, mvs)
    assert err == 0
    assert torch.equal(got, me_cuda.warp_frames_ref(pyr, mvs))
    # a read past the pyramid is caught by the kernel's range check
    err, _ = me_cuda._launch_warp(host_lib, 0, pyr, mvs + 4 * 90)
    assert err != 0


def _refine_inputs(kind, w, h, seed):
    """cur, the pyramid and base MVs for K5: 'noise' (a shifted noisy
    copy of the reference), 'flat' (every candidate of every search
    ties), 'periodic' (a 2x2 checker: the stride-2 candidates tie, and
    so do mirrored ones), 'edge' (bases whose reach ends at the
    pyramid's bounds on every side)."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        y = np.full((h, w), 117, np.uint8)
        cur = np.full((h, w), 121, np.int32)
    elif kind == "periodic":
        i, j = np.indices((h, w))
        y = (60 + 90 * ((i + j) % 2)).astype(np.uint8)
        cur = np.roll(y.astype(np.int32), 1, 1)
    else:
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        cur = np.clip(np.roll(y.astype(np.int32), (1, -2), (0, 1))
                      + rng.integers(-9, 10, y.shape), 0, 255)
    pyr = interp.build_pyramid(interp.pad_ref(torch.from_numpy(y)))
    by, bx = -(-h // 16), -(-w // 16)
    base = rng.integers(-10, 11, (by, bx, 2))
    if kind == "edge":
        # the searches read base -4 .. +3 full-pel: the reach of the
        # outer blocks ends at the pyramid's first and last column and row
        # (the plain version's per-block check is one wider than _reach's)
        lo, hi_x, hi_y = _reach(pyr, by, bx, 3)
        base[:, 0, 0], base[0, :, 1] = lo + 1, lo + 1
        base[:, -1, 0], base[-1, :, 1] = hi_x + 1, hi_y + 1
    cur = me._ceil_pad(torch.from_numpy(cur.astype(np.int32)))
    return cur.contiguous(), pyr, torch.from_numpy(base.astype(np.int32))


REFINE_CASES = {
    "noise": (112, 72, 3),
    "flat": (112, 72, 5),
    "periodic": (128, 64, 6),
    "edge": (112, 72, 7),
    "ragged-416x240": (416, 240, 8),
}


@pytest.mark.parametrize("case", list(REFINE_CASES))
def test_refine_kernel_source_matches_plain(case, host_lib):
    w, h, seed = REFINE_CASES[case]
    cur, pyr, base = _refine_inputs(case.split("-")[0], w, h, seed)
    err, got = me_cuda._launch_refine(host_lib, 0, cur, pyr, base)
    assert err == 0
    assert torch.equal(got, me.refine_search_ref(cur, pyr, base))
    if case == "flat":      # every search keeps its first candidate
        assert (got == 4 * base - 14).all()
    # a read past the pyramid is caught by the kernel's range check
    err, _ = me_cuda._launch_refine(host_lib, 0, cur, pyr, base + 90)
    assert err != 0


WAVE = {
    "intra": CodecConfig(width=192, height=160, qp=30),
    "p": CodecConfig(width=192, height=160, qp=32, intra_period=4,
                     rdoq=True, ref_substitute=True, merge_cands=True),
    "b": CodecConfig(width=192, height=160, qp=30, intra_period=8,
                     gop_size=4),
    # dependent quantization's scratch in each block's shared memory
    "intra-dq": preset_cfg2(192, 160).replace(dep_quant=True),
    # MTT's TU lists and BT-V order, LFNST's tables and group scratch
    "intra-mtt-lfnst": preset_cfg2(192, 160).replace(mtt=True, lfnst=True),
    # CCLM: the chroma groups' waits on the luma group, the SSE exchange
    "intra-cclm": preset_cfg2(192, 160).replace(cclm=True),
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
    if kind.startswith("intra"):
        frames = synthetic_clip(cfg.width, cfg.height, 2, "mixed", seed=5)
        if cfg.cclm:
            frames = luma_chroma(frames)
        planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
                  for p in ("y", "cb", "cr")]
        src = fused._unpack_padded(cfg, *planes)
        maps = fused.make_pass_a(cfg, tab)(src[0])
        err, got = recon_cuda._launch(host_lib, 0, cfg, tab, True, *src,
                                      *maps)
        want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
        assert err == 0
        for n, w, g in zip(INAMES, want, got):
            assert torch.equal(w, g), n
        err, dec = recon_cuda._launch(host_lib, 0, cfg, tab, False,
                                      *_dec_args(cfg, got, maps))
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


@pytest.mark.parametrize("feats", ["luma-clip32", "luma-clip2",
                                   "luma-clip256", "chroma-clip8", "cc"])
@pytest.mark.parametrize("case", ["realistic", "noise", "crossing"])
def test_alf_kernel_feature_kinds_match_plain(feats, case, host_lib):
    """The ALF kernel's other feature kinds against their plain versions,
    bit for bit: the nonlinear luma estimator's clipped features aligned
    by the transposes (clip values 32, 2 and 256, level 0, which is the
    linear filter), the nonlinear chroma estimator's clipped 5x5 diamond,
    and CC-ALF's 7 luma differences against a chroma plane; on realistic
    planes (every chain exact), noise (the ordered path) and planes whose
    chains cross 2^24 partway (both; the CC-ALF and chroma planes of
    208x120 span four of the rhs's segments)."""
    w, h = (416, 240) if case == "crossing" else (112, 80)
    o, r = _alf_planes(case, w, h, w + h)
    if feats == "cc":
        co, cr = _alf_planes(case, w // 2, h // 2, w)
        code, got = alf_cuda._launch(host_lib, 0, cr, co, None, luma=r)
        want = alf.cc_normal_solve_plain(r, cr, co, with_sums=True)
    elif feats.startswith("luma"):
        clip = int(feats[9:])
        if case == "crossing":
            o, r = _alf_planes(case, 112, 80, 192)
        cls, tr = (x.contiguous() for x in alf.classify_full(r))
        code, got = alf_cuda._launch(host_lib, 0, r, o, cls, tr, clip)
        want = alf.normal_solve_plain(r, o, cls, True, clip, tr)
    else:
        co, cr = _alf_planes(case, w // 2, h // 2, w)
        code, got = alf_cuda._launch(host_lib, 0, cr, co, None, None, 8)
        want = alf.normal_solve_plain(cr, co, None, True, 8)
    assert code == 0
    for n, a, b in zip(("coef", "gram", "rhs"), want, got):
        assert torch.equal(a, b), n
    exact, ordered = got[3][:2].tolist()
    assert exact > 0
    # a feature clipped to +-32 or less is |f| <= 64: its chains stay exact
    assert (ordered > 0) == (case != "realistic"
                             and feats in ("luma-clip256", "cc"))


def _class_case(case, h, w):
    """(filt (4, H, W) int32, orig, recon) for the class-SSE kernel:
    "realistic", levels near a smooth source (every lane chain exact);
    "noise", a source of 0s and 255s, the levels mostly its opposite and
    the top three quarters of the recon flat (one class, whose lane chains
    pass 2^24 at once); "crossing", that flat class's blocks near the
    source on the top half and at 255 from it below, down to three
    quarters: its lane chains cross 2^24 partway (at 512x512 a lane's
    chain spans six of the ordered pass's tiles)."""
    o, r = _alf_planes("realistic", w, h, w)
    rng = np.random.default_rng(h)
    near = (o[None] + torch.from_numpy(rng.integers(-3, 4, (4, h, w)))
            ).clamp(0, 255)
    if case == "realistic":
        return near.int(), o, r
    extreme = torch.from_numpy(np.where(rng.random((h, w)) < 0.5, 0, 255)
                               .astype(np.int32))
    r[: 3 * h // 4] = 128
    if case == "noise":
        filt = torch.where(torch.from_numpy(rng.random((4, h, w)) < 0.9),
                           255 - extreme[None], extreme[None])
        return filt.int(), extreme, r
    band = (torch.arange(h) >= h // 2) & (torch.arange(h) < 3 * h // 4)
    o = torch.where(band[:, None], extreme, o)
    filt = torch.where(band[None, :, None], 255 - o[None], near)
    return filt.int(), o, r


CLASS_SHAPES = {"512-fused": (64, 128), "560-fused": (80, 112),
                "4096-gemv": (256, 256), "16384-gemv": (512, 512)}


@pytest.mark.parametrize("case,shape", [
    pytest.param(case, shape, id=f"{case}-{name}")
    for case in ("realistic", "noise", "crossing")
    for name, shape in CLASS_SHAPES.items()
    # below 4,096 blocks a lane holds too few of the band's blocks to pass
    # 2^24
    if case != "crossing" or shape[0] >= 256])
def test_alf_class_kernel_matches_plain(case, shape, host_lib, monkeypatch):
    """The class-SSE kernel's (4, 25) per-class SSEs of 4x4 blocks of
    uint8 levels equal class_sse_plain's of the same levels in uint8 and
    in int32, bit for bit, in both of XLA's orders (16 lanes below 4,096
    blocks, 8 from there with class 24 folded otherwise), on the cases of
    _class_case; twice on one buffer of chain totals, the blocks one
    after another and then eight at once (X266_HOST_BLOCKS), each call
    leaving the totals at 0."""
    h, w = shape
    filt, o, r = _class_case(case, h, w)
    cls = alf.classify(r).contiguous()
    want = alf.class_sse_plain(filt, o, cls)
    levels = filt.to(torch.uint8).contiguous()
    assert torch.equal(alf.class_sse_plain(levels, o, cls), want)
    _, tot = alf_cuda.new_work("cpu")
    for blocks in ("1", "8"):
        monkeypatch.setenv("X266_HOST_BLOCKS", blocks)
        code, (got, stats) = alf_cuda._launch_class(host_lib, 0, levels, o,
                                                    cls, tot)
        assert code == 0
        assert torch.equal(want, got)
        assert not tot.any()
        assert (stats[1] > 0) == (case != "realistic")
        assert stats.sum() == 4 * alf.NUM_CLASSES * (16 if h * w < 65536
                                                     else 8)


@pytest.mark.parametrize("shape", [(32, 64), (64, 64), (128, 224),
                                   (192, 96), (544, 64), (1088, 1920)],
                         ids=["1x2", "2x2", "4x7", "6x3", "17x2", "34x60"])
@pytest.mark.parametrize("lam", [2.0, 4.0e3])
def test_ccalf_gate_kernel_matches_plain(shape, lam, host_lib, monkeypatch):
    """CC-ALF's flags and whole-filter gate from the CTB kernel equal
    _ccalf_gate's on CTB grids of each of XLA's orders for the kept
    gains' sum (1, 2, 4, 6, 17 and 34 rows; 34x60 is a 4K chroma plane's
    grid), at two lambdas; the CTBs' SSEs pass 2^24 and the lanes' sums
    differ by orders of magnitude, so the order counts, and the kept
    gains' total is held to gain_total's bit for bit (by the gate's
    decision on either side of it).  Twice on one ticket, the
    blocks one after another and then eight at once (X266_HOST_BLOCKS:
    the last block to take a ticket runs the gate), each call leaving the
    ticket at 0."""
    h, w = shape
    rng = np.random.default_rng(h + w)
    o = rng.integers(0, 256, (h, w)).astype(np.int32)
    c = np.where(o < 128, 255, 0).astype(np.int32)
    # a CTB's filtered plane is the source on a share of its samples: half
    # on rows 0 and 1 of each 8, 0.1-3 % elsewhere, none on a fifth of the
    # CTBs, so that the lanes' sums differ by orders of magnitude and each
    # of XLA's orders rounds its own way
    cy, cx = -(-h // 32), -(-w // 32)
    share = np.where((np.arange(cy) % 8 < 2)[:, None], 0.5,
                     10 ** rng.uniform(-3, -1.5, (cy, cx)))
    share *= rng.random((cy, cx)) < 0.8
    up = np.repeat(np.repeat(share, 32, 0), 32, 1)[:h, :w]
    filt = torch.from_numpy(np.where(rng.random((h, w)) < up, o, c)
                            .astype(np.int32))
    o, c = torch.from_numpy(o), torch.from_numpy(c)
    want_f, want_w = alf._ccalf_gate(filt, c, o, lam)
    gain = alf.ctb_sse_plain(filt, o, 32) - alf.ctb_sse_plain(c, o, 32)
    total = float(alf.gain_total(torch.where(want_f > 0, gain, 0.0)))
    above = float(np.nextafter(np.float32(total), np.float32(np.inf)))
    ticket, _ = alf_cuda.new_work("cpu")
    for blocks in ("1", "8"):
        monkeypatch.setenv("X266_HOST_BLOCKS", blocks)
        worth = torch.full((1,), -1, dtype=torch.int32)
        code, (flags, _, _) = alf_cuda._launch_flags(
            host_lib, 0, filt, c, o, 32, lam, False, worth, ticket)
        assert code == 0
        assert torch.equal(want_f, flags)
        assert bool(want_w) == bool(worth[0]) and worth[0] in (0, 1)
        assert not ticket.any()
        # the kernel's total is gain_total's to the bit: total - total is
        # not below 0, and total - (total's next float32) is
        got = [_gate_worth(host_lib, filt, c, o, lam, -t, ticket)
               for t in (total, above)]
        assert got == [0, 1]
    assert flags.any()


def _gate_worth(lib, filt, c, orig, lam, lam_gate, ticket) -> int:
    """The CTB kernel's gate decision with the constant lam_gate."""
    h, w = orig.shape
    cy, cx = -(-h // 32), -(-w // 32)
    flags = torch.empty((cy, cx), dtype=torch.int32)
    sse = torch.empty((2, cy, cx), dtype=torch.float32)
    worth = torch.full((1,), -1, dtype=torch.int32)
    code = lib.x266_alf_ctb_flags(
        h, w, alf_cuda.sse_mode(32, w), float(np.float32(lam * 1.5)),
        filt.data_ptr(), c.data_ptr(), orig.data_ptr(), flags.data_ptr(),
        sse.data_ptr(), None, lam_gate, worth.data_ptr(), ticket.data_ptr(),
        0)
    assert code == 0
    return int(worth[0])


# 3x3 CTUs, the last row and column 8 samples wide; tool -> (config,
# content on which Pass A picks the tool)
TOOLS = {
    "lossless": (CodecConfig(width=136, height=136, qp=30, lossless=True),
                 "text"),
    "ts": (CodecConfig(width=136, height=136, qp=30, rdoq=True,
                       transform_skip=True), "text"),
    "pdpc": (preset_cfg2(136, 136).replace(pdpc=True), "text"),
    "mip": (preset_cfg2(136, 136).replace(mip=True), "motion"),
    # sign-data hiding and dependent quantization: with RDOQ, and beside
    # transform skip (SDH as preset_cfg2s; DQ without RDOQ, at its
    # default lambda)
    "sdh": (CodecConfig(width=136, height=136, qp=30, rdoq=True,
                        sign_data_hiding=True), "mixed"),
    "sdh-ts": (preset_cfg2(136, 136).replace(transform_skip=True,
                                             sign_data_hiding=True), "text"),
    "dq": (preset_cfg2(136, 136).replace(dep_quant=True), "mixed"),
    "dq-ts": (preset_cfg2(136, 136).replace(dep_quant=True,
                                            transform_skip=True, rdoq=False),
              "text"),
    # MTT binary splits and LFNST: each, both, the quality preset (MTT
    # with SDH), both under DQ, and both without substitution (the
    # window's mid-gray gives the BT-V order's availability)
    "mtt": (preset_cfg2(136, 136).replace(mtt=True), "text"),
    "lfnst": (preset_cfg2(136, 136).replace(lfnst=True), "text"),
    "mtt-lfnst": (preset_cfg2(136, 136).replace(mtt=True, lfnst=True),
                  "text"),
    "mtt-sdh": (preset_cfg2(136, 136).replace(mtt=True,
                                              sign_data_hiding=True), "text"),
    "mtt-lfnst-dq": (preset_cfg2(136, 136).replace(mtt=True, lfnst=True,
                                                   dep_quant=True), "text"),
    "mtt-lfnst-nosubst": (preset_cfg2(136, 136).replace(
        mtt=True, lfnst=True, ref_substitute=False), "text"),
    "mtt-lfnst-ts": (preset_cfg2(136, 136).replace(
        mtt=True, lfnst=True, pdpc=True, transform_skip=True), "text"),
    "mtt-lfnst-mip": (preset_cfg2(136, 136).replace(
        mtt=True, lfnst=True, pdpc=True, mip=True), "motion"),
}
# the clip's seed where it is not 9: 'text' seed 3 and 'motion' seed 6
# give every MTT config of TOOLS BT-H and BT-V leaves of 16 and 32, and
# every LFNST config both kernel indices (on MIP CUs too)
TOOL_SEEDS = {t: 6 if "mip" in t else 3 for t in TOOLS
              if "mtt" in t or "lfnst" in t}


def _quant_off(cfg):
    """cfg without sign-data hiding and dependent quantization."""
    return cfg.replace(sign_data_hiding=False, dep_quant=False)


@pytest.mark.parametrize("tool", list(TOOLS))
def test_intra_tools_kernel_source_matches_plain_scan(tool, host_lib):
    """K1/K2's lossless, transform-skip, PDPC, MIP, sign-data-hiding and
    dependent-quantization branches on a 3x3-CTU picture, on the port's
    own Pass-A maps, which use the tool (SDH and DQ change levels):
    the result is the plain scan's.  The CTU rows run one after another here (the wavefront's
    concurrency is test_wavefront_rows_run_concurrently's: under a
    loaded host a row's capped wait can run out before the row above
    is done)."""
    cfg, kind = TOOLS[tool]
    tab = tables.from_reference(cfg, "cpu")
    planes = _planes(synthetic_clip(cfg.width, cfg.height, 1, kind,
                                    seed=TOOL_SEEDS.get(tool, 9))[0])
    src = fused._unpack_padded(cfg, *planes)
    maps = fused.make_pass_a(cfg, tab)(src[0])
    if cfg.transform_skip:
        assert (maps[2] == 5).any()
    if cfg.mip:
        assert (maps[1] >= cfg.n_intra_modes).any()
    if cfg.pdpc:
        assert torch.isin(maps[1], torch.tensor([0, 1, 18, 50])).any()
    if cfg.mtt:
        # BT-H and BT-V leaves of 16 and of 32
        bt, size = (maps[2] >> 4) & 3, maps[0]
        assert all(((bt == b) & (size == s)).any() for b in (1, 2)
                   for s in (16, 32))
    if cfg.lfnst:
        assert all((((maps[2] >> 6) & 3) == k).any() for k in (1, 2))
    err, got = recon_cuda._launch(host_lib, 0, cfg, tab, True, *src, *maps)
    assert err == 0
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    if cfg.sign_data_hiding or cfg.dep_quant:
        off = recon.make_recon_pass_raw(_quant_off(cfg), tab, True)(*src,
                                                                   *maps)
        assert any(not torch.equal(w, o) for w, o in zip(want[3:], off[3:]))
    if cfg.lossless:
        for n, w, p in zip(NAMES, want, planes):
            assert torch.equal(w, p), n
    err, dec = recon_cuda._launch(host_lib, 0, cfg, tab, False, *got[3:],
                                  *maps)
    assert err == 0
    for n, w, g in zip(NAMES, want, dec):
        assert torch.equal(w, g), n


def _sse_case(w, h, frames, seed):
    """Three (frames, h, w) / (frames, h/2, w/2) uint8 source planes and
    two reconstructions of them: near (+-3, exact float32 sums) and far
    (sums past 2^24 that round, so only the order gives the bits)."""
    rng = np.random.default_rng(seed)
    src, near, far = [], [], []
    for shape in ((frames, h, w), (frames, h // 2, w // 2),
                  (frames, h // 2, w // 2)):
        o = rng.integers(0, 256, shape).astype(np.uint8)
        src.append(torch.from_numpy(o))
        near.append(torch.from_numpy(np.clip(
            o + rng.integers(-3, 4, shape), 0, 255).astype(np.uint8)))
        far.append(torch.from_numpy((np.where(o < 128, 255, 0) ^ rng.integers(
            0, 64, shape)).astype(np.uint8)))
    return src, near, far


def _sse_check(lib, src, recs, work):
    """One launch of kernel SSE on the three planes against the plain
    versions: sse per plane against cost.plane_sse_f32_plain, sse_exact
    against fused.frame_sse; returns whether any float32 sum rounded."""
    from x266_tpu_torch.kernels import cost, sse_cuda

    err, (got, exact) = sse_cuda._launch(lib, 0, recs, src, work)
    assert err == 0
    want = torch.stack([cost.plane_sse_f32_plain(r, o)
                        for r, o in zip(recs, src)], dim=1)
    want_exact = torch.stack([fused.frame_sse(r, o)
                              for r, o in zip(recs, src)], dim=1)
    assert torch.equal(got, want)
    assert torch.equal(exact, want_exact)
    assert not work[1].any()            # the tickets are left at 0
    return bool((want.double() != want_exact.double()).any())


SSE_SHAPES = [(64, 64), (104, 72), (112, 80), (416, 240), (1920, 1080)]


@pytest.mark.parametrize("wh,frames", [
    pytest.param(wh, f, id=f"{wh[0]}x{wh[1]}" + ("" if f == 2 else f"-F{f}"))
    for wh in SSE_SHAPES for f in (2, 1, 4)])
def test_sse_kernel_source_matches_plain(wh, frames, host_lib):
    """Kernel SSE (csrc/sse.cu, x266_picture_sse) against the plain
    versions, the three planes of F frames in one launch: near their
    source (exact sums) and far from it (the sums round, so only the
    order matches), one after the other on one scratch and ticket pair.
    64x64's chroma is one 32x32 window (no window level); 104x72 pads
    both ways; 112x80 (cfg5) pads luma's width by 8 and chroma's by 4 and
    416x240's chroma by 8, which take the byte-wise path; 1920x1080 takes
    the 16-byte copies and a level-2 tail."""
    from x266_tpu_torch.kernels import sse_cuda

    w, h = wh
    src, near, far = _sse_case(w, h, frames, seed=w + frames)
    work = sse_cuda.new_work(frames, [tuple(o.shape[1:]) for o in src],
                             "cpu")
    assert not _sse_check(host_lib, src, near, work)
    assert _sse_check(host_lib, src, far, work)


def test_sse_kernel_concurrent_blocks(host_lib, monkeypatch):
    """The (frame, plane) tickets, their fences and the tail of the CTA
    that takes the last one, with eight CTAs running at once (the host
    stand-in's X266_HOST_BLOCKS), at 1920x1080 (a level-2 tail a luma
    plane) and 416x240 (a last reduction over the level-1 sums), F = 2."""
    from x266_tpu_torch.kernels import sse_cuda

    monkeypatch.setenv("X266_HOST_BLOCKS", "8")
    for w, h in ((1920, 1080), (416, 240)):
        src, near, far = _sse_case(w, h, 2, seed=5)
        work = sse_cuda.new_work(2, [tuple(o.shape[1:]) for o in src], "cpu")
        for rec in (far, near, far):
            _sse_check(host_lib, src, rec, work)


def test_sse_kernel_reuses_its_tickets(host_lib):
    """Two calls on one scratch and ticket pair give equal results: the
    tail leaves the tickets and the int64 sums at 0 and the scratch's
    padding is never written; one plane alone (cost.plane_sse_f32's
    call) takes the same pair of buffers of its shape."""
    from x266_tpu_torch.kernels import cost, sse_cuda

    src, _, far = _sse_case(1920, 1080, 1, seed=11)
    work = sse_cuda.new_work(1, [tuple(o.shape[1:]) for o in src], "cpu")
    runs = [sse_cuda._launch(host_lib, 0, far, src, work) for _ in range(2)]
    assert all(err == 0 for err, _ in runs)
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    assert not work[1].any()
    one = sse_cuda.new_work(1, [tuple(src[1].shape[1:])], "cpu")
    for _ in range(2):
        err, (got, exact) = sse_cuda._launch(host_lib, 0, far[1:2], src[1:2],
                                             one)
        assert err == 0
        assert torch.equal(got[:, 0], cost.plane_sse_f32_plain(far[1], src[1]))
        assert torch.equal(exact[:, 0], fused.frame_sse(far[1], src[1]))


# the intra tools on P and B pictures: 3x3 CTUs of 'motion' against
# references with +-40 noise on two thirds of their width, so the pictures
# mix inter, skip and intra CUs, MIP and PDPC-class modes among them
INTER_TOOLS = {
    "lossless": dict(lossless=True),
    "ts": dict(transform_skip=True, rdoq=True),
    "pdpc": dict(profile=Profile.VVC, pdpc=True),
    "mip": dict(profile=Profile.VVC, mip=True),
    "sdh": dict(sign_data_hiding=True, rdoq=True),
    "dq": dict(profile=Profile.VVC, dep_quant=True, rdoq=True),
}


def _inter_tool_inputs(tool, b):
    """(cfg, tab, src, args) of a P or B picture under tool on the port's
    own Pass-A maps.  Lossless forces one CU to skip (Pass A never picks
    it there); transform skip writes map value 5 on the intra CUs (Pass A
    leaves a P/B picture's mts map 0) so that K3 walks that branch too."""
    cfg = CodecConfig(width=136, height=136, qp=30, intra_period=8,
                      gop_size=4 if b else 1, **INTER_TOOLS[tool])
    tab = tables.from_reference(cfg, "cpu")
    planes = _planes(synthetic_clip(136, 136, 1, "motion", seed=9)[0])
    p0, p1 = b_references(planes, amp=40)
    src = fused._unpack_padded(cfg, *planes)
    if b:
        maps = [m[None] for m in inter.make_mode_decision_b_raw(cfg, tab)(
            src[0][0], p0[0], p1[0])]
    else:
        maps = [m[None] for m in inter.make_mode_decision_p_raw(cfg, tab)(
            src[0][0], p0[0])]
    size, mode, pred = maps[:3]
    intra = pred == inter.PRED_INTRA
    mts = torch.zeros_like(size)
    if tool == "lossless":
        assert (pred == inter.PRED_SKIP).sum() == 0
        _, uy, ux = torch.nonzero((pred > 0) & (size == 16))[0].tolist()
        uy, ux = uy & ~1, ux & ~1
        pred[0, uy:uy + 2, ux:ux + 2] = inter.PRED_SKIP
        assert (pred > 0).sum() > 1
    elif tool == "ts":
        mts = torch.where(intra, 5, mts)
    elif tool == "pdpc":
        assert (intra & torch.isin(mode, torch.tensor([0, 1, 18, 50]))).any()
    elif tool == "mip":
        assert (intra & (mode >= cfg.n_intra_modes)).any()
    assert intra.any() and (pred > 0).any()
    args = (size, mode, mts, *maps[2:5], *p0)
    if b:
        args += (*p1, maps[5], maps[6])
    return cfg, tab, src, planes, args


@pytest.mark.parametrize("pic", ["P", "B"])
@pytest.mark.parametrize("tool", list(INTER_TOOLS))
def test_inter_tools_kernel_source_matches_plain_scan(tool, pic, host_lib):
    """K3-P and K3-B, encode and decode, with lossless (one forced skip
    CU among them), transform skip, PDPC, MIP, sign-data hiding and
    dependent quantization on a 3x3-CTU picture: the result is the plain
    scan's, and lossless recon is the source wherever a CU is not
    skipped.  The rows run one after another, as in
    test_intra_tools_kernel_source_matches_plain_scan."""
    cfg, tab, src, planes, args = _inter_tool_inputs(tool, pic == "B")
    err, got = recon_cuda._launch_inter(host_lib, 0, cfg, tab, True, *src,
                                        *args)
    assert err == 0
    want = inter.make_recon_inter_raw(cfg, tab, True, b_mode=pic == "B")(
        *src, *args)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    if cfg.sign_data_hiding or cfg.dep_quant:
        off = inter.make_recon_inter_raw(_quant_off(cfg), tab, True,
                                         b_mode=pic == "B")(*src, *args)
        assert not torch.equal(want[3], off[3])
    if cfg.lossless:
        skip = (args[3] == inter.PRED_SKIP)[0]
        unit = skip.repeat_interleave(8, 0).repeat_interleave(8, 1)
        assert torch.equal(want[0][0][~unit], planes[0][0][~unit])
        assert (want[3][0][unit] == 0).all()
    dargs = (*args[:4], got[6].int(), got[7].int(), *args[6:])
    err, dec = recon_cuda._launch_inter(host_lib, 0, cfg, tab, False,
                                        *got[3:6], *dargs)
    assert err == 0
    for n, w, g in zip(NAMES, want, dec):
        assert torch.equal(w, g), n


def _serial_substitution(ref, avail, s):
    """The recon kernel's substitution as one thread scanned it: left
    bottom->top, corner, top left->right; a gap takes the last available
    entry before it, leading gaps the first available one, an empty
    vector mid-gray."""
    def idx(k):
        return 4 * s - k if k < 2 * s else (0 if k == 2 * s else k - 2 * s)

    out = [int(v) for v in ref]
    scan = [idx(k) for k in range(4 * s + 1)]
    first = next((i for i in scan if avail[i]), None)
    last = 128 if first is None else out[first]
    for i in scan:
        if avail[i]:
            last = out[i]
        else:
            out[i] = last
    return out


def _availability_patterns(s, rng):
    """Availability vectors ([corner, top 2s, left 2s]) of side s: all,
    none, leading gaps of 1 to 4s scan positions, random ones at four
    densities, and every distinct pattern of the luma (scale 1) and
    chroma (scale 2) blocks of side s of a 256x192 picture."""
    from x266_tpu_torch.engine import availability

    r_len = 4 * s + 1
    scan = [4 * s - k for k in range(2 * s)] + [0] + list(
        range(1, 2 * s + 1))
    pats = {"all": np.ones(r_len, bool), "none": np.zeros(r_len, bool)}
    for g in (1, s, 2 * s, 2 * s + 1, 4 * s):
        m = np.ones(r_len, bool)
        m[scan[:g]] = False
        pats[f"leading gap {g}"] = m
    for i, d in enumerate((0.1, 0.4, 0.7, 0.95)):
        pats[f"random {d}"] = rng.random(r_len) < d
    for plane, scale in (("luma", 1), ("chroma", 2)):
        masks = availability.ref_masks(256, 192, s, scale).reshape(-1, r_len)
        for j, m in enumerate(np.unique(masks, axis=0)):
            pats[f"{plane} {j}"] = m
    return pats


@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_warp_scan_substitution_matches_serial_scan(s, host_lib):
    """The recon kernel's warp-scan substitution (ballots over the scan
    order, the last available entry by __clz) on one warp gives the
    serial scan's vector and kernels.intra.substitute_refs's (the plain
    version the port holds to JAX), on all, none, leading-gap, random
    and picture-geometry (luma and chroma) availability."""
    from x266_tpu_torch.kernels import intra as kintra

    rng = np.random.default_rng(s)
    r_len = 4 * s + 1
    pats = _availability_patterns(s, rng)
    assert len(pats) > 11
    for name, avail in pats.items():
        ref = rng.integers(0, 256, r_len).astype(np.int32)
        av = avail.astype(np.uint8)
        out = np.full(r_len, -1, np.int32)
        assert host_lib.x266_subst_scan(s, ref.ctypes.data, av.ctypes.data,
                                        out.ctypes.data) == 0
        want = _serial_substitution(ref, avail, s)
        assert out.tolist() == want, name
        plain = kintra.substitute_refs(torch.from_numpy(ref)[None],
                                       torch.from_numpy(avail)[None], 128)
        assert plain[0].tolist() == want, name


# One TU's quantizer on the threads the recon kernels give it: (side,
# threads, plane group) -- luma 8 on a warp, 16 and 32 on 128 threads;
# chroma 4 and 8 on a warp, 16 on 64 threads
QUANT_TUS = [(4, 32, 1), (8, 32, 0), (8, 32, 2), (16, 64, 1), (16, 128, 0),
             (32, 128, 0)]
QUANT_QPS = (22, 27, 32, 37)
# (side, QP): a seed of _quant_coefs's transform-skip coefficients whose
# trellis path steps through a zero coefficient on a level of parity 1
# (found with the plain trellis at default_lam(QP)): the TU emits 0
# there, so the levels' parities leave the trellis's states
PARITY_STEP_SEEDS = {(8, 22): 2, (8, 27): 168, (16, 22): 26, (16, 27): 115,
                     (32, 22): 29, (32, 27): 42}


def _quant_coefs(rng, s, qp, tab):
    """(kind, (n, s, s) int32 coefficients) of one TU side at one QP:
    random ones (a spread of amplitudes falling with frequency, a few at
    the int16 limits), near-ties on or next to the dependent quantizers'
    half-steps (tests/test_torch_sdh_dq.py's _half_steps), transform
    skip's (sparse residuals << 7 - log2 s, where the trellis may step
    through a zero coefficient on a level of parity 1, which the TU
    emits as 0), all zeros."""
    amp = rng.choice([8, 60, 400, 3000], size=(3, 1, 1))
    c = rng.integers(-1, 2, (3, s, s)) * rng.integers(0, 1 << 15,
                                                       (3, s, s)) % (amp + 1)
    c = c // (1 + np.add.outer(np.arange(s), np.arange(s))[None])
    c[0, 0, :2] = (-32768, 32767)
    qbits = 14 + qp // 6 + 7 - int(np.log2(s))
    m = rng.integers(0, 40, (2, s, s))
    a = np.rint((m + 0.5) * (1 << (qbits - 1)) / tab.quant_scales[qp % 6])
    a = a.astype(np.int64) + rng.integers(-1, 2, a.shape)
    ties = np.clip(rng.choice([-1, 1], a.shape) * a, -32768, 32767)
    def skip(g, n):
        res = g.integers(-60, 61, (n, s, s)) * (g.random((n, s, s)) < 0.5)
        return (res << (7 - int(np.log2(s)))).astype(np.int32)

    kinds = [("random", c.astype(np.int32)),
             ("near-ties", ties.astype(np.int32)),
             ("transform-skip", skip(rng, 4)),
             ("zeros", np.zeros((1, s, s), np.int32))]
    if (s, qp) in PARITY_STEP_SEEDS:
        kinds.append(("parity step at a zero", skip(np.random.default_rng(
            PARITY_STEP_SEEDS[s, qp]), 1)))
    return kinds


def _quant_tu(lib, dq, s, g, plane, qp, rdoq, lam, rate, c):
    lev = np.full((s, s), -99999, np.int32)
    deq = np.full((s, s), -99999, np.int32)
    assert lib.x266_quant_tu(int(dq), s, g, plane, qp, int(rdoq), lam,
                             rate.ctypes.data, c.ctypes.data,
                             lev.ctypes.data, deq.ctypes.data) == 0
    return lev, deq


@pytest.mark.parametrize("dq", [False, True], ids=["sdh", "dq"])
@pytest.mark.parametrize("s,g,plane", QUANT_TUS,
                         ids=[f"{s}x{s}-g{g}-p{p}" for s, g, p in QUANT_TUS])
def test_quantizer_tu_matches_plain(s, g, plane, dq, host_lib):
    """The recon kernels' TU-wide quantizers alone (x266_quant_tu) on one
    TU of each side at the luma and chroma group widths: DQ's trellis and
    its state-dependent dequantization against kernels/quant.py's
    dq_quantize_trellis and dq_dequantize, SDH (on RDOQ's and on the
    deadzone quantizer's levels) against sdh_adjust, bit for bit, at QPs
    22-37 on random coefficients, near-ties and all zeros; the quantizer
    changes levels somewhere."""
    from x266_tpu_torch.kernels import quant as tq

    tab = tables.from_reference(CodecConfig(width=64, height=64), "cpu")
    rate = tab.rate.numpy().astype(np.float32)
    rng = np.random.default_rng(s * 7 + g + plane)
    changed = 0
    for qp in QUANT_QPS:
        lam = float(np.float32(tq.default_lam(qp) * (1.5 if qp > 30
                                                     else 1.0)))
        for kind, coefs in _quant_coefs(rng, s, qp, tab):
            ct = torch.from_numpy(coefs)
            if dq:
                want = tq.dq_quantize_trellis(tab, ct, qp, s, lam)
                wdeq = tq.dq_dequantize(tab, want, qp, s)
            for i, c in enumerate(coefs):
                rdoq = i % 2 == 0
                lev, deq = _quant_tu(host_lib, dq, s, g, plane, qp, rdoq,
                                     lam, rate, c)
                if dq:
                    assert lev.tolist() == want[i].tolist(), (kind, qp, i)
                    assert deq.tolist() == wdeq[i].tolist(), (kind, qp, i)
                    base = tq.quantize(tab, ct[i], qp, s)
                else:
                    base = (tq.rd_quantize(tab, ct[i], qp, s, lam) if rdoq
                            else tq.quantize(tab, ct[i], qp, s))
                    w = tq.sdh_adjust(tab, base, s, coef=ct[i], qp=qp,
                                      lam=lam)
                    assert lev.tolist() == w.tolist(), (kind, qp, i, rdoq)
                changed += int((torch.from_numpy(lev) != base).any())
    assert changed > 0


def test_quantizer_warp_sync_mutation_is_caught(tmp_path_factory):
    """A build whose DQ trellis drops its warps' __syncwarp
    (X266_MUTATE_DQ_WARP_SYNC: a lane reads rows its warp's other lanes
    have not written) fails the per-TU case on a warp's 8x8 TU."""
    from x266_tpu_torch.kernels import quant as tq

    lib = ctypes.CDLL(_host_build(
        tmp_path_factory, [s for s in _build.SOURCES
                           if s.endswith("recon_quant.cu")],
        ("X266_MUTATE_DQ_WARP_SYNC",)))
    lib.x266_quant_tu.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_float]
                                  + [ctypes.c_void_p] * 4)
    tab = tables.from_reference(CodecConfig(width=64, height=64), "cpu")
    rate = tab.rate.numpy().astype(np.float32)
    c = _quant_coefs(np.random.default_rng(3), 8, 27, tab)[1][1][0]
    lam = float(np.float32(tq.default_lam(27)))
    want = tq.dq_quantize_trellis(tab, torch.from_numpy(c), 27, 8, lam)
    assert (want != 0).sum() > 16
    lev, _ = _quant_tu(lib, True, 8, 32, 0, 27, True, lam, rate, c)
    assert lev.tolist() != want.tolist()


def _tie_coefs(tab, s, qp):
    """(4, s, s) int32 TUs of side s at QP qp, each with one coefficient
    (at a corner, the DC, or within; of either sign) halfway between DQ
    quantizer 0's dequantized levels 1 and 2, the rest zero: at lambda 0
    the trellis's states 0 and 2 after it, and two states at each
    position after it, cost exactly the same, and the first state wins
    (level 2 there)."""
    tsh = 7 - int(np.log2(s))
    dscale = tab.dequant_scales[qp % 6] << (qp // 6)
    d1, d2 = ((2 * k * dscale + (1 << (6 - tsh))) >> (7 - tsh)
              for k in (1, 2))
    assert (d1 + d2) % 2 == 0
    c = np.zeros((4, s, s), np.int32)
    for i, (y, x) in enumerate([(0, 0), (s - 1, s - 1), (0, 1),
                                (s // 2, s // 2 - 1)]):
        c[i, y, x] = (d1 + d2) // 2 * (-1 if i % 2 else 1)
    return c


@pytest.mark.parametrize("s,g,plane", QUANT_TUS,
                         ids=[f"{s}x{s}-g{g}-p{p}" for s, g, p in QUANT_TUS])
def test_quantizer_state_ties_match_plain(s, g, plane, host_lib):
    """DQ's trellis on TUs whose states tie exactly (_tie_coefs, lambda
    0) picks the first least state, as dq_quantize_trellis's argmin does:
    the levels and dequantized values equal the plain scan's, level 2 at
    the tie."""
    from x266_tpu_torch.kernels import quant as tq

    tab = tables.from_reference(CodecConfig(width=64, height=64), "cpu")
    rate = tab.rate.numpy().astype(np.float32)
    for qp in (22, 32):
        coefs = _tie_coefs(tab, s, qp)
        want = tq.dq_quantize_trellis(tab, torch.from_numpy(coefs), qp, s,
                                      0.0)
        wdeq = tq.dq_dequantize(tab, want, qp, s)
        for i, c in enumerate(coefs):
            assert want[i].abs().tolist() == (2 * (c != 0)).tolist(), (qp,
                                                                     i)
            lev, deq = _quant_tu(host_lib, True, s, g, plane, qp, True, 0.0,
                                 rate, c)
            assert lev.tolist() == want[i].tolist(), (qp, i)
            assert deq.tolist() == wdeq[i].tolist(), (qp, i)


def test_quantizer_tie_order_mutation_is_caught(tmp_path_factory):
    """A build whose trellis takes the last least state on ties
    (X266_MUTATE_DQ_TIE) fails the tie case on a chroma 4x4 TU."""
    from x266_tpu_torch.kernels import quant as tq

    lib = ctypes.CDLL(_host_build(
        tmp_path_factory, [s for s in _build.SOURCES
                           if s.endswith("recon_quant.cu")],
        ("X266_MUTATE_DQ_TIE",)))
    lib.x266_quant_tu.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_float]
                                  + [ctypes.c_void_p] * 4)
    tab = tables.from_reference(CodecConfig(width=64, height=64), "cpu")
    rate = tab.rate.numpy().astype(np.float32)
    c = _tie_coefs(tab, 4, 22)[0]
    want = tq.dq_quantize_trellis(tab, torch.from_numpy(c), 22, 4, 0.0)
    lev, _ = _quant_tu(lib, True, 4, 32, 1, 22, True, 0.0, rate, c)
    assert lev.tolist() != want.tolist()


@pytest.mark.parametrize("plane", ["Y", "Cb", "Cr"])
def test_group_barrier_mutation_is_caught(plane, tmp_path_factory,
                                          monkeypatch):
    """A build of the recon kernel whose luma, Cb or Cr warp group skips
    its named barrier (X266_MUTATE_GROUP_BARRIER = 1 + plane) fails the
    concurrent wavefront case of test_wavefront_rows_run_concurrently
    ("intra": every row of 3x3 CTUs at once): its TUs of more than 64
    samples read coefficients its other warps have not written."""
    import ctypes

    bar = 1 + ["Y", "Cb", "Cr"].index(plane)
    recon_src = [s for s in _build.SOURCES if s.endswith(
        ("recon_intra.cu", "recon_quant.cu", "recon_cclm.cu",
         "recon_cu64.cu", "recon_cu64_cclm.cu"))]
    lib = _build.declare_recon(ctypes.CDLL(_host_build(
        tmp_path_factory, recon_src,
        (f"X266_MUTATE_GROUP_BARRIER={bar}",))))
    monkeypatch.setenv("X266_HOST_BLOCKS", "8")
    cfg = WAVE["intra"]
    tab = tables.from_reference(cfg, "cpu")
    frames = synthetic_clip(cfg.width, cfg.height, 2, "mixed", seed=5)
    planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
              for p in ("y", "cb", "cr")]
    src = fused._unpack_padded(cfg, *planes)
    maps = fused.make_pass_a(cfg, tab)(src[0])
    # the plane has TUs of more than 64 samples (luma 16x16 and 32x32
    # CUs, chroma only 32x32 ones)
    assert (maps[0] >= (16 if bar == 1 else 32)).any()
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    err, got = recon_cuda._launch(lib, 0, cfg, tab, True, *src, *maps)
    same = err == 0 and all(torch.equal(w, g) for w, g in zip(want, got))
    assert not same


# CCLM on 3x3-CTU pictures whose chroma is made from the luma: alone, with
# the intra tools and substitution, with LFNST and DQ, with SDH beside
# transform skip, lossless, and without substitution
CCLM = {
    "cclm": (preset_cfg2(136, 136).replace(cclm=True), "mixed"),
    "cclm-tools": (preset_cfg2(136, 136).replace(
        cclm=True, pdpc=True, mip=True, transform_skip=True), "text"),
    "cclm-lfnst-dq": (preset_cfg2(136, 136).replace(
        cclm=True, lfnst=True, dep_quant=True), "mixed"),
    "cclm-sdh-ts": (preset_cfg2(136, 136).replace(
        cclm=True, sign_data_hiding=True, transform_skip=True), "text"),
    "cclm-lossless": (CodecConfig(width=136, height=136, qp=30,
                                  profile=Profile.VVC, lossless=True,
                                  cclm=True), "mixed"),
    "cclm-nosubst": (preset_cfg2(136, 136).replace(
        cclm=True, ref_substitute=False), "mixed"),
}


def _cclm_case(cfg, kind):
    tab = tables.from_reference(cfg, "cpu")
    planes = _planes(luma_chroma(synthetic_clip(cfg.width, cfg.height, 1,
                                                kind, seed=5))[0])
    src = fused._unpack_padded(cfg, *planes)
    return tab, src, fused.make_pass_a(cfg, tab)(src[0])


@pytest.mark.parametrize("name", list(CCLM))
def test_cclm_kernel_source_matches_plain_scan(name, host_lib):
    """K1's and K2's CCLM instances (each quantizer's) against the plain
    scans: K1's outputs with the mts map it writes, K2 on those levels
    and that map against the plain decode; both choices occur.  Under
    LFNST the map keeps no LFNST index (as the reference's), so K2's
    recon is held to the plain decode's, not to K1's."""
    cfg, kind = CCLM[name]
    tab, src, maps = _cclm_case(cfg, kind)
    err, got = recon_cuda._launch(host_lib, 0, cfg, tab, True, *src, *maps)
    assert err == 0
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    assert len(got) == len(want) == 7
    for n, w, g in zip(INAMES, want, got):
        assert torch.equal(w, g), n
    cc = (got[6] >> 3) & 1
    assert cc.any() and not cc.all()
    dargs = _dec_args(cfg, got, maps)
    err, dec = recon_cuda._launch(host_lib, 0, cfg, tab, False, *dargs)
    assert err == 0
    dwant = recon.make_recon_pass_raw(cfg, tab, False)(*dargs)
    for n, w, g in zip(INAMES, dwant, dec):
        assert torch.equal(w, g), n
    if not cfg.lfnst:
        for n, w, g in zip(INAMES, want[:3], dec[:3]):
            assert torch.equal(w, g), n


def test_cclm_wait_mutation_is_caught(tmp_path_factory, monkeypatch):
    """A build of the recon kernel whose chroma groups skip their wait on
    the luma group (X266_MUTATE_CCLM_WAIT) fails the concurrent wavefront
    case ("intra-cclm"): its chroma TUs read luma the luma group has not
    written yet."""
    import ctypes

    recon_src = [s for s in _build.SOURCES if s.endswith(
        ("recon_intra.cu", "recon_quant.cu", "recon_cclm.cu",
         "recon_cu64.cu", "recon_cu64_cclm.cu"))]
    lib = _build.declare_recon(ctypes.CDLL(_host_build(
        tmp_path_factory, recon_src, ("X266_MUTATE_CCLM_WAIT",))))
    monkeypatch.setenv("X266_HOST_BLOCKS", "8")
    cfg = WAVE["intra-cclm"]
    tab = tables.from_reference(cfg, "cpu")
    frames = luma_chroma(synthetic_clip(cfg.width, cfg.height, 2, "mixed",
                                        seed=5))
    planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
              for p in ("y", "cb", "cr")]
    src = fused._unpack_padded(cfg, *planes)
    maps = fused.make_pass_a(cfg, tab)(src[0])
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    err, got = recon_cuda._launch(lib, 0, cfg, tab, True, *src, *maps)
    same = err == 0 and all(torch.equal(w, g) for w, g in zip(want, got))
    assert not same
