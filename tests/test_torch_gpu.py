"""The port on a CUDA device: kernels K1/K2 against the plain scan, K3-P,
K4 and K5 against their plain versions, and Encoder/Decoder on the card
against the CPU path (exact equality), all-intra, low-delay P and random
access with deblock, SAO and ALF (K3-B).

This file imports no JAX, so it runs on a host without it; there, skip
tests/conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tests marked gpu skip when no CUDA device is visible.  The unmarked ones
check what holds on any host: the kernel wrappers refuse CPU tensors
(no fallback), device resolution never picks a device by itself, and
the entry points default to the card.
"""

import numpy as np
import pytest
import torch

from x266_tpu_torch import device as devmod
from x266_tpu_torch import tables
from x266_tpu_torch.api import Decoder, Encoder
from x266_tpu_torch.config import CodecConfig, Profile, preset_cfg2
from x266_tpu_torch.core.hashing import frame_md5
from x266_tpu_torch.core.yuv import synthetic_clip
from x266_tpu_torch.engine import fused, inter, recon, recon_cuda
from x266_tpu_torch.kernels import me, me_cuda

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)

CFGS = [
    CodecConfig(width=104, height=72, qp=30),
    CodecConfig(width=128, height=64, qp=37, profile=Profile.VVC, mts=True),
    CodecConfig(width=64, height=64, qp=22, max_cu_size=16),
    CodecConfig(width=104, height=72, qp=30, ref_substitute=True),
    preset_cfg2(128, 64),
    CodecConfig(width=104, height=72, qp=30, lossless=True),
    CodecConfig(width=104, height=72, qp=30, transform_skip=True),
    preset_cfg2(128, 64).replace(pdpc=True, mip=True, transform_skip=True),
]
NAMES = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr",
         "mvx_fin", "mvy_fin"]
PCFGS = [
    CodecConfig(width=112, height=80, qp=30, intra_period=8),
    CodecConfig(width=128, height=64, qp=35, intra_period=8,
                max_cu_size=16),
    CodecConfig(width=112, height=80, qp=30, intra_period=8,
                merge_cands=True, ref_substitute=True),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cfg, device, n=2, seed=9):
    """Padded planes and the port's Pass-A maps of n frames."""
    tab = tables.from_reference(cfg, device)
    frames = synthetic_clip(cfg.width, cfg.height, n, "mixed", seed=seed)
    planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
              .to(device) for p in ("y", "cb", "cr")]
    src = fused._unpack_padded(cfg, *planes)
    return tab, src, fused.make_pass_a(cfg, tab)(src[0])


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: f"{c.width}x{c.height}"
                         f"-{c.profile.name}-qp{c.qp}-cu{c.max_cu_size}"
                         f"{'-subst' if c.ref_substitute else ''}"
                         f"{'-ll' if c.lossless else ''}"
                         f"{'-pdpc-mip' if c.mip else ''}"
                         f"{'-ts' if c.transform_skip else ''}")
def test_kernels_match_plain_scan_on_card(cfg, cuda):
    tab, src, maps = _inputs(cfg, cuda)
    got = recon_cuda.recon_intra(cfg, tab, True, *src, *maps)
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    dec = recon_cuda.recon_intra(cfg, tab, False, *got[3:], *maps)
    pdec = recon.make_recon_pass_raw(cfg, tab, False)(*got[3:], *maps)
    for n, w, g, p in zip(NAMES, want, dec, pdec):
        assert torch.equal(w, g) and torch.equal(p, g), n


@pytest.mark.gpu
def test_encode_decode_on_card_equals_cpu(cuda):
    cfg = preset_cfg2(128, 64).replace(rows_per_segment=1,
                                       ctx_inherit=True)
    frames = synthetic_clip(128, 64, 3, "mixed", seed=5)
    before = dict(recon_cuda.LAUNCHES)
    on_card = Encoder(cfg, device=cuda, batch_frames=2).encode(frames)
    on_cpu = Encoder(cfg, device="cpu", batch_frames=2).encode(frames)
    assert on_card.bitstream == on_cpu.bitstream
    assert np.array_equal(np.array(on_card.sse), np.array(on_cpu.sse))
    _, dec = Decoder(device=cuda).decode(on_card.bitstream)
    assert ([frame_md5(d) for d in dec]
            == [frame_md5(r) for r in on_card.recon]
            == [frame_md5(r) for r in on_cpu.recon])
    assert recon_cuda.LAUNCHES["K1"] == before["K1"] + 2
    assert recon_cuda.LAUNCHES["K2"] == before["K2"] + 3


def _p_inputs(cfg, device, seed=3):
    """A P picture (a mixed frame) with the frame shifted as its
    reference: padded planes, pyramids, the ME inputs and Pass-A maps."""
    tab = tables.from_reference(cfg, device)
    f = synthetic_clip(cfg.width, cfg.height, 1, "mixed", seed=seed)[0]
    planes = [torch.from_numpy(getattr(f, p)[None].copy()).to(device)
              for p in ("y", "cb", "cr")]
    refs = [torch.roll(p[0], sh, (0, 1))
            for p, sh in zip(planes, ((2, -3), (1, -1), (1, -1)))]
    pyrs = fused.build_pyramids_device(*refs)
    src = fused._unpack_padded(cfg, *planes)
    cur = me._ceil_pad(planes[0][0].to(torch.int32)).contiguous()
    base = me.coarse_search(cur, pyrs[0], float(cfg.lambda_mode))
    maps = [m[None] for m in inter.make_mode_decision_p_raw(cfg, tab)(
        src[0][0], pyrs[0])]
    args = (maps[0], maps[1], torch.zeros_like(maps[0]), *maps[2:], *pyrs)
    return tab, src, pyrs, cur, base, args


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", PCFGS, ids=["cu32", "cu16", "merge-subst"])
def test_inter_kernels_match_plain_on_card(cfg, cuda):
    tab, src, pyrs, cur, base, args = _p_inputs(cfg, cuda)
    assert torch.equal(me_cuda.refine_search(cur, pyrs[0], base),
                       me.refine_search_ref(cur, pyrs[0], base))
    mvs = torch.stack([base * 4, -base * 4]).contiguous()
    assert torch.equal(me_cuda.warp_frames_cuda(pyrs[0], mvs),
                       me_cuda.warp_frames_ref(pyrs[0], mvs))
    got = recon_cuda.recon_inter(cfg, tab, True, *src, *args)
    want = inter.make_recon_inter_raw(cfg, tab, True)(*src, *args)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    dargs = (*args[:4], got[6].int(), got[7].int(), *args[6:])
    dec = recon_cuda.recon_inter(cfg, tab, False, *got[3:6], *dargs)
    for n, w, g in zip(NAMES, want, dec):
        assert torch.equal(w, g), n


@pytest.mark.gpu
def test_lowdelay_encode_decode_on_card_equals_cpu(cuda):
    cfg = CodecConfig(width=128, height=64, qp=32, intra_period=4,
                      rdoq=True, ref_substitute=True, merge_cands=True)
    frames = synthetic_clip(128, 64, 5, "motion", seed=3)
    me_cuda.reset_launches()
    recon_cuda.reset_launches()
    on_card = Encoder(cfg).encode(frames)
    on_cpu = Encoder(cfg, device="cpu").encode(frames)
    assert on_card.bitstream == on_cpu.bitstream
    _, dec = Decoder().decode(on_card.bitstream)
    assert ([frame_md5(d) for d in dec]
            == [frame_md5(r) for r in on_card.recon]
            == [frame_md5(r) for r in on_cpu.recon])
    assert recon_cuda.LAUNCHES["K3"] == recon_cuda.LAUNCHES["K3d"] == 3
    assert me_cuda.LAUNCHES["K4"] == me_cuda.LAUNCHES["K5"] == 3


@pytest.mark.gpu
def test_ra_encode_decode_on_card_equals_cpu(cuda):
    """Random access (I, P, B at POC 2, 1, 3) with the loop filters: the
    card's stream is the CPU's, byte for byte (the ALF estimator sums
    exactly on both), and K3-B runs once per B picture each way."""
    from x266_tpu_torch.config import preset_cfg4

    cfg = preset_cfg4(128, 64).replace(gop_size=4, intra_period=8)
    frames = synthetic_clip(128, 64, 5, "mixed", seed=4)
    recon_cuda.reset_launches()
    on_card = Encoder(cfg).encode(frames)
    on_cpu = Encoder(cfg, device="cpu").encode(frames)
    assert on_card.bitstream == on_cpu.bitstream
    _, dec = Decoder().decode(on_card.bitstream)
    assert ([frame_md5(d) for d in dec]
            == [frame_md5(r) for r in on_card.recon]
            == [frame_md5(r) for r in on_cpu.recon])
    assert recon_cuda.LAUNCHES["K3B"] == recon_cuda.LAUNCHES["K3Bd"] == 3


@pytest.mark.gpu
def test_alf_estimators_on_card_equal_cpu(cuda):
    """The ALF estimators' normal sums, float32 solve and coefficients
    (the ALF kernel on the card, the plain torch ops on the CPU) and
    their flags and filtered planes give the same bits on both."""
    from x266_tpu_torch.kernels import alf

    rng = np.random.default_rng(9)
    orig = torch.from_numpy(rng.integers(0, 256, (128, 192)).astype(np.int32))
    rec = (orig + torch.from_numpy(rng.integers(-6, 7, (128, 192)))).clamp(
        0, 255).to(torch.int32)
    out = []
    for dev in ("cpu", cuda):
        o, r = orig.to(dev), rec.to(dev)
        res = (*alf.normal_solve(r, o, alf.classify(r), with_sums=True),
               *alf.normal_solve(r[:64, :96], o[:64, :96], with_sums=True),
               alf.ctb_flags(r, (r + 3).clamp(0, 255), o, 64, 57.0),
               *alf.estimate_alf(o, r, 57.0),
               *alf.estimate_alf_chroma(o[:64, :96], r[:64, :96], 57.0))
        out.append([t.cpu() for t in res])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["vsadu4", "funnelshift_r", "byte_perm",
                                "reduce_add", "reduce_min", "cp_async4",
                                "vabsdiffu4", "dp4a", "bulk_copy"])
def test_device_primitives_on_card_match_definitions(op, cuda):
    """The card's __vsadu4, __funnelshift_r, __byte_perm, the warp
    reductions, x266_cp_async4, __vabsdiffu4, __dp4a and x266_bulk_copy
    on an mbarrier give what tests/test_torch_kernel_host.py holds the host stand-in's
    to."""
    from test_torch_kernel_host import (PRIMITIVES, PRIMITIVES_SRC,
                                        declare_primitives, primitive_case)
    from x266_tpu_torch import _build

    lib = _build.Library([PRIMITIVES_SRC], prefix="test-",
                         signatures=declare_primitives).build()
    k = PRIMITIVES.index(op)
    a, b, c, want = primitive_case(k)
    dev = [torch.from_numpy(x.view(np.int32)).to(cuda) for x in (a, b, c)]
    out = torch.zeros_like(dev[0])
    assert lib.x266_primitives(k, a.size, *(t.data_ptr() for t in dev),
                               out.data_ptr()) == 0
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint32), want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 1080, 1920), (1, 80, 112),
                                   (2, 64, 64)],
                         ids=["1080p-F4", "112x80", "64x64-F2"])
def test_picture_sse_on_card_matches_plain(shape, cuda):
    """Kernel SSE's one launch for the three planes of F frames against
    the plain versions (the float32 SSE in XLA's order and fused.frame_sse),
    near and far from the source, twice on the stream's buffers."""
    from x266_tpu_torch.kernels import cost, sse_cuda

    rng = np.random.default_rng(shape[1])
    n, h, w = shape
    src = [rng.integers(0, 256, s).astype(np.uint8)
           for s in ((n, h, w), (n, h // 2, w // 2), (n, h // 2, w // 2))]
    for rec in ([np.clip(o + rng.integers(-3, 4, o.shape), 0, 255).astype(
                    np.uint8) for o in src],
                [(np.where(o < 128, 255, 0) ^ rng.integers(0, 64, o.shape))
                 .astype(np.uint8) for o in src]):
        r_t, o_t = ([torch.from_numpy(x) for x in xs] for xs in (rec, src))
        want = (torch.stack([cost.plane_sse_f32_plain(r, o)
                             for r, o in zip(r_t, o_t)], dim=1),
                torch.stack([fused.frame_sse(r, o)
                             for r, o in zip(r_t, o_t)], dim=1))
        for _ in range(2):
            got = sse_cuda.picture_sse([r.to(cuda) for r in r_t],
                                       [o.to(cuda) for o in o_t])
            for g, wnt in zip(got, want):
                assert torch.equal(g.cpu(), wnt)


def test_kernel_wrapper_refuses_cpu_tensors():
    cfg = CFGS[0]
    tab, src, maps = _inputs(cfg, "cpu", n=1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        recon_cuda.recon_intra(cfg, tab, True, *src, *maps)


def test_alf_kernel_wrapper_refuses_cpu_tensors():
    from x266_tpu_torch.kernels import alf, alf_cuda

    r = torch.zeros((16, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        alf_cuda.normal_solve(r, r, alf.classify(r))
    with pytest.raises(ValueError, match="CUDA tensor"):
        alf_cuda.ctb_flags(r, r, r, 64, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        alf_cuda.ctb_sse(r, r, 64)


def test_sse_kernel_wrapper_refuses_cpu_tensors():
    from x266_tpu_torch.kernels import sse_cuda

    p = torch.zeros((1, 64, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sse_cuda.picture_sse([p, p, p], [p, p, p])


def test_motion_kernel_wrappers_refuse_cpu_tensors():
    cfg = PCFGS[0]
    tab, src, pyrs, cur, base, args = _p_inputs(cfg, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        me_cuda.refine_search(cur, pyrs[0], base)
    with pytest.raises(ValueError, match="CUDA tensor"):
        me_cuda.warp_frames_cuda(pyrs[0], base[None].contiguous())
    with pytest.raises(ValueError, match="CUDA tensor"):
        recon_cuda.recon_inter(cfg, tab, True, *src, *args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        recon_cuda.recon_inter(cfg, tab, True, *src, *args, *args[6:9],
                               args[4], args[5])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    with pytest.raises(RuntimeError, match="is_available"):
        Encoder(CodecConfig(width=64, height=64))
    with pytest.raises(RuntimeError, match="is_available"):
        Decoder()


def test_device_is_never_chosen_implicitly():
    assert devmod.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        devmod.resolve("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            devmod.resolve("cuda")
