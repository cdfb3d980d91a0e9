"""The port on a CUDA device: kernels K1/K2 against the plain scan, K3-P,
K4 and K5 against their plain versions, and Encoder/Decoder on the card
against the CPU path (exact equality), all-intra, low-delay P and random
access with deblock, SAO and ALF (K3-B); K1/K2 and K3-P under sign-data
hiding and dependent quantization, and the 128x64 SDH / DQ clips against
their recorded JAX streams; K1/K2 under MTT and LFNST, and the 128x64
MTT / LFNST clips and the ai_vvc_mtt_lfnst fixture on the card; K1/K2's
CCLM instances and the 128x64 CCLM clips on the card.

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


@pytest.mark.gpu
def test_nonlinear_alf_estimators_on_card_equal_cpu(cuda):
    """The nonlinear luma and chroma estimators and CC-ALF (the ALF
    kernel's clipped, aligned and CC-ALF features, the class-SSE kernel,
    kernel SSE for the chroma levels and the CTB kernel's gate on the
    card; the plain torch ops on the CPU) give the same bits on both,
    per-class and per-level SSEs included, far from the source and near
    it."""
    from x266_tpu_torch.kernels import alf

    rng = np.random.default_rng(12)
    out = []
    for amp in (6, 255):
        orig = torch.from_numpy(rng.integers(0, 256, (128, 192))
                                .astype(np.int32))
        rec = (orig + torch.from_numpy(rng.integers(-amp, amp + 1,
                                                    (128, 192)))).clamp(
            0, 255).to(torch.int32)
        for dev in ("cpu", cuda):
            o, r = orig.to(dev), rec.to(dev)
            oc, rc = o[:64, :96].contiguous(), r[64:, 96:].contiguous()
            res = (*alf.estimate_alf_nonlinear(o, r, 57.0, with_sse=True),
                   *alf.estimate_alf_chroma_nl(oc, rc, 57.0, with_sse=True),
                   *alf.estimate_ccalf(oc, rc, r, 57.0),
                   *alf.estimate_ccalf(oc, rc, r, 2.0))
            out.append([t.cpu() for t in res])
    for cpu, card in (out[:2], out[2:]):
        for a, b in zip(cpu, card):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_ra_nl_and_rc_streams_on_card_equal_recorded_jax(cuda):
    """On the card: the 128x64 random-access clip with nonlinear ALF and
    CC-ALF gives data/ra_nl128x64_ref.json's stream, and the
    rate-controlled low-delay clip (make_lambda_controller)
    data/rc128x64_ref.json's stream and QPs; ALFCLS runs once a
    picture."""
    import base64
    import json
    import os

    from x266_tpu_torch.config import preset_cfg3, preset_cfg4
    from x266_tpu_torch.kernels import alf_cuda
    from x266_tpu_torch.utils import ratecontrol
    from x266_tpu_torch.utils.clips import luma_chroma

    data = os.path.join(os.path.dirname(__file__), "..", "x266_tpu_torch",
                        "data")
    with open(os.path.join(data, "ra_nl128x64_ref.json")) as f:
        ref = json.load(f)
    cfg = preset_cfg4(128, 64).replace(gop_size=4, intra_period=8,
                                       alf_nonlinear=True, ccalf=True)
    alf_cuda.reset_launches()
    res = Encoder(cfg).encode(luma_chroma(
        synthetic_clip(128, 64, 5, "motion", seed=3)))
    assert res.bitstream == base64.b64decode(ref["stream_b64"])
    assert alf_cuda.LAUNCHES["ALFCLS"] == 5
    with open(os.path.join(data, "rc128x64_ref.json")) as f:
        ref = json.load(f)["variants"]["p_lambda"]
    cfg = preset_cfg3(128, 64).replace(intra_period=4)
    c = ref["controller"]
    rc = ratecontrol.make_lambda_controller(cfg, c["bitrate_kbps"], c["fps"],
                                            n_frames=c["n_frames"])
    res = Encoder(cfg, rate_control=rc).encode(
        synthetic_clip(128, 64, c["n_frames"], "motion", seed=3))
    assert res.bitstream == base64.b64decode(ref["stream_b64"])


# sign-data hiding and dependent quantization: K1/K2 (VVC with MTS and
# transform skip; DQ with and without RDOQ), K3-P and K3-B
QCFGS = [
    preset_cfg2(128, 64).replace(transform_skip=True, sign_data_hiding=True),
    preset_cfg2(128, 64).replace(dep_quant=True),
    preset_cfg2(128, 64).replace(dep_quant=True, transform_skip=True,
                                 rdoq=False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", QCFGS, ids=["sdh-ts", "dq", "dq-ts"])
def test_sdh_dq_intra_kernels_match_plain_scan_on_card(cfg, cuda):
    """K1 and K2 under SDH or DQ on the card: the plain scan's levels and
    recon."""
    tab, src, maps = _inputs(cfg, cuda)
    got = recon_cuda.recon_intra(cfg, tab, True, *src, *maps)
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    dec = recon_cuda.recon_intra(cfg, tab, False, *got[3:], *maps)
    for n, w, g in zip(NAMES, want, dec):
        assert torch.equal(w, g), n


@pytest.mark.gpu
@pytest.mark.parametrize("flag", ["sdh", "dq"])
def test_sdh_dq_inter_kernels_match_plain_on_card(flag, cuda):
    """K3-P under SDH or DQ on the card, encode and decode: the plain
    scan's levels, recon and final MVs."""
    cfg = PCFGS[0].replace(**({"sign_data_hiding": True} if flag == "sdh"
                              else {"profile": Profile.VVC,
                                    "dep_quant": True}))
    tab, src, pyrs, cur, base, args = _p_inputs(cfg, cuda)
    got = recon_cuda.recon_inter(cfg, tab, True, *src, *args)
    want = inter.make_recon_inter_raw(cfg, tab, True)(*src, *args)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    dargs = (*args[:4], got[6].int(), got[7].int(), *args[6:])
    dec = recon_cuda.recon_inter(cfg, tab, False, *got[3:6], *dargs)
    for n, w, g in zip(NAMES, want, dec):
        assert torch.equal(w, g), n


@pytest.mark.gpu
def test_sdhdq_streams_on_card_equal_recorded_jax(cuda):
    """On the card: the 128x64 SDH and DQ clips (all-intra, low-delay P,
    random access) give data/sdhdq128x64_ref.json's streams and recon,
    through the recon kernels."""
    import base64
    import json
    import os

    from x266_tpu_torch.config import (preset_cfg2s, preset_cfg3,
                                       preset_cfg4)

    data = os.path.join(os.path.dirname(__file__), "..", "x266_tpu_torch",
                        "data")
    with open(os.path.join(data, "sdhdq128x64_ref.json")) as f:
        ref = json.load(f)["variants"]
    gop = dict(gop_size=4, intra_period=8)
    cfgs = {"ai_sdh": (preset_cfg2s(128, 64), "text", 2),
            "ai_dq_ts": (preset_cfg2(128, 64).replace(
                dep_quant=True, transform_skip=True, rdoq=False), "text", 2),
            "p_sdh": (preset_cfg3(128, 64).replace(
                intra_period=4, sign_data_hiding=True, rdoq=False),
                "motion", 5),
            "ra_sdh": (preset_cfg4(128, 64).replace(
                **gop, sign_data_hiding=True), "motion", 5),
            "ra_dq": (preset_cfg4(128, 64).replace(
                **gop, profile=Profile.VVC, dep_quant=True), "motion", 5)}
    for name, (cfg, kind, n) in cfgs.items():
        recon_cuda.reset_launches()
        res = Encoder(cfg).encode(synthetic_clip(128, 64, n, kind, seed=3))
        assert res.bitstream == base64.b64decode(ref[name]["stream_b64"])
        assert [frame_md5(r) for r in res.recon] == [
            f["recon_md5"] for f in ref[name]["frames"]]
        assert recon_cuda.LAUNCHES["K1"] > 0


MTT_CFGS = {
    "mtt-lfnst": preset_cfg2(128, 64).replace(mtt=True, lfnst=True),
    "mtt-sdh": preset_cfg2(128, 64).replace(mtt=True,
                                            sign_data_hiding=True),
    "mtt-lfnst-dq": preset_cfg2(128, 64).replace(mtt=True, lfnst=True,
                                                 dep_quant=True),
    "mtt-lfnst-nosubst": preset_cfg2(128, 64).replace(
        mtt=True, lfnst=True, ref_substitute=False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(MTT_CFGS))
def test_mtt_lfnst_kernels_match_plain_scan_on_card(name, cuda):
    """K1 and K2 under MTT and LFNST on the card (the plain, SDH and DQ
    instances): the plain scan's levels and recon, on 'text' maps with
    BT-H and BT-V leaves of 16 and 32."""
    cfg = MTT_CFGS[name]
    tab = tables.from_reference(cfg, cuda)
    frames = synthetic_clip(128, 64, 1, "text", seed=10)
    planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
              .to(cuda) for p in ("y", "cb", "cr")]
    src = fused._unpack_padded(cfg, *planes)
    maps = fused.make_pass_a(cfg, tab)(src[0])
    assert (((maps[2] >> 4) & 3) > 0).any()
    got = recon_cuda.recon_intra(cfg, tab, True, *src, *maps)
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    for n, w, g in zip(NAMES, want, got):
        assert torch.equal(w, g), n
    dec = recon_cuda.recon_intra(cfg, tab, False, *got[3:], *maps)
    for n, w, g in zip(NAMES, want, dec):
        assert torch.equal(w, g), n


@pytest.mark.gpu
def test_mtt_lfnst_streams_on_card_equal_recorded_jax(cuda):
    """On the card: the 128x64 MTT / LFNST clips give
    data/mttlfnst128x64_ref.json's streams and recon through the recon
    kernels, and the ai_vvc_mtt_lfnst fixture decodes to its manifest
    MD5s."""
    import base64
    import json
    import os

    from x266_tpu_torch.config import preset_cfg2q, preset_cfg3

    here = os.path.dirname(__file__)
    with open(os.path.join(here, "..", "x266_tpu_torch", "data",
                           "mttlfnst128x64_ref.json")) as f:
        ref = json.load(f)["variants"]
    cfgs = {"ai_text": (preset_cfg2(128, 64).replace(mtt=True, lfnst=True),
                        "text", 2, 10),
            "ai_q": (preset_cfg2q(128, 64), "mixed", 1, 2),
            "ld": (preset_cfg3(128, 64).replace(
                profile=Profile.VVC, mtt=True, lfnst=True, deblock=True,
                intra_period=4), "motion", 3, 4)}
    for name, (cfg, kind, n, seed) in cfgs.items():
        recon_cuda.reset_launches()
        res = Encoder(cfg).encode(synthetic_clip(128, 64, n, kind,
                                                 seed=seed))
        assert res.bitstream == base64.b64decode(ref[name]["stream_b64"])
        assert [frame_md5(r) for r in res.recon] == [
            f["recon_md5"] for f in ref[name]["frames"]]
        assert recon_cuda.LAUNCHES["K1"] > 0
    with open(os.path.join(here, "fixtures", "ai_vvc_mtt_lfnst.266t"),
              "rb") as f:
        stream = f.read()
    with open(os.path.join(here, "fixtures", "manifest.json")) as f:
        want = json.load(f)["ai_vvc_mtt_lfnst"]["md5"]
    recon_cuda.reset_launches()
    _, dec = Decoder().decode(stream)
    assert [frame_md5(d) for d in dec] == want
    assert recon_cuda.LAUNCHES["K2"] > 0


CCLM_CFGS = {
    "cclm": preset_cfg2(128, 64).replace(cclm=True),
    "cclm-tools": preset_cfg2(128, 64).replace(
        cclm=True, pdpc=True, mip=True, transform_skip=True),
    "cclm-lfnst-dq": preset_cfg2(128, 64).replace(cclm=True, lfnst=True,
                                                  dep_quant=True),
    "cclm-sdh": preset_cfg2(128, 64).replace(cclm=True,
                                             sign_data_hiding=True),
}


def _cclm_inputs(cfg, dev):
    from x266_tpu_torch.utils.clips import luma_chroma

    tab = tables.from_reference(cfg, dev)
    frames = luma_chroma(synthetic_clip(128, 64, 1, "mixed", seed=7))
    planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
              .to(dev) for p in ("y", "cb", "cr")]
    src = fused._unpack_padded(cfg, *planes)
    return tab, src, fused.make_pass_a(cfg, tab)(src[0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CCLM_CFGS))
def test_cclm_kernels_match_plain_scan_on_card(name, cuda):
    """K1 and K2's CCLM instances on the card (the plain, SDH and DQ
    quantizers'): the plain scan's levels, recon and mts map with the
    CCLM choices in bit 3, and K2 on those levels and that map the plain
    decode's recon; both choices occur."""
    cfg = CCLM_CFGS[name]
    tab, src, maps = _cclm_inputs(cfg, cuda)
    got = recon_cuda.recon_intra(cfg, tab, True, *src, *maps)
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    assert len(got) == len(want) == 7
    for n, w, g in zip(NAMES[:6] + ["mts_out"], want, got):
        assert torch.equal(w, g), n
    cc = (got[6] >> 3) & 1
    assert cc.any() and not cc.all()
    dargs = (*got[3:6], maps[0], maps[1], got[6])
    dec = recon_cuda.recon_intra(cfg, tab, False, *dargs)
    dwant = recon.make_recon_pass_raw(cfg, tab, False)(*dargs)
    for n, w, g in zip(NAMES, dwant, dec):
        assert torch.equal(w, g), n


@pytest.mark.gpu
def test_cclm_streams_on_card_equal_recorded_jax(cuda):
    """On the card: the 128x64 CCLM clips give data/cclm128x64_ref.json's
    streams and recon through the recon kernels, and the Decoder gives
    the JAX decoder's pictures of each."""
    import base64
    import json
    import os

    from x266_tpu_torch import config as tconfig
    from x266_tpu_torch.utils.clips import luma_chroma

    here = os.path.dirname(__file__)
    with open(os.path.join(here, "..", "x266_tpu_torch", "data",
                           "cclm128x64_ref.json")) as f:
        ref = json.load(f)["variants"]
    names = {k: getattr(tconfig, k) for k in (
        "preset_cfg2", "preset_cfg2s", "preset_cfg3", "preset_cfg4",
        "CodecConfig", "Profile")}
    for name, v in ref.items():
        cfg = eval(v["config"], names)
        frames = eval(v["clip"], {"luma_chroma": luma_chroma,
                                  "synthetic_clip": synthetic_clip})
        recon_cuda.reset_launches()
        res = Encoder(cfg).encode(frames)
        assert res.bitstream == base64.b64decode(v["stream_b64"]), name
        assert [frame_md5(r) for r in res.recon] == [
            f["recon_md5"] for f in v["frames"]], name
        assert recon_cuda.LAUNCHES["K1"] > 0
        _, dec = Decoder().decode(res.bitstream)
        assert [frame_md5(d) for d in dec] == [
            f["decode_md5"] for f in v["frames"]], name
        assert recon_cuda.LAUNCHES["K2"] > 0


CU64_CFGS = {
    "cu64": CodecConfig(width=192, height=128, qp=32, rdoq=True,
                        profile=Profile.VVC, max_cu_size=64, mts=True,
                        ref_substitute=True, pdpc=True),
    "cu64-cclm": CodecConfig(width=192, height=128, qp=32, rdoq=True,
                             profile=Profile.VVC, max_cu_size=64,
                             cclm=True),
    "cu64-lfnst": CodecConfig(width=192, height=128, qp=32, rdoq=True,
                              profile=Profile.VVC, max_cu_size=64,
                              mts=True, lfnst=True),
}


def _cu64_inputs(cfg, dev):
    """Smooth directional blocks (64 CUs win on them), chroma made from
    the luma, and the port's Pass-A maps."""
    from x266_tpu_torch.utils.clips import luma_chroma, smooth_blocks

    tab = tables.from_reference(cfg, dev)
    frames = luma_chroma(smooth_blocks(synthetic_clip(
        cfg.width, cfg.height, 2, "mixed", seed=3), 3))
    planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
              .to(dev) for p in ("y", "cb", "cr")]
    src = fused._unpack_padded(cfg, *planes)
    return tab, src, fused.make_pass_a(cfg, tab)(src[0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CU64_CFGS))
def test_cu64_kernels_match_plain_scan_on_card(name, cuda):
    """K1 and K2's CU-64 instances on the card: the plain scan's levels
    and recon (under CCLM its mts map), and K2 on those levels the plain
    decode's recon, with 64 CUs coded."""
    cfg = CU64_CFGS[name]
    tab, src, maps = _cu64_inputs(cfg, cuda)
    assert (maps[0] == 64).any()
    got = recon_cuda.recon_intra(cfg, tab, True, *src, *maps)
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    assert len(got) == len(want)
    for n, w, g in zip(NAMES[:6] + ["mts_out"], want, got):
        assert torch.equal(w, g), n
    dargs = (*got[3:6], maps[0], maps[1], got[6] if cfg.cclm else maps[2])
    dec = recon_cuda.recon_intra(cfg, tab, False, *dargs)
    dwant = recon.make_recon_pass_raw(cfg, tab, False)(*dargs)
    for n, w, g in zip(NAMES, dwant, dec):
        assert torch.equal(w, g), n


@pytest.mark.gpu
def test_cu64_streams_on_card_equal_recorded_jax(cuda):
    """On the card: the 128x64 CU-64 clips give data/cu64_128x64_ref.json's
    streams and recon through the recon kernels, and the Decoder gives
    the JAX decoder's pictures of each."""
    import base64
    import json
    import os

    from x266_tpu_torch import config as tconfig
    from x266_tpu_torch.utils.clips import luma_chroma, smooth_blocks

    here = os.path.dirname(__file__)
    with open(os.path.join(here, "..", "x266_tpu_torch", "data",
                           "cu64_128x64_ref.json")) as f:
        ref = json.load(f)["variants"]
    names = {k: getattr(tconfig, k) for k in ("CodecConfig", "Profile")}
    for name, v in ref.items():
        cfg = eval(v["config"], names)
        frames = eval(v["clip"], {"luma_chroma": luma_chroma,
                                  "smooth_blocks": smooth_blocks,
                                  "synthetic_clip": synthetic_clip})
        recon_cuda.reset_launches()
        res = Encoder(cfg).encode(frames)
        assert res.bitstream == base64.b64decode(v["stream_b64"]), name
        assert [frame_md5(r) for r in res.recon] == [
            f["recon_md5"] for f in v["frames"]], name
        assert recon_cuda.LAUNCHES["K1"] > 0
        _, dec = Decoder().decode(res.bitstream)
        assert [frame_md5(d) for d in dec] == [
            f["decode_md5"] for f in v["frames"]], name
        assert recon_cuda.LAUNCHES["K2"] > 0


def test_cu64_entry_points_default_to_the_card():
    """Encoder and Decoder of a CU-64 configuration default to the card
    and raise on a host without one (no fall back to the CPU); the recon
    kernels' wrappers refuse CPU tensors under CU 64."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    cfg = CU64_CFGS["cu64-cclm"]
    with pytest.raises(RuntimeError, match="is_available"):
        Encoder(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        Decoder()
    tab, src, maps = _cu64_inputs(cfg, "cpu")
    for encode in (True, False):
        with pytest.raises(ValueError, match="CUDA tensor"):
            recon_cuda.recon_intra(cfg, tab, encode, *src, *maps)


def test_cclm_entry_points_default_to_the_card():
    """Encoder and Decoder of a configuration with CCLM default to the
    card and raise on a host without one (no fall back to the CPU); the
    recon kernels' wrappers refuse CPU tensors under CCLM."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    for cfg in CCLM_CFGS.values():
        with pytest.raises(RuntimeError, match="is_available"):
            Encoder(cfg)
        tab, src, maps = _cclm_inputs(cfg, "cpu")
        for encode in (True, False):
            with pytest.raises(ValueError, match="CUDA tensor"):
                recon_cuda.recon_intra(cfg, tab, encode, *src, *maps)


def test_mtt_lfnst_entry_points_default_to_the_card():
    """Encoder and Decoder of a configuration with MTT and LFNST default
    to the card and raise on a host without one (no fall back to the
    CPU); the recon kernels' wrappers refuse CPU tensors under either
    flag."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    for cfg in MTT_CFGS.values():
        with pytest.raises(RuntimeError, match="is_available"):
            Encoder(cfg)
        tab, src, maps = _inputs(cfg, "cpu", n=1)
        with pytest.raises(ValueError, match="CUDA tensor"):
            recon_cuda.recon_intra(cfg, tab, True, *src, *maps)


def test_sdh_dq_entry_points_default_to_the_card():
    """Encoder and Decoder of a configuration with SDH or DQ default to
    the card and raise on a host without one (no fall back to the CPU);
    the recon kernels' wrappers refuse CPU tensors under either flag."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    for cfg in QCFGS:
        with pytest.raises(RuntimeError, match="is_available"):
            Encoder(cfg)
        tab, src, maps = _inputs(cfg, "cpu", n=1)
        with pytest.raises(ValueError, match="CUDA tensor"):
            recon_cuda.recon_intra(cfg, tab, True, *src, *maps)
    with pytest.raises(RuntimeError, match="is_available"):
        Decoder()


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


def test_nonlinear_alf_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers of the nonlinear and CC-ALF paths launch their kernel
    or raise; on CPU tensors they raise."""
    from x266_tpu_torch.kernels import alf, alf_cuda

    r = torch.zeros((16, 16), dtype=torch.int32)
    cls, tr = alf.classify_full(r)
    with pytest.raises(ValueError, match="CUDA tensor"):
        alf_cuda.normal_solve(r, r, cls, clip=32, transpose=tr)
    with pytest.raises(ValueError, match="CUDA tensor"):
        alf_cuda.cc_normal_solve(r, r[:8, :8], r[:8, :8])
    with pytest.raises(ValueError, match="CUDA tensor"):
        alf_cuda.class_sse(r[None], r, cls)
    with pytest.raises(ValueError, match="CUDA tensor"):
        alf_cuda.ccalf_gate(r, r, r, 1.0)


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
