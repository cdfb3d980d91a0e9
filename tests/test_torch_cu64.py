"""64x64 CUs (max_cu_size=64: all-intra VVC, the 64-point DCT-II and its
zero-out) in the port against the JAX package on the CPU, exactly (bit
for bit; the reference's XLA scan, since its Pallas kernel never takes
CU 64):

- the 64-point transforms with the zero-out (only the low 32x32 band of
  a forward transform survives), the quantizer, dequantizer and RDOQ at
  64, and the 64 size's prediction of all 67 modes, with PDPC, against
  x266_tpu/kernels/{transforms,quant,intra}.py;
- Pass A's size, mode and MTS maps on tests/test_cu64.py's two
  configurations ('gradient'; 'mixed' seed 5 with MTS and substitution)
  and the 64 size's float32 costs (kernels.cost.rd_cost64, XLA's 32x32
  windows) on 'gradient', text and noise;
- the plain scan fed maps with 64 CUs of every kind of mode (planar, DC,
  pure and diagonal angles; forced over Pass A's maps, which equal the
  reference's, on textured content, so that the zero-out matters) gives
  the JAX scan's outputs, encode and decode: with MTS, substitution,
  PDPC and transform skip, and with CCLM, LFNST, MTS and substitution
  (each JAX call at CU 64 traces its 141 M-weight constant: ~10-30 s);
- whole streams against data/cu64_128x64_ref.json (tools/make_torch_refs.py
  cu64_128x64): CU 64 alone on 'gradient' and on smooth directional
  blocks (utils.clips.smooth_blocks), with MTS and substitution, with
  PDPC and transform skip, with LFNST, with CCLM, each decoded by the
  port to its recon; one stream against the live JAX encoder;
- the ai_vvc_cu64 fixture decodes to its manifest MD5 and re-encodes to
  its bytes;
- K1 and K2's CU-64 instances (csrc/recon_intra.cu, kC64;
  csrc/recon_cu64.cu, recon_cu64_cclm.cu), compiled for the host as
  tests/test_torch_kernel_host.py does, against the plain scan on the
  same forced maps, alone and with LFNST and CCLM, one block after
  another and eight at once (X266_HOST_BLOCKS).
"""

import base64
import ctypes
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernel_host import INAMES, _dec_args, _host_build
from x266_tpu.api import Encoder as JaxEncoder
from x266_tpu.config import CodecConfig, Profile
from x266_tpu.core.yuv import synthetic_clip as jclip
from x266_tpu.core.yuv import synthetic_frame as jframe
from x266_tpu.engine import mode_decision as jmd
from x266_tpu.engine import recon as jrecon
from x266_tpu.kernels import intra as jintra
from x266_tpu.kernels import quant as jquant
from x266_tpu.kernels import transforms as jtx
from x266_tpu_torch import _build, tables
from x266_tpu_torch.api import Decoder, Encoder
from x266_tpu_torch.config import CodecConfig as TCodecConfig
from x266_tpu_torch.config import Profile as TProfile
from x266_tpu_torch.core.hashing import frame_md5
from x266_tpu_torch.core.yuv import synthetic_clip
from x266_tpu_torch.engine import fused, recon, recon_cuda
from x266_tpu_torch.engine import mode_decision as tmd
from x266_tpu_torch.kernels import intra as tintra
from x266_tpu_torch.kernels import quant as tquant
from x266_tpu_torch.kernels import transforms as ttx
from x266_tpu_torch.utils.clips import luma_chroma, smooth_blocks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "x266_tpu_torch", "data")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")


def _cfg(**kw):
    """tests/test_cu64.py's configuration (JAX)."""
    base = dict(width=128, height=64, qp=32, rdoq=True, profile=Profile.VVC,
                max_cu_size=64)
    base.update(kw)
    return CodecConfig(**base)


def _tcfg(cfg):
    """The port's configuration equal to the JAX one."""
    return TCodecConfig(**{k: (TProfile(v.value) if k == "profile" else v)
                           for k, v in vars(cfg).items()})


@pytest.fixture(scope="module")
def tab64():
    return tables.from_reference(_tcfg(_cfg()), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_cu64_tables_only_where_configured(tab64):
    """The 64 size's tables (141 M weights) are built for max_cu_size 64
    only; the kernel's flat tables append it after the others."""
    small = tables.from_reference(_tcfg(_cfg(max_cu_size=32)), "cpu")
    assert 64 not in small.intra_w and not small.cu64
    assert tab64.cu64 and tab64.intra_w[64].dtype == torch.int8
    for name in ("k_taps", "k_smooth", "k_tx", "k_shift"):
        a, b = getattr(small, name), getattr(tab64, name)
        assert torch.equal(b[:a.numel()], a) and b.numel() > a.numel()
    assert tab64.k_tx.numel() - small.k_tx.numel() == 64 * 64


def test_transform64_zero_out_matches_jax(tab64):
    rng = np.random.default_rng(64)
    res = rng.integers(-255, 256, (6, 64, 64)).astype(np.int32)
    res[0] = 255
    res[1] = np.where(rng.random((64, 64)) < 0.5, -255, 255)
    f_j = np.asarray(jtx.forward_transform(jnp.asarray(res), 64))
    f_t = ttx.forward_transform(tab64, _t(res), 64).numpy()
    assert np.array_equal(f_j, f_t)
    assert not f_t[:, 32:].any() and not f_t[:, :, 32:].any()
    assert f_t[:, :32, :32].any()
    # the inverse of coded bands, and of full-scale planes
    coef = rng.integers(-32768, 32768, (6, 64, 64)).astype(np.int32)
    coef[0] = 32767
    coef[1] = -32768
    coef[2:4, 32:] = 0
    coef[2:4, :, 32:] = 0
    i_j = np.asarray(jtx.inverse_transform(jnp.asarray(coef), 64))
    i_t = ttx.inverse_transform(tab64, _t(coef), 64).numpy()
    assert np.array_equal(i_j, i_t)


@pytest.mark.parametrize("qp", [22, 32, 37])
def test_quant64_and_rdoq_match_jax(qp, tab64):
    rng = np.random.default_rng(qp)
    coef = (rng.laplace(0, 200, (4, 64, 64)).clip(-32768, 32767)
            .astype(np.int32))
    coef[:, 32:] = 0
    coef[:, :, 32:] = 0
    coef[0, 0, :4] = [32767, -32768, 0, 1]
    lam = _cfg(qp=qp).lambda_mode
    q_j = np.asarray(jquant.quantize(jnp.asarray(coef), qp, 64))
    assert np.array_equal(q_j, tquant.quantize(tab64, _t(coef), qp,
                                               64).numpy())
    d_j = np.asarray(jquant.dequantize(jnp.asarray(q_j), qp, 64))
    assert np.array_equal(d_j, tquant.dequantize(tab64, _t(q_j), qp,
                                                 64).numpy())
    r_j = np.asarray(jax.jit(lambda c: jquant.rd_quantize(
        c, qp, 64, lam))(jnp.asarray(coef)))
    r_t = tquant.rd_quantize(tab64, _t(coef), qp, 64, lam).numpy()
    assert np.array_equal(r_j, r_t)
    assert r_t.any()


def test_intra64_matches_jax(tab64):
    """All 67 modes at 64 from 257-sample reference vectors (the int8
    weights widened a few modes at a time), and with PDPC under every
    gate pattern."""
    rng = np.random.default_rng(5)
    refs = rng.integers(0, 256, (4, 257)).astype(np.int32)
    refs[0] = 255
    p_j = np.asarray(jintra.predict_all_modes(jnp.asarray(refs), 64, 67))
    p_t = tintra.predict_all_modes(tab64, _t(refs), 64).numpy()
    assert np.array_equal(p_j, p_t)
    lok = np.array([1, 0, 1, 0], bool)
    tok = np.array([1, 1, 0, 0], bool)
    p_j = np.asarray(jintra.predict_all_modes(
        jnp.asarray(refs), 64, 67, pdpc=True, left_ok=jnp.asarray(lok),
        top_ok=jnp.asarray(tok)))
    p_t = tintra.predict_all_modes(tab64, _t(refs), 64, pdpc=True,
                                   left_ok=_t(lok), top_ok=_t(tok)).numpy()
    assert np.array_equal(p_j, p_t)
    for b in range(4):
        for mode in (0, 1, 18, 50, 30):
            one = tintra.predict_mode(tab64, _t(refs[b]), mode, 64, True,
                                      bool(lok[b]), bool(tok[b])).numpy()
            assert np.array_equal(one, p_j[b, mode])


PASS_A = {
    "gradient": (_cfg(), "gradient", 0),
    "mixed-mts-subst": (_cfg(mts=True, ref_substitute=True), "mixed", 5),
}


@pytest.mark.parametrize("name", list(PASS_A))
def test_pass_a_maps_and_costs_match_jax(name):
    """tests/test_cu64.py's two configurations: the maps (size, mode,
    MTS); on 'gradient' also the 64 size's best cost and mode of each
    block, bit for bit (XLA sums the 64x64 rates and squares in 32x32
    windows, F12 at 64), there and on text and noise."""
    cfg, kind, seed = PASS_A[name]
    tcfg = _tcfg(cfg)
    tab = tables.from_reference(tcfg, "cpu")
    y = jframe(cfg.width, cfg.height, kind=kind, seed=seed).y
    plane = jmd.pad_plane(y).astype(np.int32)
    tplane = tmd.pad_plane(torch.from_numpy(y))
    size_j, mode_j = jmd.make_mode_decision(cfg)(plane)
    size_t, mode_t, res_t = tmd.make_mode_decision_raw(tcfg, tab)(tplane)
    assert np.array_equal(np.asarray(size_j), size_t.numpy())
    assert np.array_equal(np.asarray(mode_j), mode_t.numpy())
    if cfg.mts:
        mts_j = jmd.make_mts_select(cfg)(plane, size_j, mode_j)
        mts_t = tmd.make_mts_select_raw(tcfg, tab)(tplane, size_t, mode_t,
                                                   res_t)
        assert np.array_equal(np.asarray(mts_j), mts_t.numpy())
        assert not mts_t[size_t == 64].any()
        return
    assert (size_t == 64).any()
    geom = tmd._Geometry(tcfg, tab.device)
    text = synthetic_clip(128, 64, 1, "text", seed=7)[0].y
    noise = np.random.default_rng(0).integers(0, 256, (64, 128)).astype(
        np.uint8)
    f = jax.jit(lambda p: jmd._eval_size(p, 64, cfg))
    for yy in (y, text, noise):
        p = jmd.pad_plane(np.ascontiguousarray(yy)).astype(np.int32)
        c_j, m_j = (np.asarray(a) for a in f(p))
        c_t, m_t, _ = tmd._eval_size(torch.from_numpy(p), 64, tcfg, tab,
                                     geom)
        assert np.array_equal(c_j, c_t.numpy())
        assert np.array_equal(m_j, m_t.numpy())


# the mode of the forced 64 CUs, in turn: DC, planar, the pure vertical
# and horizontal, the diagonals, fractional angles; then seeded ones
MODES64 = [1, 0, 50, 18, 2, 66, 34, 10, 58, 3, 45]


def force64(size, mode, mts, seed):
    """Maps (numpy, (F, H/8, W/8)) with a 64 CU in every other full CTU
    (a checkerboard over the frames), each of the next mode of MODES64
    (then seeded ones) and mts 0; the other CUs Pass A's."""
    rng = np.random.default_rng(seed)
    size, mode, mts = (np.array(m, dtype=np.int32) for m in (size, mode,
                                                              mts))
    n = 0
    for f in range(size.shape[0]):
        for cy in range(size.shape[1] // 8):
            for cx in range(size.shape[2] // 8):
                if (cx + cy + f) % 2:
                    continue
                sl = (f, slice(8 * cy, 8 * cy + 8), slice(8 * cx, 8 * cx + 8))
                size[sl] = 64
                mode[sl] = (MODES64[n] if n < len(MODES64)
                            else int(rng.integers(0, 67)))
                mts[sl] = 0
                n += 1
    return size, mode, mts


# the plain scan against the JAX scan on forced maps at 128x128 (the
# second CTU row reads the first's top-right references)
SCAN = {
    "tools": (_cfg(width=128, height=128, mts=True, ref_substitute=True,
                   pdpc=True, transform_skip=True), "text"),
    "cclm-lfnst": (_cfg(width=128, height=128, cclm=True, lfnst=True,
                        mts=True, ref_substitute=True), "mixed"),
}


@pytest.mark.parametrize("name", list(SCAN))
def test_plain_scan_matches_jax(name):
    cfg, kind = SCAN[name]
    tcfg = _tcfg(cfg)
    tab = tables.from_reference(tcfg, "cpu")
    f = luma_chroma(jclip(cfg.width, cfg.height, 1, kind, seed=3))[0]
    planes = [jmd.pad_plane(p).astype(np.int32) for p in (f.y, f.cb, f.cr)]
    src = [torch.from_numpy(p.astype(np.uint8)[None]) for p in planes]
    maps = [m[0] for m in force64(*(m.numpy() for m in fused.make_pass_a(
        tcfg, tab)(src[0])), seed=3)]
    assert (maps[0] == 64).sum() >= 2 * 64 and (maps[0] < 64).any()
    want = jrecon.make_recon_pass(cfg, encode=True)(*planes, *maps)
    tm = [torch.from_numpy(m[None]) for m in maps]
    got = recon.make_recon_pass_raw(tcfg, tab, True)(*src, *tm)
    assert len(want) == len(got) == (7 if cfg.cclm else 6)
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(w), g[0].numpy()), i
    # the 64 CUs' levels lie in their low 32x32 band, and some are set
    lev = got[3][0].numpy()
    for cy, cx in zip(*np.nonzero(maps[0][::8, ::8] == 64)):
        blk = lev[64 * cy:64 * cy + 64, 64 * cx:64 * cx + 64]
        assert not blk[32:].any() and not blk[:, 32:].any()
    assert any(lev[64 * cy:64 * cy + 32, 64 * cx:64 * cx + 32].any()
               for cy, cx in zip(*np.nonzero(maps[0][::8, ::8] == 64)))
    m_in = np.asarray(want[6]) if cfg.cclm else maps[2]
    dwant = jrecon.make_recon_pass(cfg, encode=False)(
        *(np.asarray(c).astype(np.int32) for c in want[3:6]), maps[0],
        maps[1], m_in)
    dgot = recon.make_recon_pass_raw(tcfg, tab, False)(
        *got[3:6], tm[0], tm[1], torch.from_numpy(np.array(m_in)[None]))
    for i, (w, g) in enumerate(zip(dwant[:3], dgot[:3])):
        assert np.array_equal(np.asarray(w), g[0].numpy()), i


def _ref():
    with open(os.path.join(DATA, "cu64_128x64_ref.json")) as f:
        return json.load(f)["variants"]


def _config(text):
    return eval(text, {"CodecConfig": TCodecConfig, "Profile": TProfile})


def _clip(text, mod=None):
    return eval(text, {"luma_chroma": luma_chroma,
                       "smooth_blocks": smooth_blocks,
                       "synthetic_clip": mod or synthetic_clip})


@pytest.mark.parametrize("name", ["gradient", "blocks", "mts_subst",
                                  "pdpc_ts", "lfnst", "cclm"])
def test_stream_matches_reference(name):
    """The Encoder's stream, recon, SSE and PSNR-Y equal the JAX
    encoder's (data/cu64_128x64_ref.json), with 64 CUs coded; the
    Decoder on the stream gives the JAX decoder's pictures."""
    v = _ref()[name]
    cfg = _config(v["config"])
    frames = _clip(v["clip"])
    enc = Encoder(cfg, device="cpu")
    res = enc.encode(frames)
    stream = base64.b64decode(v["stream_b64"])
    assert res.bitstream == stream
    for i, r in enumerate(v["frames"]):
        assert frame_md5(res.recon[i]) == r["recon_md5"], i
        assert [float(x) for x in res.sse[i]] == r["sse"], i
        assert res.psnr_y(cfg.width, cfg.height)[i] == r["psnr_y"], i
    _, dec = Decoder(device="cpu").decode(stream)
    assert [frame_md5(d) for d in dec] == [r["decode_md5"]
                                           for r in v["frames"]]
    # the clip codes 64 CUs (Pass A on the port's first frame)
    tab = tables.from_reference(cfg, "cpu")
    src = fused._unpack_padded(cfg, *(torch.from_numpy(getattr(
        frames[0], p)[None].copy()) for p in ("y", "cb", "cr")))
    assert (fused.make_pass_a(cfg, tab)(src[0])[0] == 64).any()


def test_stream_matches_live_jax():
    """One recorded variant (PDPC, transform skip, MTS, substitution)
    against the JAX encoder run here."""
    v = _ref()["pdpc_ts"]
    cfg = _config(v["config"])
    want = JaxEncoder(CodecConfig(**{
        k: (Profile(x.value) if k == "profile" else x)
        for k, x in vars(cfg).items()})).encode(_clip(v["clip"], jclip))
    got = Encoder(cfg, device="cpu").encode(_clip(v["clip"]))
    assert got.bitstream == want.bitstream
    assert got.frame_bits == list(want.frame_bits)


def test_ai_vvc_cu64_fixture_both_ways():
    """The golden fixture (CU 64 with MTS on 'gradient'): decodes to its
    manifest MD5, and its source and config (tools/make_fixtures.py)
    re-encode to its bytes."""
    with open(os.path.join(FIXTURES, "ai_vvc_cu64.266t"), "rb") as f:
        stream = f.read()
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        md5 = json.load(f)["ai_vvc_cu64"]["md5"]
    cfg_dec, dec = Decoder(device="cpu").decode(stream)
    assert cfg_dec.max_cu_size == 64
    assert [frame_md5(d) for d in dec] == md5
    cfg = TCodecConfig(width=96, height=64, qp=32, rdoq=True,
                       profile=TProfile.VVC, max_cu_size=64, mts=True)
    res = Encoder(cfg, device="cpu").encode(synthetic_clip(
        96, 64, 1, kind="gradient", seed=77))
    assert res.bitstream == stream


# K1 / K2's CU-64 instances under the host stand-in, on forced maps at
# 192x160 (3x3 CTUs, the last row partial): alone on texture, with the
# intra tools and substitution on smooth blocks, with LFNST, with CCLM
KERNEL = {
    "alone": (dict(), "mixed"),
    "tools": (dict(mts=True, ref_substitute=True, pdpc=True,
                   transform_skip=True), "blocks"),
    "lfnst": (dict(mts=True, lfnst=True), "mixed"),
    "cclm": (dict(cclm=True, ref_substitute=True), "blocks"),
    "cclm-lfnst": (dict(cclm=True, lfnst=True, mts=True, pdpc=True),
                   "mixed"),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build.declare(ctypes.CDLL(_host_build(tmp_path_factory,
                                                  _build.SOURCES)))


def _kernel_case(name, seed=9):
    kw, kind = KERNEL[name]
    cfg = TCodecConfig(width=192, height=160, qp=32, rdoq=True,
                       profile=TProfile.VVC, max_cu_size=64, **kw)
    tab = tables.from_reference(cfg, "cpu")
    frames = synthetic_clip(192, 160, 2, "mixed", seed=seed)
    if kind == "blocks":
        frames = smooth_blocks(frames, seed)
    frames = luma_chroma(frames)
    planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
              for p in ("y", "cb", "cr")]
    src = fused._unpack_padded(cfg, *planes)
    maps = [torch.from_numpy(m) for m in force64(
        *(m.numpy() for m in fused.make_pass_a(cfg, tab)(src[0])), seed)]
    assert (maps[0] == 64).sum() >= 6 * 64 and (maps[0] < 64).any()
    return cfg, tab, src, maps


def _check_kernel(lib, cfg, tab, src, maps):
    err, got = recon_cuda._launch(lib, 0, cfg, tab, True, *src, *maps)
    assert err == 0
    want = recon.make_recon_pass_raw(cfg, tab, True)(*src, *maps)
    assert len(got) == len(want)
    for n, w, g in zip(INAMES, want, got):
        assert torch.equal(w, g), n
    dargs = _dec_args(cfg, got, maps)
    err, dec = recon_cuda._launch(lib, 0, cfg, tab, False, *dargs)
    assert err == 0
    dwant = recon.make_recon_pass_raw(cfg, tab, False)(*dargs)
    for n, w, g in zip(INAMES, dwant, dec):
        assert torch.equal(w, g), n


@pytest.mark.parametrize("name", list(KERNEL))
def test_cu64_kernel_source_matches_plain_scan(name, host_lib):
    _check_kernel(host_lib, *_kernel_case(name))


@pytest.mark.parametrize("name", ["alone", "cclm-lfnst"])
def test_cu64_kernel_rows_run_concurrently(name, host_lib, monkeypatch):
    """Every CTU row's block at once (the wavefront's tickets, waits and
    the CCLM groups' waits on the luma group, with the larger windows)."""
    monkeypatch.setenv("X266_HOST_BLOCKS", "8")
    _check_kernel(host_lib, *_kernel_case(name, seed=4))
