"""Sign-data hiding and dependent quantization in the port against the JAX
package (x266_tpu/kernels/quant.py sdh_adjust, dq_quantize_trellis,
dq_dequantize; the encoder and decoder on the CPU), all bit-equal.

- sdh_adjust with and without the coefficients, with and without a
  lambda, at every TU size and QPs 22/27/32/37, against the jitted
  reference (the encoder runs it jitted);
- dq_quantize_trellis and dq_dequantize at the same sizes and QPs, on
  random coefficients and on a batch of near-ties (coefficients on the
  quantizers' half-steps), against the jitted reference;
- the rate as the quantizers' cost fusions form it against Tables.rate;
- the trellis's (min,+) scan (quant.assoc_scan) against
  jax.lax.associative_scan on random float32 matrices whose sums round,
  with BIG entries (BIG + BIG overflows to inf), prefix and reverse;
- the port's CPU encoder with each flag at 128x64 on I, P and B pictures
  against the JAX encoder's bytes, bits, SSE, PSNR and recon and the JAX
  decoder's MD5s (recorded in x266_tpu_torch/data/sdhdq128x64_ref.json
  by tools/make_torch_refs.py), the port decoding the JAX streams, and
  the live JAX encoder and decoder on a low-delay DQ clip.
"""

import base64
import dataclasses
import enum
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu.api import Decoder as JaxDecoder
from x266_tpu.api import Encoder as JaxEncoder
from x266_tpu.config import Profile as JProfile
from x266_tpu.config import preset_cfg3 as jpreset_cfg3
from x266_tpu.core.hashing import frame_md5
from x266_tpu.core.yuv import synthetic_clip
from x266_tpu.kernels import quant as jq
from x266_tpu_torch import config as tconfig
from x266_tpu_torch import tables
from x266_tpu_torch.api import Decoder, Encoder
from x266_tpu_torch.kernels import quant as tq

torch.set_num_threads(1)

SIZES = (4, 8, 16, 32)
QPS = (22, 27, 32, 37)
HERE = os.path.dirname(os.path.abspath(__file__))


@functools.cache
def _tab():
    return tables.from_reference(tconfig.CodecConfig(width=64, height=64),
                                 "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _coefs(rng, n, size):
    """(n, size, size) int32 coefficients: a spread of amplitudes, falling
    with frequency, a few at the int16 limits."""
    amp = rng.choice([8, 60, 400, 3000], size=(n, 1, 1))
    c = rng.integers(-1, 2, (n, size, size)) * rng.integers(
        0, 1 << 15, (n, size, size)) % (amp + 1)
    fall = 1 + np.add.outer(np.arange(size), np.arange(size))[None]
    c = (c // fall).astype(np.int32)
    c[0, 0, :2] = (-32768, 32767)
    return c


def _half_steps(rng, n, size, qp):
    """(n, size, size) coefficients on or next to the dependent
    quantizers' half-steps (where two levels' costs nearly tie)."""
    tsh = 15 - 8 - int(np.log2(size))
    qbits = 14 + qp // 6 + tsh
    scale = int(jq.QUANT_SCALES[qp % 6])
    m = rng.integers(0, 40, (n, size, size))
    a = np.rint((m + 0.5) * (1 << (qbits - 1)) / scale).astype(np.int64)
    a += rng.integers(-1, 2, a.shape)
    sgn = rng.choice([-1, 1], a.shape)
    return np.clip(sgn * a, -32768, 32767).astype(np.int32)


@functools.cache
def _jax_trellis(size, qp, lam):
    return jax.jit(lambda c: jq.dq_quantize_trellis(c, qp, size, lam))


@functools.cache
def _jax_dequant(size, qp):
    return jax.jit(lambda lv: jq.dq_dequantize(lv, qp, size))


@functools.cache
def _jax_sdh(size, qp, mode):
    if mode == "plain":
        return jax.jit(lambda lv: jq.sdh_adjust(lv, size))
    lam = 9.75 if mode == "coef-lam" else None
    return jax.jit(lambda lv, c: jq.sdh_adjust(lv, size, coef=c, qp=qp,
                                               lam=lam))


@pytest.mark.parametrize("mode", ["plain", "coef", "coef-lam"])
@pytest.mark.parametrize("size", SIZES)
def test_sdh_adjust_matches_jax(size, mode):
    """sdh_adjust on RDOQ levels of random coefficients (most groups
    span >= 4 and half mismatch): the port's levels are the jitted
    reference's, and the adjustment moved levels."""
    rng = np.random.default_rng(size)
    moved = 0
    for qp in QPS:
        for c in _coefs(rng, 6, size):
            lev = np.asarray(jq.rd_quantize(jnp.asarray(c), qp, size, 9.75))
            f = _jax_sdh(size, qp, mode)
            if mode == "plain":
                want = np.asarray(f(lev))
                got = tq.sdh_adjust(_tab(), _t(lev), size)
            else:
                want = np.asarray(f(lev, c))
                got = tq.sdh_adjust(_tab(), _t(lev), size, coef=_t(c),
                                    qp=qp, lam=9.75 if mode == "coef-lam"
                                    else None)
            np.testing.assert_array_equal(got.numpy(), want)
            moved += int((want != lev).any())
    assert moved > 0


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("size", SIZES)
def test_dq_trellis_and_dequantize_match_jax(size, qp):
    """dq_quantize_trellis at the RDOQ lambda and at _dq_lam's, on random
    coefficients and on near-ties at the half-steps; dq_dequantize of its
    levels and of random levels: the jitted reference's integers."""
    rng = np.random.default_rng(100 * size + qp)
    lam_rdoq = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    for lam in (lam_rdoq, 3.0 * lam_rdoq):
        for c in (_coefs(rng, 4, size), _half_steps(rng, 4, size, qp)):
            want = np.asarray(_jax_trellis(size, qp, lam)(c))
            got = tq.dq_quantize_trellis(_tab(), _t(c), qp, size, lam)
            np.testing.assert_array_equal(got.numpy(), want)
            wd = np.asarray(_jax_dequant(size, qp)(want))
            gd = tq.dq_dequantize(_tab(), _t(want), qp, size)
            np.testing.assert_array_equal(gd.numpy(), wd)
    lev = rng.integers(-40, 41, (3, size, size)).astype(np.int32)
    lev[0, 0, :2] = (-32768, 32767)
    np.testing.assert_array_equal(
        tq.dq_dequantize(_tab(), _t(lev), qp, size).numpy(),
        np.asarray(_jax_dequant(size, qp)(lev)))


def test_quantizer_rate_equals_rate_table():
    """The rate 3 + 2*log2(k + 1) (0.0625 at 0) as the trellis's and
    SDH's cost fusions form it -- k an int32 level from integer ops,
    log(k + 1) times 2/ln 2 in XLA's optimized HLO -- equals
    Tables.rate for every level 0..32767."""
    def rate(u):
        k = jnp.clip((u + 1) >> 1, 0, 32767)
        kf = k.astype(jnp.float32)
        trellis = jnp.where(k > 0, 3.0 + 2.0 * jnp.log2(kf + 1.0), 0.0625)
        af = jnp.abs(k).astype(jnp.float32)
        sdh = jnp.where(af > 0, 3.0 + 2.0 * jnp.log2(af + 1.0), 0.0625)
        return k, trellis, sdh

    u = 2 * np.arange(32768, dtype=np.int32)
    k, trellis, sdh = (np.asarray(x) for x in jax.jit(rate)(jnp.asarray(u)))
    assert np.array_equal(k, np.arange(32768))
    table = _tab().rate.numpy()
    assert np.array_equal(trellis.view(np.int32), table.view(np.int32))
    assert np.array_equal(sdh.view(np.int32), table.view(np.int32))


def _matrices(rng, shape):
    """float32 (min,+) matrices along axis 1: costs of spread magnitudes
    (sums round) with about a third BIG, and from n = 16 the 5th and 6th
    all BIG (their products pass BIG + BIG = inf)."""
    m = (rng.random(shape) * 10.0 ** rng.integers(-2, 7, shape)).astype(
        np.float32)
    m = np.where(rng.random(shape) < 0.35, tq.BIG, m).astype(np.float32)
    if shape[1] >= 16:
        m[:, 4:6] = tq.BIG
    return m


@pytest.mark.parametrize("reverse", [False, True], ids=["prefix", "reverse"])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 100, 1024])
def test_minplus_scan_matches_associative_scan(n, reverse):
    """assoc_scan(minplus) on (2, n, 4, 4) float32 matrices along n: the
    bits of jax.lax.associative_scan(_minplus), infinities included."""
    rng = np.random.default_rng(n)
    m = _matrices(rng, (2, n, 4, 4))
    want = np.asarray(jax.jit(lambda x: jax.lax.associative_scan(
        jq._minplus, x, axis=1, reverse=reverse))(m))
    got = tq.assoc_scan(tq.minplus, _t(m), 1, reverse=reverse).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if n >= 16:
        assert np.isinf(want).any() and (want < tq.BIG).any()


# ---- the encoder and decoder at 128x64 --------------------------------------

def _refs_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_refs", os.path.join(HERE, "..", "tools",
                                        "make_torch_refs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _port_config(name):
    """The port's copy of tools/make_torch_refs.py's sdhdq128_config."""
    c = tconfig
    if name == "ai_sdh":
        return c.preset_cfg2s(128, 64)
    if name == "ai_dq_ts":
        return c.preset_cfg2(128, 64).replace(dep_quant=True,
                                              transform_skip=True,
                                              rdoq=False)
    if name == "p_sdh":
        return c.preset_cfg3(128, 64).replace(intra_period=4,
                                              sign_data_hiding=True,
                                              rdoq=False)
    gop = dict(gop_size=4, intra_period=8)
    if name == "ra_sdh":
        return c.preset_cfg4(128, 64).replace(**gop, sign_data_hiding=True)
    return c.preset_cfg4(128, 64).replace(**gop, profile=c.Profile.VVC,
                                          dep_quant=True)


NAMES = ["ai_sdh", "ai_dq_ts", "p_sdh", "ra_sdh", "ra_dq"]


def _fields(cfg):
    """A config's fields, enums as their values (the two packages' enums
    are distinct classes)."""
    return {k: int(v) if isinstance(v, enum.Enum) else v
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.fixture(scope="module")
def port_sdhdq():
    """name -> (the recorded variant, the port's CPU encode), made once
    for this module's tests."""
    tool = _refs_tool()
    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "sdhdq128x64_ref.json")) as f:
        data = json.load(f)
    assert list(data["variants"]) == list(tool.SDHDQ128) == NAMES
    done = {}

    def get(name):
        if name not in done:
            ref = data["variants"][name]
            text, kind, n = tool.SDHDQ128[name]
            assert ref["config"] == text
            assert ref["clip"] == (f"synthetic_clip(128, 64, {n}, '{kind}', "
                                   "seed=3)")
            cfg = _port_config(name)
            assert _fields(tool.sdhdq128_config(name)) == _fields(cfg)
            frames = synthetic_clip(128, 64, n, kind, seed=3)
            done[name] = (ref, Encoder(cfg, device="cpu").encode(frames))
        return done[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_sdhdq_clip_matches_recorded_jax(name, port_sdhdq):
    """Each flag at 128x64 -- all-intra (SDH beside transform skip and
    MTS; DQ beside transform skip without RDOQ), low-delay P (SDH without
    RDOQ) and random access (I, P and B pictures) with each: the JAX
    encoder's bytes, bits, SSE, PSNR and recon, which the JAX decoder's
    MD5s equal; the port decodes the JAX stream to the JAX recon."""
    ref, port = port_sdhdq(name)
    stream = base64.b64decode(ref["stream_b64"])
    assert port.bitstream == stream
    fr = ref["frames"]
    assert port.frame_bits == [f["bits"] for f in fr]
    assert [[float(v) for v in s] for s in port.sse] == [f["sse"] for f in fr]
    assert port.psnr_y(128, 64) == [f["psnr_y"] for f in fr]
    port_md5 = [frame_md5(r) for r in port.recon]
    assert port_md5 == [f["recon_md5"] for f in fr] == [
        f["decode_md5"] for f in fr]
    _, dec = Decoder(device="cpu").decode(stream)
    assert [frame_md5(d) for d in dec] == port_md5


@pytest.mark.parametrize("name", ["ra_sdh", "ra_dq"])
def test_jax_decodes_port_sdhdq_stream(name, port_sdhdq):
    """The live anchor: the JAX decoder decodes the port's random-access
    streams under each flag (deblock, SAO and ALF too) to the port's
    recon."""
    _, port = port_sdhdq(name)
    _, jdec = JaxDecoder().decode(port.bitstream)
    assert [frame_md5(d) for d in jdec] == [frame_md5(r)
                                            for r in port.recon]


def test_live_jax_encoder_dq_low_delay():
    """The live JAX encoder: config 3 with DQ (VVC profile) on 2 frames of
    'motion' at 64x64 (an I and a P picture) gives the port's bytes and
    recon, and each decoder decodes them to that recon."""
    frames = synthetic_clip(64, 64, 2, "motion", seed=11)
    jcfg = jpreset_cfg3(64, 64).replace(profile=JProfile.VVC,
                                        dep_quant=True)
    tcfg = tconfig.preset_cfg3(64, 64).replace(profile=tconfig.Profile.VVC,
                                               dep_quant=True)
    want = JaxEncoder(jcfg, with_recon=True).encode(frames)
    got = Encoder(tcfg, device="cpu").encode(frames)
    assert got.bitstream == want.bitstream
    md5 = [frame_md5(r) for r in want.recon]
    assert [frame_md5(r) for r in got.recon] == md5
    _, dec = Decoder(device="cpu").decode(want.bitstream)
    assert [frame_md5(d) for d in dec] == md5
