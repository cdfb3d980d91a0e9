"""Weighted prediction and GPB in the port, on the CPU, against the JAX
package.  Equality throughout:

- the pyramid reweight (fused.reweight_pyr / apply_wp) equals
  x266_tpu.engine.fused._apply_wp on seeded random (16, h, w) uint8
  pyramids, at the weights' limits and at identity, and leaves the DPB's
  pyramid as it was;
- fit_weight equals the JAX encoder's on faded and unfaded frames, a
  flat reference and a chroma shift;
- four 6-frame 128x64 clips under a luma fade -- GPB without reference
  lists, GPB with lists and weighted prediction, low-delay P with
  weighted prediction, random access (GOP 4, config 4) with weighted
  prediction -- give the JAX encoder's stream, slice NALs, bits, SSE,
  PSNR-Y, weights and recon (data/wp128x64_ref.json, recorded by
  tools/make_torch_refs.py wp128x64), and the port decodes each JAX
  stream to the JAX decoder's MD5s;
- the live JAX decoder decodes the port's GPB + lists + weighted
  prediction stream to the port's recon.
"""

import base64
import hashlib
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu.api import Decoder as JaxDecoder
from x266_tpu.api.encoder import fit_weight as jfit_weight
from x266_tpu.engine import fused as jfused
from x266_tpu.config import CodecConfig as JCodecConfig
from x266_tpu_torch import config as tconfig
from x266_tpu_torch.api import Decoder, Encoder
from x266_tpu_torch.api.encoder import fit_weight
from x266_tpu_torch.core.hashing import frame_md5
from x266_tpu_torch.core.headers import parse_slice_header
from x266_tpu_torch.core.nal import NalType, split_nals, write_nal
from x266_tpu_torch.core.yuv import Frame, synthetic_clip
from x266_tpu_torch.engine import fused

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _refs_tool():
    """tools/make_torch_refs.py, which records the JAX references."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_refs", os.path.join(ROOT, "tools", "make_torch_refs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("wp4", [
    (16, -128, 192, 127), (192, 127, 16, -128), (16, 127, 192, -128),
    (192, -128, 64, 0), (64, 0, 64, 0), (64, 5, 64, -3)])
def test_reweight_matches_jax(wp4):
    """Every sample of three random pyramids, pad included: the port's
    reweight equals the reference's, in a new contiguous uint8 tensor,
    and the DPB's pyramids keep their samples."""
    rng = np.random.default_rng(sum(wp4) + 1000)
    shapes = [(16, 40, 72), (16, 24, 40), (16, 24, 40)]
    pyrs = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    cfg = tconfig.CodecConfig(width=64, height=32)
    want = jfused._apply_wp(JCodecConfig(width=64, height=32),
                            tuple(jnp.asarray(p) for p in pyrs),
                            jnp.asarray(wp4, jnp.int32))
    before = [torch.from_numpy(p.copy()) for p in pyrs]
    tens = [torch.from_numpy(p) for p in pyrs]
    got = fused.apply_wp(cfg, tens, list(wp4))
    for g, w, t, b in zip(got, want, tens, before):
        assert g.dtype == torch.uint8 and g.is_contiguous()
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(t, b)
        if tuple(wp4) != fused.IDENTITY_WP:
            assert g.data_ptr() != t.data_ptr()


def test_reweight_one_plane_matches_jax():
    """reweight_pyr alone, on every uint8 sample value and weights from
    16 to 192 with offsets from -128 to 127."""
    p = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    for w in (16, 17, 63, 64, 65, 128, 191, 192):
        for o in (-128, -1, 0, 1, 127):
            want = np.asarray(jfused._reweight_pyr(jnp.asarray(p), w, o, 255))
            got = fused.reweight_pyr(torch.from_numpy(p), w, o, 255)
            assert np.array_equal(got.numpy(), want), (w, o)


def _fit_case(case):
    """(cur, ref) of one fit_weight case."""
    fade = _refs_tool().fade
    mixed = synthetic_clip(96, 64, 1, kind="mixed", seed=3)[0]
    if case == "fade":                    # a still frame faded to 0.5
        return fade([mixed, mixed], g0=1.0, g1=0.5)[::-1]
    if case == "fade_motion":             # motion under a 0.8 fade
        return fade(synthetic_clip(96, 64, 2, kind="motion", seed=3),
                    g0=1.0, g1=0.8)[::-1]
    if case == "unfaded":
        return mixed, mixed
    if case == "flat":                    # var < 1: the offset alone
        return mixed, Frame(np.full_like(mixed.y, 90), mixed.cb, mixed.cr)
    if case == "chroma_shift":
        grad = synthetic_clip(96, 64, 1, kind="gradient", seed=3)[0]
        return Frame(grad.y, np.clip(grad.cb.astype(np.int32) + 9, 0,
                                     255).astype(np.uint8),
                     np.clip(grad.cr.astype(np.int32) - 2, 0,
                             255).astype(np.uint8)), grad
    # brighten: a reference at a quarter of the level clamps w at 192
    return mixed, Frame((mixed.y // 4).astype(np.uint8), mixed.cb,
                        mixed.cr)


@pytest.mark.parametrize("case", ["fade", "fade_motion", "unfaded", "flat",
                                  "chroma_shift", "brighten"])
def test_fit_weight_matches_jax(case):
    """fit_weight, float64 on the host, equals the JAX encoder's: its
    clamps and identity fallbacks included."""
    cur, ref = _fit_case(case)
    got = fit_weight(cur, ref)
    assert got == jfit_weight(cur, ref)
    assert all(isinstance(v, int) for v in got)
    if case == "unfaded":
        assert got == [64, 0, 64, 0]
    if case == "fade":
        assert 28 <= got[0] <= 36
    if case == "brighten":
        assert got[0] == 192
    if case == "chroma_shift":
        assert got[3] != 0


def _wp128():
    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "wp128x64_ref.json")) as f:
        return json.load(f)


def _wp128_config(ref):
    preset = {"preset_cfg3": tconfig.preset_cfg3,
              "preset_cfg4": tconfig.preset_cfg4}[ref["preset"]]
    return preset(128, 64).replace(**ref["tools"])


@pytest.fixture(scope="module")
def port_wp():
    """variant -> (the recorded variant, the port's CPU encode), made once
    per variant for this module's tests."""
    data = _wp128()
    tool = _refs_tool()
    assert data["clip"] == tool.WP128_CLIP
    assert {v: [r["preset"], r["tools"]] for v, r in
            data["variants"].items()} == {
        v: [p, t] for v, (p, t) in tool.WP128_VARIANTS.items()}
    frames = tool.fade(synthetic_clip(128, 64, 6, "motion", seed=3))
    done = {}

    def get(name):
        if name not in done:
            ref = data["variants"][name]
            done[name] = (ref, Encoder(_wp128_config(ref),
                                       device="cpu").encode(frames))
        return done[name]

    return get


def _slice_headers(cfg, stream):
    return [parse_slice_header(rbsp, cfg.alf, cfg.ctus_y * cfg.ctus_x,
                               cfg.alf_chroma, cfg.alf_nonlinear, cfg.ccalf,
                               has_wp=cfg.weighted_pred, has_rpl=cfg.rpl)[0]
            for t, rbsp in split_nals(stream)
            if t in (NalType.IDR, NalType.TRAIL)]


KINDS = {"gpb": "IPBBBB", "gpb_rpl_wp": "IPBBBB", "p_wp": "IPPPIP",
         "ra_wp": "IBBBPP"}


@pytest.mark.parametrize("variant", list(KINDS))
def test_wp_clip_matches_recorded_jax(variant, port_wp):
    """The port's stream, slice NALs, bits, SSE, PSNR-Y, slice weights
    and recon equal the JAX encoder's; the port decodes the JAX stream
    to the JAX decoder's MD5s, which equal the recon."""
    ref, port = port_wp(variant)
    cfg = _wp128_config(ref)
    stream = base64.b64decode(ref["stream_b64"])
    assert port.bitstream == stream
    assert [hashlib.md5(write_nal(t, rbsp)).hexdigest()
            for t, rbsp in split_nals(port.bitstream)
            if t in (NalType.IDR, NalType.TRAIL)] == \
        ref["nal_md5_coding_order"]
    fr = ref["frames"]
    assert port.frame_bits == [f["bits"] for f in fr]
    assert [[float(v) for v in s] for s in port.sse] == [f["sse"] for f in fr]
    assert port.psnr_y(128, 64) == [f["psnr_y"] for f in fr]
    port_md5 = [frame_md5(r) for r in port.recon]
    assert port_md5 == [f["recon_md5"] for f in fr] == [
        f["decode_md5"] for f in fr]
    hdrs = _slice_headers(cfg, port.bitstream)
    assert [[h.poc, h.slice_type.name, h.wp] for h in hdrs] == \
        ref["slice_wp"]
    assert "".join(h.slice_type.name for h in
                   sorted(hdrs, key=lambda h: h.poc)) == KINDS[variant]
    if cfg.weighted_pred:
        # the fade fits weights other than identity on inter slices
        assert any(h.wp is not None and h.wp[:4] != [64, 0, 64, 0]
                   for h in hdrs if h.slice_type.name != "I")
    _, dec = Decoder(device="cpu").decode(stream)
    assert [frame_md5(d) for d in dec] == port_md5


def test_gpb_rpl_signals_picked_references(port_wp):
    """With lists, the B pictures name two past references picked from a
    DPB of up to four; the last B picture picks after the first
    eviction (its DPB no longer holds the IDR)."""
    ref, port = port_wp("gpb_rpl_wp")
    hdrs = _slice_headers(_wp128_config(ref), port.bitstream)
    for h in hdrs:
        if h.slice_type.name == "B":
            l0, l1 = h.poc - h.rpl[0][0], h.poc - h.rpl[1][0]
            assert l0 < h.poc and l1 < h.poc and l0 != l1
            assert h.poc - 4 <= min(l0, l1)
    assert hdrs[-1].poc == 5
    assert min(hdrs[-1].poc - d[0] for d in hdrs[-1].rpl) >= 1


def test_jax_decodes_port_gpb_rpl_wp_stream(port_wp):
    """The live anchor: the JAX decoder decodes the port's GPB stream
    with signalled lists and weighted prediction to the port's recon."""
    _, port = port_wp("gpb_rpl_wp")
    _, jdec = JaxDecoder().decode(port.bitstream)
    assert [frame_md5(d) for d in jdec] == [frame_md5(r)
                                            for r in port.recon]
