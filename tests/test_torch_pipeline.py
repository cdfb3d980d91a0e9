"""The port's Encoder/Decoder on the CPU against the JAX package.

Exact equality throughout: bytes, MD5s, and the device-computed SSE and
PSNR, which the port sums in float32 in the reference's order (F4).
- the port re-encodes the ai_hevc, ai_hevc_lossless and
  lowdelay_p_filters golden fixtures' sources to their bytes and decodes
  ai_hevc and ai_hevc_lossless to their manifest MD5s (lossless: the
  source itself);
- a 2-frame 128x64 clip with VVC's intra tools (cfg2t: PDPC, MIP,
  transform skip) gives the JAX encoder's bytes, SSE and recon (recorded
  in data/t128x64_ref.json by tools/make_torch_refs.py), the port
  decodes that stream to that recon, and the JAX decoder decodes the
  port's stream to the port's recon (live);
- a 3-frame 128x64 config-2 shaped clip gives the JAX encoder's bytes,
  SSE and recon (recorded in data/c128x64_ref.json), the port decodes
  the JAX stream to JAX's recon, and the JAX decoder decodes the port's
  stream to the port's recon (live);
- a 5-frame 128x64 low-delay clip (config-3 shaped, IDR every 4 frames:
  I P P P I), plain and with merge candidates, AMVP and signalled
  reference lists, gives the JAX encoder's bytes and recon, and the
  streams cross-decode: the port decodes the JAX stream, and the JAX
  decoder's MD5s of that same stream equal the port's recon.  The JAX
  side is recorded in x266_tpu_torch/data/p128x64_ref.json by
  tools/make_torch_refs.py (compiling the JAX GOP encode here would add
  over a minute to the suite); one live anchor ties that file to JAX:
  its configs are the tool's, and the JAX decoder decodes its plain
  stream to its recorded recon;
- P slices whose reference is missing, or whose MVs read past the pad,
  are refused;
- a 5-frame 128x64 random-access clip with deblock, SAO and ALF (GOP 4:
  I, P, then B pictures at POC 2, 1, 3; recorded by the same tool in
  data/ra128x64_ref.json): with luma and chroma ALF, with luma ALF only
  and without ALF, the JAX encoder's bytes and recon (the ALF
  estimators in the reference's float32 order, ROADMAP queue 3, F9);
  the port decodes the JAX streams to JAX's recon, which the JAX
  decoder's recorded MD5s equal;
- the intra tools on P and B pictures: 5-frame 128x64 lossless
  low-delay P, lossless random-access and VVC-tools random-access clips
  give the JAX encoder's bytes, SSE and recon (data/tools128x64_ref.json;
  lossless decodes to its input), the JAX decoder decodes the port's
  tools stream, loop filters included (live), and a P slice under each
  tool decodes in both decoders to the same pictures;
- config 5's single-device form (low-delay P, intra period 16, deblock
  and SAO, one entropy segment per CTU row with WPP context
  inheritance) on 17 frames at 112x80 (I, 15 P, I; two CTU rows, so
  the second segment inherits and the filters cross a CTU-row edge)
  gives the JAX encoder's bytes, slice NALs, bits, SSE, PSNR and recon
  (data/cfg5_112x80_ref.json), the port decodes the JAX stream to the
  JAX recon, and the JAX decoder decodes the port's stream (live);
- the ai_vvc_tools golden fixture (sign-data hiding beside transform
  skip and MTS) re-encodes to its bytes and decodes to its manifest MD5s;
  so does ai_vvc_mtt_lfnst (MTT binary splits and LFNST beside MTS);
- the golden fixtures lowdelay_p_filters and ra_alf decode to their
  manifest MD5s, ra_alf (random access with nonlinear ALF and CC-ALF)
  and gpb_rpl_wp (GPB with signalled reference lists and weighted
  prediction) re-encode to their bytes;
- a 5-frame 128x64 random-access clip with nonlinear luma and chroma ALF
  and CC-ALF gives the JAX encoder's bytes, bits, SSE and recon
  (data/ra_nl128x64_ref.json), and the live JAX decoder decodes the
  port's stream to the port's recon;
- the one-frame device step gives what the batched step gives per frame;
- configurations and streams outside the slices raise
  NotImplementedError.
"""

import base64
import importlib.util
import json
import os

import numpy as np
import pytest

from x266_tpu.api import Decoder as JaxDecoder
from x266_tpu.config import CodecConfig, Profile, preset_cfg2
from x266_tpu.core.hashing import frame_md5
from x266_tpu.core.yuv import synthetic_clip
from x266_tpu_torch import config as tconfig
from x266_tpu_torch.api import Decoder, Encoder
from x266_tpu_torch.core.headers import parse_slice_header
from x266_tpu_torch.core.nal import NalType, split_nals
from x266_tpu_torch.engine.picture import (tile_compute_async, tile_entropy,
                                           tiles_compute_batched_async)
from x266_tpu_torch.utils.clips import luma_chroma
import torch  # noqa: E402

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _fixture(name):
    with open(os.path.join(FIXTURES, f"{name}.266t"), "rb") as f:
        return f.read()


def _manifest(name):
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)[name]


def test_reencodes_ai_hevc_fixture():
    # the fixture's source and config (tools/make_fixtures.py)
    cfg = CodecConfig(width=96, height=64, qp=32, rdoq=True)
    frames = synthetic_clip(96, 64, 1, kind="mixed", seed=77)
    res = Encoder(cfg, device="cpu", with_recon=False).encode(frames)
    assert res.bitstream == _fixture("ai_hevc")


def test_decodes_ai_hevc_fixture():
    _, dec = Decoder(device="cpu").decode(_fixture("ai_hevc"))
    assert [frame_md5(d) for d in dec] == _manifest("ai_hevc")["md5"]


def test_reencodes_lowdelay_p_filters_fixture():
    """The P step's loop filters on encode (deblock, SAO luma and chroma;
    merge candidates, AMVP, signalled reference lists): the fixture's
    source and config (tools/make_fixtures.py) give its bytes."""
    cfg = CodecConfig(width=96, height=64, qp=32, rdoq=True, intra_period=4,
                      deblock=True, sao=True, sao_chroma=True, rpl=True,
                      merge_cands=True, amvp=True)
    frames = synthetic_clip(96, 64, 4, kind="motion", seed=77)
    res = Encoder(cfg, device="cpu", with_recon=False).encode(frames)
    assert res.bitstream == _fixture("lowdelay_p_filters")


def test_ai_hevc_lossless_fixture_both_ways():
    """BASELINE's lossless gate: the fixture's source and config
    re-encode to its bytes, and the fixture decodes to its manifest MD5,
    which is the source's own."""
    cfg = CodecConfig(width=96, height=64, qp=32, lossless=True, rdoq=False)
    frames = synthetic_clip(96, 64, 1, kind="mixed", seed=77)
    res = Encoder(cfg, device="cpu").encode(frames)
    assert res.bitstream == _fixture("ai_hevc_lossless")
    _, dec = Decoder(device="cpu").decode(res.bitstream)
    want = _manifest("ai_hevc_lossless")["md5"]
    assert [frame_md5(d) for d in dec] == want
    assert [frame_md5(f) for f in frames] == want
    assert [frame_md5(r) for r in res.recon] == want
    assert all(float(s[0]) == 0.0 for s in res.sse)


def test_ai_vvc_mtt_lfnst_fixture_both_ways():
    """MTT binary splits and LFNST beside MTS (VVC): the fixture decodes
    to its manifest MD5s, and its source and config
    (tools/make_fixtures.py) re-encode to its bytes."""
    want = _manifest("ai_vvc_mtt_lfnst")["md5"]
    _, dec = Decoder(device="cpu").decode(_fixture("ai_vvc_mtt_lfnst"))
    assert [frame_md5(d) for d in dec] == want
    cfg = CodecConfig(width=96, height=64, qp=32, rdoq=True,
                      profile=Profile.VVC, mts=True, mtt=True, lfnst=True,
                      ref_substitute=True)
    frames = synthetic_clip(96, 64, 1, kind="mixed", seed=77)
    res = Encoder(cfg, device="cpu").encode(frames)
    assert res.bitstream == _fixture("ai_vvc_mtt_lfnst")
    assert [frame_md5(r) for r in res.recon] == want


def test_ai_vvc_tools_fixture_both_ways():
    """Sign-data hiding beside transform skip and MTS (VVC, WPP segments):
    the fixture's source and config (tools/make_fixtures.py) re-encode to
    its bytes, and the fixture decodes to its manifest MD5s."""
    cfg = CodecConfig(width=96, height=64, qp=32, rdoq=True,
                      profile=Profile.VVC, mts=True, transform_skip=True,
                      ref_substitute=True, sign_data_hiding=True,
                      rows_per_segment=1)
    frames = synthetic_clip(96, 64, 1, kind="text", seed=77)
    res = Encoder(cfg, device="cpu").encode(frames)
    assert res.bitstream == _fixture("ai_vvc_tools")
    want = _manifest("ai_vvc_tools")["md5"]
    assert [frame_md5(r) for r in res.recon] == want
    _, dec = Decoder(device="cpu").decode(_fixture("ai_vvc_tools"))
    assert [frame_md5(d) for d in dec] == want


@pytest.fixture(scope="module")
def t128():
    """The recorded JAX cfg2t clip and the port's CPU encode of it."""
    from x266_tpu_torch.config import preset_cfg2 as tpreset_cfg2

    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "t128x64_ref.json")) as f:
        ref = json.load(f)
    cfg = tpreset_cfg2(128, 64).replace(pdpc=True, mip=True,
                                        transform_skip=True,
                                        rows_per_segment=1, ctx_inherit=True)
    frames = synthetic_clip(128, 64, 2, "text", seed=5)
    return ref, Encoder(cfg, device="cpu", batch_frames=2).encode(frames)


def _refs_tool():
    """tools/make_torch_refs.py, which records the JAX references."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_refs", os.path.join(os.path.dirname(__file__), "..",
                                        "tools", "make_torch_refs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_cfg2t_clip_matches_recorded_jax(t128):
    """cfg2t at 128x64: the JAX encoder's bytes, SSE, PSNR and recon, and
    the port decodes the JAX stream to the JAX recon."""
    ref, port = t128
    tool = _refs_tool()
    assert (ref["config"], ref["clip"]) == (tool.T128_CONFIG, tool.T128_CLIP)
    stream = base64.b64decode(ref["stream_b64"])
    assert port.bitstream == stream
    assert port.frame_bits == ref["frame_bits"]
    assert [[float(v) for v in s] for s in port.sse] == ref["sse"]
    assert port.psnr_y(128, 64) == ref["psnr_y"]
    port_md5 = [frame_md5(r) for r in port.recon]
    assert port_md5 == ref["recon_md5"]
    _, dec = Decoder(device="cpu").decode(stream)
    assert [frame_md5(d) for d in dec] == port_md5


def test_jax_decodes_port_cfg2t_stream(t128):
    """The live anchor: the JAX decoder decodes the port's cfg2t stream
    to the port's recon."""
    _, port = t128
    _, jdec = JaxDecoder().decode(port.bitstream)
    assert [frame_md5(d) for d in jdec] == [frame_md5(r)
                                            for r in port.recon]


def test_cfg2_clip_matches_jax_both_ways():
    """Config 2 at 128x64, 3 frames in batches of 2: the recorded JAX
    encoder's bytes, bits, SSE, PSNR and recon
    (data/c128x64_ref.json), the port decodes the JAX stream to the JAX
    recon, and the live JAX decoder decodes the port's stream to it."""
    tool = _refs_tool()
    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "c128x64_ref.json")) as f:
        ref = json.load(f)
    assert (ref["config"], ref["clip"]) == (tool.C128_CONFIG,
                                            tool.C128_CLIP)
    cfg = preset_cfg2(128, 64).replace(rows_per_segment=1,
                                       ctx_inherit=True)
    frames = synthetic_clip(128, 64, 3, "mixed", seed=5)
    port = Encoder(cfg, device="cpu", batch_frames=2).encode(frames)
    stream = base64.b64decode(ref["stream_b64"])
    assert port.bitstream == stream
    assert port.frame_bits == ref["frame_bits"]
    assert port.total_bits == 8 * len(stream)
    port_md5 = [frame_md5(r) for r in port.recon]
    assert port_md5 == ref["recon_md5"]
    assert [[float(v) for v in s] for s in port.sse] == ref["sse"]
    assert port.psnr_y(128, 64) == ref["psnr_y"]
    _, dec = Decoder(device="cpu").decode(stream)
    assert [frame_md5(d) for d in dec] == port_md5
    _, jdec = JaxDecoder().decode(port.bitstream)
    assert [frame_md5(d) for d in jdec] == port_md5


@pytest.mark.parametrize("variant", ["plain", "merge-amvp-rpl"])
def test_lowdelay_p_clip_matches_jax_both_ways(variant):
    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "p128x64_ref.json")) as f:
        data = json.load(f)
    ref = data["variants"][variant]
    kw = dict(data["base"], **ref["tools"])
    frames = synthetic_clip(128, 64, 5, "motion", seed=3)
    port = Encoder(tconfig.CodecConfig(**kw), device="cpu").encode(frames)
    stream = base64.b64decode(ref["stream_b64"])
    assert port.bitstream == stream
    assert port.frame_bits == ref["frame_bits"]
    port_md5 = [frame_md5(r) for r in port.recon]
    assert port_md5 == ref["recon_md5"] == ref["decode_md5"]
    assert port.psnr_y(128, 64) == ref["psnr_y"]
    cfg = tconfig.CodecConfig(**kw)
    kinds = [parse_slice_header(rbsp, False, cfg.ctus_y * cfg.ctus_x,
                                has_rpl=cfg.rpl)[0].slice_type.name
             for t, rbsp in split_nals(port.bitstream)
             if t in (NalType.IDR, NalType.TRAIL)]
    assert kinds == ["I", "P", "P", "P", "I"]
    _, dec = Decoder(device="cpu").decode(stream)
    assert [frame_md5(d) for d in dec] == port_md5


def test_recorded_lowdelay_streams_match_live_jax():
    """Ties p128x64_ref.json to the JAX package: its configs and clip are
    those tools/make_torch_refs.py encodes, and the JAX decoder decodes
    its plain stream (the port's bytes, by the test above) to the
    recorded recon MD5s.  The merge-amvp-rpl stream is decoded by the
    tool only: here it would compile a second JAX GOP path."""
    tool = _refs_tool()
    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "p128x64_ref.json")) as f:
        data = json.load(f)
    assert data["base"] == tool.P128_BASE
    assert data["clip"] == "synthetic_clip(128, 64, 5, 'motion', seed=3)"
    assert {v: r["tools"] for v, r in data["variants"].items()} == \
        tool.P128_TOOLS
    ref = data["variants"]["plain"]
    _, jdec = JaxDecoder().decode(base64.b64decode(ref["stream_b64"]))
    assert [frame_md5(d) for d in jdec] == ref["recon_md5"]


def _p_slice(cfg, poc, ref_poc, mv_x):
    """A P slice RBSP of inter CUs at MV (mv_x, 0) referencing ref_poc."""
    from x266_tpu_torch.config import SliceType
    from x266_tpu_torch.engine.picture import assemble_slice, code_segments

    units = np.zeros((cfg.units_y, cfg.units_x), np.int32)
    zeros = [np.zeros((64, 64), np.int32)] + [np.zeros((32, 32), np.int32)] * 2
    segs = code_segments(cfg, units + 8, units, *zeros, units,
                         (units + 1, units + mv_x, units))
    return assemble_slice(cfg, poc, segs, SliceType.P, [[ref_poc]])


@pytest.mark.parametrize("rpl", [False, True])
def test_p_slice_without_its_reference_is_refused(rpl):
    """A P slice whose reference is not in the DPB -- without a reference
    list, no picture before it; with one, a POC never decoded -- is
    refused with a clear error."""
    from x266_tpu_torch.core.nal import write_nal

    cfg = tconfig.CodecConfig(width=64, height=64, intra_period=4, rpl=rpl)
    good = Encoder(cfg, device="cpu").encode(
        synthetic_clip(64, 64, 1, "motion", seed=1)).bitstream
    poc = 2 if rpl else 0
    bad = good + write_nal(NalType.TRAIL, _p_slice(cfg, poc, 1, 0))
    with pytest.raises(ValueError, match="not in the DPB"):
        Decoder(device="cpu").decode(bad)


def test_p_stream_mv_beyond_the_pad_is_refused():
    """A P slice whose MVs would read past the reference's pad: the
    reference clamps such reads, the kernel cannot, so the decoder
    refuses the stream instead."""
    from x266_tpu_torch.core.nal import write_nal

    cfg = tconfig.CodecConfig(width=64, height=64, intra_period=4)
    good = Encoder(cfg, device="cpu").encode(
        synthetic_clip(64, 64, 1, "motion", seed=1)).bitstream
    bad = good + write_nal(NalType.TRAIL, _p_slice(cfg, 1, 0, 4 * 90))
    with pytest.raises(ValueError, match="MV beyond"):
        Decoder(device="cpu").decode(bad)


def _ra128():
    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "ra128x64_ref.json")) as f:
        data = json.load(f)
    return data, synthetic_clip(128, 64, 5, "mixed", seed=4)


@pytest.fixture(scope="module")
def port_ra():
    """tools -> the port's CPU encode of the ra128x64 clip, made once per
    set of tools for this module's tests."""
    streams = {}

    def get(variant):
        data, frames = _ra128()
        tools = data["variants"][variant]["tools"]
        key = json.dumps(tools, sort_keys=True)
        if key not in streams:
            cfg = tconfig.preset_cfg4(128, 64).replace(**data["gop"], **tools)
            streams[key] = Encoder(cfg, device="cpu").encode(frames)
        return streams[key]

    return get


@pytest.mark.parametrize("variant", ["noalf", "full", "lumaalf"])
def test_ra_clip_matches_recorded_jax(variant, port_ra):
    data, _ = _ra128()
    ref = data["variants"][variant]
    port = port_ra(variant)
    stream = base64.b64decode(ref["stream_b64"])
    port_md5 = [frame_md5(r) for r in port.recon]
    jax_md5 = [f["recon_md5"] for f in ref["frames"]]
    assert port.bitstream == stream
    assert port_md5 == jax_md5
    _, dec = Decoder(device="cpu").decode(port.bitstream)
    assert [frame_md5(d) for d in dec] == port_md5
    _, dec = Decoder(device="cpu").decode(stream)
    assert [frame_md5(d) for d in dec] == jax_md5 == [
        f["decode_md5"] for f in ref["frames"]]
    cfg = tconfig.preset_cfg4(128, 64).replace(**data["gop"], **ref["tools"])
    kinds = [(sh.poc, sh.slice_type.name) for sh in (
        parse_slice_header(rbsp, cfg.alf, cfg.ctus_y * cfg.ctus_x,
                           cfg.alf_chroma)[0]
        for t, rbsp in split_nals(port.bitstream)
        if t in (NalType.IDR, NalType.TRAIL))]
    assert kinds == [(0, "I"), (4, "P"), (2, "B"), (1, "B"), (3, "B")]


def test_jax_decodes_port_ra_alf_stream(port_ra):
    """The JAX decoder's MD5s of the port's random-access stream with
    deblock, SAO and ALF: the stream is the recorded JAX stream byte for
    byte, so its JAX decode is the one tools/make_torch_refs.py recorded
    (the tool's configs and clip are the file's); the live JAX decoder
    runs the same machinery, loop filters included, on the tools_ra
    stream (test_jax_decodes_port_tools_ra_stream)."""
    data, _ = _ra128()
    tool = _refs_tool()
    assert data["gop"] == tool.RA128_GOP
    assert {v: r["tools"] for v, r in data["variants"].items()} == \
        tool.RA128_VARIANTS
    assert data["clip"] == "synthetic_clip(128, 64, 5, 'mixed', seed=4)"
    ref = data["variants"]["full"]
    port = port_ra("full")
    assert port.bitstream == base64.b64decode(ref["stream_b64"])
    assert [frame_md5(r) for r in port.recon] == [
        f["decode_md5"] for f in ref["frames"]]


def test_reencodes_ra_alf_fixture():
    """Random access with deblock, SAO, nonlinear luma and chroma ALF,
    CC-ALF and signalled reference lists: the fixture's source and config
    (tools/make_fixtures.py) give its bytes and its manifest MD5s."""
    cfg = CodecConfig(width=96, height=64, qp=32, rdoq=True, intra_period=8,
                      gop_size=4, deblock=True, sao=True, alf=True,
                      alf_chroma=True, alf_nonlinear=True, ccalf=True,
                      rpl=True)
    frames = synthetic_clip(96, 64, 5, kind="mixed", seed=77)
    res = Encoder(cfg, device="cpu").encode(frames)
    assert res.bitstream == _fixture("ra_alf")
    assert [frame_md5(r) for r in res.recon] == _manifest("ra_alf")["md5"]


def _ra_nl128():
    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "ra_nl128x64_ref.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_ra_nl():
    """The port's CPU encode of the ra_nl128x64 clip (nonlinear ALF and
    CC-ALF under random access), made once for this module's tests."""
    tool = _refs_tool()
    cfg = tconfig.preset_cfg4(128, 64).replace(**tool.RA128_GOP,
                                               **tool.NL_TOOLS)
    frames = luma_chroma(synthetic_clip(128, 64, 5, "motion", seed=3))
    return cfg, Encoder(cfg, device="cpu").encode(frames)


def test_ra_nl_clip_matches_recorded_jax(port_ra_nl):
    """Nonlinear luma ALF (clip indices, transposes), nonlinear chroma ALF
    (clip levels) and CC-ALF on a 5-frame 128x64 random-access clip whose
    chroma follows its luma (utils.clips.luma_chroma, on
    which CC-ALF turns on): the JAX encoder's stream, slice NALs, bits,
    SSE and recon (data/ra_nl128x64_ref.json), with classes clipped,
    chroma levels above 0 and CTBs under CC-ALF in its slice headers; the
    port decodes its stream to its recon."""
    ref = _ra_nl128()
    tool = _refs_tool()
    assert (ref["config"], ref["clip"]) == (tool.RA_NL128_CONFIG,
                                            tool.RA_NL128_CLIP)
    cfg, port = port_ra_nl
    assert port.bitstream == base64.b64decode(ref["stream_b64"])
    rec = [frame_md5(r) for r in port.recon]
    assert rec == [f["recon_md5"] for f in ref["frames"]]
    assert port.frame_bits == [f["bits"] for f in ref["frames"]]
    assert [[float(v) for v in s] for s in port.sse] == [
        f["sse"] for f in ref["frames"]]
    _, dec = Decoder(device="cpu").decode(port.bitstream)
    assert [frame_md5(d) for d in dec] == rec
    counts = ref["nl_counts"]
    assert all(sum(c[k] for c in counts) for k in (1, 2, 3))


def test_jax_decodes_port_ra_nl_stream(port_ra_nl):
    """The live JAX decoder decodes the port's nonlinear-ALF and CC-ALF
    stream to the port's recon."""
    _, port = port_ra_nl
    _, dec = JaxDecoder().decode(port.bitstream)
    assert [frame_md5(d) for d in dec] == [frame_md5(r) for r in port.recon]


@pytest.mark.parametrize("name", ["lowdelay_p_filters", "ra_alf"])
def test_decodes_filter_fixtures(name):
    _, dec = Decoder(device="cpu").decode(_fixture(name))
    assert [frame_md5(d) for d in dec] == _manifest(name)["md5"]


def test_single_frame_step_equals_batched():
    cfg = preset_cfg2(64, 64)
    enc = Encoder(cfg, device="cpu")
    frames = synthetic_clip(64, 64, 2, "mixed", seed=2)
    step = enc.steps_at(cfg.qp)[1][0]
    batched = tiles_compute_batched_async(cfg, step, frames, enc.device)()
    for frame, want in zip(frames, batched):
        got = tile_compute_async(cfg, step, frame, enc.device)()
        assert tile_entropy(got) == tile_entropy(want)
        assert frame_md5(got.recon) == frame_md5(want.recon)
        assert np.array_equal(got.sse, want.sse)


@pytest.mark.parametrize("kw", [
    # CCLM alone codes; with CU 64 (ROADMAP item 20) it is refused
    dict(profile=Profile.VVC, cclm=True, max_cu_size=64),
    dict(profile=Profile.VVC, lfnst=True, max_cu_size=64),
    dict(tile_rows=1), dict(profile=Profile.VVC, dep_quant=True,
                            bit_depth=10),
    dict(profile=Profile.VVC, mtt=True, bit_depth=10),
    dict(profile=Profile.VVC, mtt=True, sign_data_hiding=True, tile_rows=1),
    dict(bit_depth=10),
    dict(profile=Profile.VVC, max_cu_size=64),
    dict(alf=True, alf_nonlinear=True, bit_depth=10)])
def test_out_of_slice_configs_raise(kw):
    cfg = CodecConfig(width=128, height=128, **kw)
    with pytest.raises(NotImplementedError):
        Encoder(cfg, device="cpu")


def test_out_of_slice_streams_raise():
    """The ai_vvc_cu64 fixture (CU 64 with the 64-point DCT) is not in
    the slices."""
    with pytest.raises(NotImplementedError):
        Decoder(device="cpu").decode(_fixture("ai_vvc_cu64"))


GPB_RPL_WP = dict(width=96, height=64, qp=32, rdoq=True, intra_period=16,
                  multi_ref=True, rpl=True, weighted_pred=True)


def test_decodes_gpb_rpl_wp_fixture():
    """GPB with signalled reference lists and weighted prediction: the
    fixture decodes to its manifest MD5s."""
    _, dec = Decoder(device="cpu").decode(_fixture("gpb_rpl_wp"))
    assert [frame_md5(d) for d in dec] == _manifest("gpb_rpl_wp")["md5"]


def test_reencodes_gpb_rpl_wp_fixture():
    """The fixture's source and config (tools/make_fixtures.py) give its
    bytes: a P picture after the IDR, then B pictures on two past
    references whose slice headers carry the weights and lists."""
    cfg = tconfig.CodecConfig(**GPB_RPL_WP)
    frames = synthetic_clip(96, 64, 4, kind="motion", seed=77)
    res = Encoder(cfg, device="cpu").encode(frames)
    assert res.bitstream == _fixture("gpb_rpl_wp")
    assert [frame_md5(r) for r in res.recon] == \
        _manifest("gpb_rpl_wp")["md5"]
    kinds = [parse_slice_header(rbsp, False, cfg.ctus_y * cfg.ctus_x,
                                has_wp=True, has_rpl=True)[0].slice_type.name
             for t, rbsp in split_nals(res.bitstream)
             if t in (NalType.IDR, NalType.TRAIL)]
    assert kinds == ["I", "P", "B", "B"]


@pytest.mark.parametrize("tool", ["lossless", "transform_skip", "pdpc",
                                  "mip"])
def test_intra_tools_on_p_slices_raise(tool):
    """A stream whose P slice follows an IDR under an intra tool, which
    the port refused before it coded the tools on P pictures (the name
    is kept): the port decodes both pictures, the P slice to the JAX
    decoder's MD5.
    Transform skip comes with MTS here: the reference decodes P slices
    under transform skip only beside it (x266_tpu/engine/inter.py:805-807
    hands chroma TUs no transform index without MTS)."""
    from x266_tpu_torch.core.nal import write_nal

    tools = {tool: True, "mts": tool == "transform_skip"}
    cfg = tconfig.CodecConfig(width=64, height=64, intra_period=4,
                              profile=tconfig.Profile.VVC, **tools)
    good = Encoder(cfg.replace(intra_period=1), device="cpu").encode(
        synthetic_clip(64, 64, 1, "motion", seed=1)).bitstream
    # the same IDR under an SPS that announces P pictures, then a P slice
    nals = [write_nal(t, rbsp) for t, rbsp in split_nals(good)]
    from x266_tpu_torch.core import headers
    nals[1] = write_nal(NalType.SPS, headers.write_sps(cfg))
    stream = b"".join(nals) + write_nal(NalType.TRAIL,
                                        _p_slice(cfg, 1, 0, 0))
    _, dec = Decoder(device="cpu").decode(stream)
    _, jdec = JaxDecoder().decode(stream)
    assert len(dec) == 2
    assert [frame_md5(d) for d in dec] == [frame_md5(d) for d in jdec]


def _tools128():
    """The recorded JAX clips of the intra tools on P and B pictures, and
    tools/make_torch_refs.py, which recorded them."""
    tool = _refs_tool()
    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "tools128x64_ref.json")) as f:
        return json.load(f), tool


def _tools128_config(name, ref):
    if name == "lossless_p":
        return tconfig.preset_cfg3(128, 64).replace(intra_period=4,
                                                    lossless=True,
                                                    rdoq=False)
    tools = {k: tconfig.Profile(v) if k == "profile" else bool(v)
             for k, v in ref["tools"].items()}
    return tconfig.preset_cfg4(128, 64).replace(**RA128_GOP, **tools)


RA128_GOP = dict(gop_size=4, intra_period=8)


@pytest.fixture(scope="module")
def port_tools():
    """name -> (the recorded variant, the clip, the port's CPU encode),
    made once for this module's tests."""
    data, tool = _tools128()
    assert data["gop"] == tool.RA128_GOP == RA128_GOP
    done = {}

    def get(name):
        if name not in done:
            ref = data["variants"][name]
            text, tools, kind, seed = tool.TOOLS128[name]
            assert ref["config"] == text
            assert ref["clip"] == (f"synthetic_clip(128, 64, 5, '{kind}', "
                                   f"seed={seed})")
            assert ref["tools"] == {k: int(v) for k, v in
                                    (tools or {}).items()}
            frames = synthetic_clip(128, 64, 5, kind, seed=seed)
            done[name] = (ref, frames, Encoder(_tools128_config(name, ref),
                                               device="cpu").encode(frames))
        return done[name]

    return get


@pytest.mark.parametrize("name", ["lossless_p", "lossless_ra", "tools_ra"])
def test_tools_clip_matches_recorded_jax(name, port_tools):
    """Lossless low-delay P, lossless random access and VVC's intra
    tools under random access at 128x64: the JAX encoder's bytes, bits,
    SSE, PSNR and recon; the port decodes the JAX stream to the JAX
    recon, and a lossless stream to its input."""
    ref, frames, port = port_tools(name)
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
    if "lossless" in name:
        assert port_md5 == [frame_md5(f) for f in frames]


def test_jax_decodes_port_tools_ra_stream(port_tools):
    """The live anchor: the JAX decoder decodes the port's stream of the
    intra tools on P and B pictures (config 4: deblock, SAO and ALF
    too) to the port's recon."""
    _, _, port = port_tools("tools_ra")
    _, jdec = JaxDecoder().decode(port.bitstream)
    assert [frame_md5(d) for d in jdec] == [frame_md5(r)
                                            for r in port.recon]


@pytest.fixture(scope="module")
def port_cfg5():
    """The recorded JAX config-5 clip, and the port's CPU encode of it."""
    tool = _refs_tool()
    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "cfg5_112x80_ref.json")) as f:
        ref = json.load(f)
    assert (ref["config"], ref["clip"]) == (tool.CFG5_CONFIG, tool.CFG5_CLIP)
    frames = synthetic_clip(112, 80, 17, "motion", seed=3)
    return ref, Encoder(tconfig.preset_cfg5(112, 80),
                        device="cpu").encode(frames)


def test_cfg5_clip_matches_recorded_jax(port_cfg5):
    """preset_cfg5 at 112x80 across its intra period: the JAX encoder's
    stream, slice NALs, bits, SSE, PSNR and recon; the port decodes the
    JAX stream to the JAX recon."""
    ref, port = port_cfg5
    stream = base64.b64decode(ref["stream_b64"])
    assert port.bitstream == stream
    nals = [t for t, _ in split_nals(port.bitstream)
            if t in (NalType.IDR, NalType.TRAIL)]
    assert nals.count(NalType.IDR) == 2 and len(nals) == 17
    fr = ref["frames"]
    assert port.frame_bits == [f["bits"] for f in fr]
    assert [[float(v) for v in s] for s in port.sse] == [f["sse"] for f in fr]
    assert port.psnr_y(112, 80) == [f["psnr_y"] for f in fr]
    port_md5 = [frame_md5(r) for r in port.recon]
    assert port_md5 == [f["recon_md5"] for f in fr] == [
        f["decode_md5"] for f in fr]
    _, dec = Decoder(device="cpu").decode(stream)
    assert [frame_md5(d) for d in dec] == port_md5


def test_jax_decodes_port_cfg5_stream(port_cfg5):
    """The live anchor: the JAX decoder decodes the port's config-5
    stream (deblock and SAO, WPP segments) to the port's recon."""
    _, port = port_cfg5
    _, jdec = JaxDecoder().decode(port.bitstream)
    assert [frame_md5(d) for d in jdec] == [frame_md5(r)
                                            for r in port.recon]
