"""Rate control in the port's Encoder against the JAX encoder, on the CPU.

Both of the reference's controllers (utils/ratecontrol.py, a copy of
x266_tpu/utils/ratecontrol.py: make_controller, the PI loop on the bits,
and make_lambda_controller, the R-lambda model) drive a 128x64 low-delay
P clip (config 3 shaped, IDR every 4 frames) and a 128x64 all-intra clip
(config 2) at half their fixed-QP rate.  The JAX encoder's stream, its
per-picture QPs (the slice headers') and recon, with an identical
controller, are recorded in x266_tpu_torch/data/rc128x64_ref.json by
tools/make_torch_refs.py; the port's equal them byte for byte, with at
least two QPs in each stream, and the port decodes its stream to its
recon.  Two of the four variants, one per controller and per stream
kind (the PI loop on the P clip, the lambda model on the all-intra
clip), are also held to the live JAX encoder here, so the recording
cannot go stale against the reference (each new QP compiles a JAX step:
about a minute each on one core).  Rate control on a random-access or
GPB config raises ValueError, as the reference's encoder does.
"""

import base64
import importlib.util
import json
import os

import pytest
import torch

from x266_tpu_torch import config as tconfig
from x266_tpu_torch.api import Decoder, Encoder
from x266_tpu_torch.core.hashing import frame_md5
from x266_tpu_torch.core.headers import parse_slice_header
from x266_tpu_torch.core.nal import NalType, split_nals
from x266_tpu_torch.core.yuv import synthetic_clip
from x266_tpu_torch.utils import ratecontrol

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def _ref():
    with open(os.path.join(os.path.dirname(tconfig.__file__), "data",
                           "rc128x64_ref.json")) as f:
        return json.load(f)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_refs", os.path.join(HERE, "..", "tools",
                                        "make_torch_refs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _config(clip):
    if clip == "p":
        return tconfig.preset_cfg3(128, 64).replace(intra_period=4)
    return tconfig.preset_cfg2(128, 64)


def _controller(c, cfg, module=ratecontrol):
    if c["kind"] == "pi":
        return module.make_controller(cfg, c["bitrate_kbps"], c["fps"])
    return module.make_lambda_controller(cfg, c["bitrate_kbps"], c["fps"],
                                         n_frames=c["n_frames"])


def _qps(cfg, stream):
    return [parse_slice_header(rbsp, cfg.alf, cfg.ctus_y * cfg.ctus_x)[0].qp
            for t, rbsp in split_nals(stream)
            if t in (NalType.IDR, NalType.TRAIL)]


def test_recorded_controllers_are_the_tools():
    """The file's configs, clips and controller arguments are the ones
    tools/make_torch_refs.py records with the JAX encoder."""
    tool = _tool()
    ref = _ref()
    for clip, (text, kind, n) in tool.RC128_CLIPS.items():
        for kind_c in ("pi", "lambda"):
            v = ref["variants"][f"{clip}_{kind_c}"]
            assert v["config"] == text
            assert v["clip"] == f"synthetic_clip(128, 64, {n}, '{kind}', " \
                                "seed=3)"
            assert v["controller"] == {
                "kind": kind_c, "bitrate_kbps": tool.RC128_KBPS[clip],
                "fps": 30.0, "n_frames": n}


@pytest.mark.parametrize("variant", ["p_pi", "p_lambda", "ai_pi",
                                     "ai_lambda"])
def test_rate_controlled_clip_matches_recorded_jax(variant):
    clip, _ = variant.split("_")
    ref = _ref()["variants"][variant]
    cfg = _config(clip)
    n = ref["controller"]["n_frames"]
    kind = "motion" if clip == "p" else "mixed"
    frames = synthetic_clip(128, 64, n, kind, seed=3)
    rc = _controller(ref["controller"], cfg)
    res = Encoder(cfg, device="cpu", rate_control=rc).encode(frames)
    qps = _qps(cfg, res.bitstream)
    assert qps == ref["qp"]
    assert len(set(qps)) >= 2
    assert res.bitstream == base64.b64decode(ref["stream_b64"])
    assert res.frame_bits == [f["bits"] for f in ref["frames"]]
    rec = [frame_md5(r) for r in res.recon]
    assert rec == [f["recon_md5"] for f in ref["frames"]]
    assert [[float(v) for v in s] for s in res.sse] == [
        f["sse"] for f in ref["frames"]]
    _, dec = Decoder(device="cpu").decode(res.bitstream)
    assert [frame_md5(d) for d in dec] == rec == [
        f["decode_md5"] for f in ref["frames"]]


@pytest.mark.parametrize("variant", ["p_pi", "ai_lambda"])
def test_rate_controlled_clip_matches_live_jax(variant):
    """The same controller drives the JAX encoder and the port's."""
    from x266_tpu.api import Encoder as JaxEncoder
    from x266_tpu.utils import ratecontrol as jax_ratecontrol

    clip, _ = variant.split("_")
    text, kind, n = _tool().RC128_CLIPS[clip]
    c = {"kind": variant.split("_")[1],
         "bitrate_kbps": _tool().RC128_KBPS[clip], "fps": 30.0,
         "n_frames": n}
    cfg = _config(clip)
    frames = synthetic_clip(128, 64, n, kind, seed=3)
    want = JaxEncoder(cfg, with_recon=True,
                      rate_control=_controller(c, cfg, jax_ratecontrol)
                      ).encode(frames)
    rc = _controller(c, cfg)
    got = Encoder(cfg, device="cpu", rate_control=rc).encode(frames)
    qps = _qps(cfg, got.bitstream)
    assert qps == _qps(cfg, want.bitstream)
    assert len(set(qps)) >= 2
    assert got.bitstream == want.bitstream
    assert [frame_md5(r) for r in got.recon] == [
        frame_md5(r) for r in want.recon]


@pytest.mark.parametrize("kw", [dict(gop_size=4, intra_period=8),
                                dict(intra_period=8, multi_ref=True)],
                         ids=["random-access", "gpb"])
def test_rate_control_outside_low_delay_raises(kw):
    cfg = tconfig.CodecConfig(width=64, height=64, qp=32, **kw)
    rc = ratecontrol.make_controller(cfg, 20.0, 30.0)
    with pytest.raises(ValueError):
        Encoder(cfg, device="cpu", rate_control=rc).encode(
            synthetic_clip(64, 64, 2, "motion", seed=1))
