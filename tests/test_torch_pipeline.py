"""The port's Encoder/Decoder on the CPU against the JAX package.

Exact equality throughout (bytes and MD5s), except the device-computed
PSNR, which the reference sums in float32 (F4): within 1e-4 dB.
- the port re-encodes the ai_hevc golden fixture's source to its bytes
  and decodes the fixture to its manifest MD5;
- a 3-frame 128x64 config-2 shaped clip gives the JAX encoder's bytes,
  the port decodes the JAX stream to JAX's recon, and the JAX decoder
  decodes the port's stream to the port's recon;
- the one-frame device step gives what the batched step gives per frame;
- configurations outside the slice raise NotImplementedError.
"""

import json
import os

import numpy as np
import pytest

from x266_tpu.api import Decoder as JaxDecoder
from x266_tpu.api import Encoder as JaxEncoder
from x266_tpu.config import CodecConfig, preset_cfg2
from x266_tpu.core.hashing import frame_md5
from x266_tpu.core.yuv import synthetic_clip
from x266_tpu_torch.api import Decoder, Encoder
from x266_tpu_torch.engine.picture import (tile_compute_async, tile_entropy,
                                           tiles_compute_batched_async)

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


def test_cfg2_clip_matches_jax_both_ways():
    cfg = preset_cfg2(128, 64).replace(rows_per_segment=1,
                                       ctx_inherit=True)
    frames = synthetic_clip(128, 64, 3, "mixed", seed=5)
    port = Encoder(cfg, device="cpu", batch_frames=2).encode(frames)
    ref = JaxEncoder(cfg, with_recon=True).encode(frames)
    assert port.bitstream == ref.bitstream
    assert port.frame_bits == ref.frame_bits
    assert port.total_bits == ref.total_bits
    port_md5 = [frame_md5(r) for r in port.recon]
    assert port_md5 == [frame_md5(r) for r in ref.recon]
    assert np.allclose(port.psnr_y(128, 64), ref.psnr_y(128, 64),
                       rtol=0, atol=1e-4)
    _, dec = Decoder(device="cpu").decode(ref.bitstream)
    assert [frame_md5(d) for d in dec] == port_md5
    _, jdec = JaxDecoder().decode(port.bitstream)
    assert [frame_md5(d) for d in jdec] == port_md5


def test_single_frame_step_equals_batched():
    cfg = preset_cfg2(64, 64)
    enc = Encoder(cfg, device="cpu")
    frames = synthetic_clip(64, 64, 2, "mixed", seed=2)
    batched = tiles_compute_batched_async(cfg, enc.step, frames, enc.device)()
    for frame, want in zip(frames, batched):
        got = tile_compute_async(cfg, enc.step, frame, enc.device)()
        assert tile_entropy(got) == tile_entropy(want)
        assert frame_md5(got.recon) == frame_md5(want.recon)
        assert np.array_equal(got.sse, want.sse)


@pytest.mark.parametrize("kw", [
    dict(intra_period=4), dict(deblock=True), dict(tile_rows=1),
    dict(lossless=True), dict(transform_skip=True),
    dict(sign_data_hiding=True), dict(bit_depth=10)])
def test_out_of_slice_configs_raise(kw):
    cfg = CodecConfig(width=128, height=128, **kw)
    with pytest.raises(NotImplementedError):
        Encoder(cfg, device="cpu")


def test_out_of_slice_streams_raise():
    with pytest.raises(NotImplementedError):
        Decoder(device="cpu").decode(_fixture("lowdelay_p_filters"))
