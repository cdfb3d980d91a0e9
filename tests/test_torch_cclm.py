"""CCLM (chroma from luma, on I pictures) in the port against the JAX
package on the CPU, exactly (bit for bit):

- ``engine.recon.cclm_pred`` against x266_tpu.engine.recon.cclm_pred
  (jitted) on seeded numpy planes at chroma TU sides 4, 8 and 16, at the
  picture's top-left corner, top row, left column and inside, on planes
  whose model has a negative slope (alpha's floored division), whose
  four boundary luma values tie (argmin / argmax take the first), whose
  luma is flat (lmax = lmin) and on random ones; the padding is random
  too, where the reference's dynamic_slice reads it for a start of -1;
- the plain scan's seven outputs (the mts map with the CCLM choices in
  bit 3 last) against the JAX scan's on the JAX Pass-A maps, CCLM alone
  and with LFNST, and the decode scan on those levels and that map
  against the JAX decode scan; both CCLM choices occur at each CU size
  8, 16 and 32 (the other tools' combinations are held to JAX through
  the recorded streams below);
- the Encoder's streams, recon, SSE and PSNR-Y on 128x64 clips whose
  chroma is made from the luma, against data/cclm128x64_ref.json
  (tools/make_torch_refs.py cclm128x64): CCLM alone; with MTS,
  transform skip, PDPC, MIP and substitution; with LFNST and DQ; with
  SDH; lossless; low-delay I + P with deblock; random access (GOP 4);
  the Decoder on each reference stream gives the JAX decoder's
  pictures.  Under LFNST the reference's encoder codes the map without
  the LFNST index (its seventh output keeps bits 0-2 and 3), so that
  stream decodes to other pictures than the encoder's recon, in both
  packages alike.
"""

import base64
import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from x266_tpu.config import CodecConfig, Profile, preset_cfg2
from x266_tpu.core.yuv import synthetic_clip as jclip
from x266_tpu.engine import recon as jrecon
from x266_tpu.engine.mode_decision import (make_mode_decision,
                                           make_mts_select, pad_plane)
from x266_tpu_torch import tables
from x266_tpu_torch.api import Decoder, Encoder
from x266_tpu_torch.config import CodecConfig as TCodecConfig
from x266_tpu_torch.config import Profile as TProfile
from x266_tpu_torch.config import (preset_cfg2 as tpreset_cfg2,
                                   preset_cfg2s, preset_cfg3, preset_cfg4)
from x266_tpu_torch.core.hashing import frame_md5
from x266_tpu_torch.core.yuv import synthetic_clip
from x266_tpu_torch.engine import recon
from x266_tpu_torch.utils.clips import luma_chroma

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "x266_tpu_torch", "data")


def _planes(kind, rng, h=64, w=128, pad=72):
    """Padded (1 + h + pad, 1 + w + pad) luma and chroma int32 planes of
    one kind, random padding included."""
    yp = rng.integers(0, 256, (1 + h + pad, 1 + w + pad))
    cp = rng.integers(0, 256, (1 + h // 2 + pad, 1 + w // 2 + pad))
    if kind == "negative":
        # chroma falls as the 2x2 luma mean rises (luma_chroma's Cr)
        s = (yp[1::2, 1::2][:cp.shape[0] - 1, :cp.shape[1] - 1]
             + yp[2::2, 1::2][:cp.shape[0] - 1, :cp.shape[1] - 1]
             + yp[1::2, 2::2][:cp.shape[0] - 1, :cp.shape[1] - 1]
             + yp[2::2, 2::2][:cp.shape[0] - 1, :cp.shape[1] - 1] + 2) >> 2
        cp[:s.shape[0], :s.shape[1]] = np.clip(128 - (s - 128) // 2 + 3,
                                               0, 255)
    elif kind == "ties":
        # 2x2 blocks of two values: the four boundary means often tie
        blk = rng.choice([60, 190], (yp.shape[0] // 2 + 1,
                                     yp.shape[1] // 2 + 1))
        yp = np.kron(blk, np.ones((2, 2), int))[:yp.shape[0], :yp.shape[1]]
    elif kind == "flat":
        yp = np.full_like(yp, 77)
    return yp.astype(np.int32), cp.astype(np.int32)


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_cclm_pred_matches_jax(cs):
    jf = jax.jit(jrecon.cclm_pred, static_argnums=(4, 5))
    rng = np.random.default_rng(cs)
    falls = 0
    for kind in ("random", "negative", "ties", "flat"):
        yp, cp = _planes(kind, rng)
        ty, tc = torch.from_numpy(yp), torch.from_numpy(cp)
        for xc, yc in ((0, 0), (16, 0), (0, 16), (32 - cs, 16 + cs)):
            want = np.asarray(jf(yp, cp, xc, yc, cs, 255))
            got = recon.cclm_pred(ty, tc, xc, yc, cs, 255)
            assert np.array_equal(want, got.numpy()), (kind, xc, yc)
            ds = recon._ds2(ty[2 * yc + 1:2 * yc + 1 + 2 * cs,
                               2 * xc + 1:2 * xc + 1 + 2 * cs])
            if kind == "flat":
                assert (got == got[0, 0]).all()
            elif kind == "negative" and got.unique().numel() > 1:
                falls += bool(np.corrcoef(ds.flatten().numpy(),
                                          got.flatten().numpy())[0, 1] < 0)
    assert falls > 0


SCAN_CFGS = {
    "cclm": preset_cfg2(128, 64).replace(cclm=True),
    # LFNST: the seventh output keeps no LFNST index (bits 6-7)
    "lfnst": preset_cfg2(128, 64).replace(cclm=True, lfnst=True),
}


def _jax_inputs(cfg, seed):
    f = luma_chroma(jclip(cfg.width, cfg.height, 1, "mixed", seed=seed))[0]
    planes = [pad_plane(p).astype(np.int32) for p in (f.y, f.cb, f.cr)]
    size_map, mode_map = make_mode_decision(cfg)(planes[0])
    mts_map = make_mts_select(cfg)(planes[0], size_map, mode_map)
    return planes, [np.asarray(m).astype(np.int32)
                    for m in (size_map, mode_map, mts_map)]


@pytest.mark.parametrize("name", list(SCAN_CFGS))
def test_plain_scan_matches_jax(name):
    cfg = SCAN_CFGS[name]
    planes, maps = _jax_inputs(cfg, seed=7)
    want = jrecon.make_recon_pass(cfg, encode=True)(*planes, *maps)
    tcfg = TCodecConfig(**{k: (TProfile(v.value) if k == "profile" else v)
                           for k, v in vars(cfg).items()})
    tab = tables.from_reference(tcfg, "cpu")
    src = [torch.from_numpy(p.astype(np.uint8)[None]) for p in planes]
    tm = [torch.from_numpy(m[None]) for m in maps]
    got = recon.make_recon_pass_raw(tcfg, tab, True)(*src, *tm)
    assert len(want) == len(got) == 7
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(w), g[0].numpy()), i
    cc, size = (np.asarray(want[6]) >> 3) & 1, maps[0]
    if name == "cclm":
        assert all(((cc == v) & (size == s)).any() for v in (0, 1)
                   for s in (8, 16, 32))
    # the decode scans on the levels and the map with the choices
    dwant = jrecon.make_recon_pass(cfg, encode=False)(
        *(np.asarray(c).astype(np.int32) for c in want[3:6]), maps[0],
        maps[1], np.asarray(want[6]))
    dgot = recon.make_recon_pass_raw(tcfg, tab, False)(
        *got[3:6], tm[0], tm[1], got[6])
    for i, (w, g) in enumerate(zip(dwant[:3], dgot[:3])):
        assert np.array_equal(np.asarray(w), g[0].numpy()), i


def _ref():
    with open(os.path.join(DATA, "cclm128x64_ref.json")) as f:
        return json.load(f)["variants"]


def _config(text):
    return eval(text, {"preset_cfg2": tpreset_cfg2,
                       "preset_cfg2s": preset_cfg2s,
                       "preset_cfg3": preset_cfg3, "preset_cfg4": preset_cfg4,
                       "CodecConfig": TCodecConfig, "Profile": TProfile})


def _clip(text):
    return eval(text, {"luma_chroma": luma_chroma,
                       "synthetic_clip": synthetic_clip})


@pytest.mark.parametrize("name", ["ai", "tools", "lfnst_dq", "sdh",
                                  "lossless", "ld", "ra"])
def test_stream_matches_reference(name):
    v = _ref()[name]
    cfg = _config(v["config"])
    frames = _clip(v["clip"])
    res = Encoder(cfg, device="cpu").encode(frames)
    stream = base64.b64decode(v["stream_b64"])
    assert hashlib.md5(res.bitstream).hexdigest() == v["stream_md5"]
    assert res.bitstream == stream
    for i, r in enumerate(v["frames"]):
        assert frame_md5(res.recon[i]) == r["recon_md5"], i
        assert [float(x) for x in res.sse[i]] == r["sse"], i
        assert res.psnr_y(cfg.width, cfg.height)[i] == r["psnr_y"], i
    _, dec = Decoder(device="cpu").decode(stream)
    assert [frame_md5(d) for d in dec] == [r["decode_md5"]
                                           for r in v["frames"]]
    same = [r["decode_md5"] == r["recon_md5"] for r in v["frames"]]
    assert all(same) == (not cfg.lfnst)
