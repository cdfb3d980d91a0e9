"""Write the JAX reference results that the PyTorch port is held to on a
machine without JAX.

Encodes frames 0-3 of a main-path clip with the JAX package on the CPU
and records per frame the coded bits, the device-accounted PSNR-Y, the
MD5 of the slice NAL and the MD5 of the reconstruction.
``chip_smoke.py`` compares the port's encode of the same frames against
these files.

- cfg2: all-intra 1080p VVC (``preset_cfg2`` + one entropy segment per
  CTU row + WPP context inheritance, the ``bench.py`` headline
  configuration) on the 'mixed' clip -> data/cfg2_1080p_ref.json;
- cfg3: low-delay P 1080p (``preset_cfg3``: IDR then P pictures) on the
  'motion' clip -> data/cfg3_1080p_ref.json;
- cfg2t: config 2 with VVC's intra tools (PDPC, MIP, transform skip) on
  the 'text' clip, the content transform skip targets ->
  data/cfg2t_1080p_ref.json;
- lossless: the ai_hevc_lossless fixture's configuration at 1080p on the
  'mixed' clip -> data/lossless_1080p_ref.json;
- p128x64: the JAX encoder's whole stream, its recon MD5s and the JAX
  decoder's MD5s of that stream for a 5-frame 128x64 low-delay clip
  (I P P P I), plain and with merge candidates, AMVP and signalled
  reference lists -> data/p128x64_ref.json, which
  tests/test_torch_pipeline.py holds the port's CPU encoder and decoder
  to (compiling the JAX GOP path in the test would cost over a minute);
- cfg4 / cfg4noalf: random access with deblock, SAO and ALF
  (``preset_cfg4(416, 240)``; cfg4noalf without luma and chroma ALF),
  17 frames of the 'mixed' clip (one GOP of 16 and its next anchor:
  I, P and 15 B pictures) -> data/cfg4_416x240_ref.json and
  data/cfg4noalf_416x240_ref.json, per frame in display order, with the
  whole stream; cfg4noalf_1080p the same at 1920x1080 (frames 0-3 would
  not hold a B picture; it is recorded only on request);
- t128x64 / c128x64: the JAX encoder's whole stream, recon MD5s, SSE
  and PSNR of a 2-frame 128x64 cfg2t clip ('text') and a 3-frame config
  2 clip ('mixed') -> data/t128x64_ref.json, data/c128x64_ref.json,
  which tests/test_torch_pipeline.py holds the port to (the JAX encodes
  would compile in the test; it decodes the port's streams with the JAX
  decoder live);
- ra128x64: the same for a 5-frame 128x64 random-access clip (GOP 4:
  I, P, then B pictures at POC 2, 1, 3) with ALF ("full"), without it
  ("noalf") and with luma ALF only ("lumaalf") -> data/ra128x64_ref.json,
  for the CPU tests;
- the intra tools on P and B pictures: lossless_p (config 3 with
  lossless, frames 0-3 of 'motion' at 1080p) ->
  data/lossless_p_1080p_ref.json; tools_ra (config 4 at 1080p with
  MTS, PDPC, MIP and transform skip, 17 frames of 'motion') ->
  data/tools_ra_1080p_ref.json; lossless_ra (config 4 at 416x240,
  lossless, no loop filters, 17 frames of 'mixed') ->
  data/lossless_ra_416x240_ref.json; tools128x64: the three at 128x64
  for the CPU tests (5 frames, GOP 4) -> data/tools128x64_ref.json;
- cfg4_4k: config 4 at 3840x2160, 17 frames of 'mixed' (chip_smoke.py
  [main-ra]) -> data/cfg4_4k_ref.json.  Every RA recording writes each
  slice NAL's MD5 to <file>.partial.json as it is coded (about 70 s a
  4K picture on an 8-core CPU), so a cut run leaves the pictures it
  reached; a finished one removes it;
- cfg5: config 5's single-device form (``preset_cfg5``: low-delay P,
  intra period 16, deblock and SAO, one entropy segment per CTU row with
  WPP context inheritance) at 112x80, two CTU rows so that the second
  segment inherits the first's contexts and the loop filters cross a
  CTU-row edge, 17 frames of 'motion' (I, 15 P, I: across the intra
  period), for the CPU tests and chip_smoke.py [main-cfg5] ->
  data/cfg5_112x80_ref.json;
- weighted prediction and GPB (low-delay B on two past references):
  gpb_wp (config 3 at 1080p with multi_ref, signalled reference lists
  and weighted prediction, frames 0-4 of 'motion' under a luma fade: I,
  P, then B pictures on a DPB of two, three and four entries;
  chip_smoke.py [main-gpb]) -> data/gpb_wp_1080p_ref.json, with a
  .partial.json as the RA recordings; wp128x64: four 6-frame 128x64
  variants on a faded 'motion' clip for the CPU tests -- GPB without
  reference lists (L1 derived by the decoder), GPB with lists and
  weighted prediction, low-delay P with weighted prediction and random
  access (GOP 4, config 4) with weighted prediction ->
  data/wp128x64_ref.json;
- nonlinear ALF and CC-ALF: ra_nl_1080p (config 4 at 1080p with
  alf_nonlinear and ccalf, 17 frames of 'motion' with chroma made from
  the luma (luma_chroma): I, P, 15 B;
  chip_smoke.py [main-ra-nl]) -> data/ra_nl_1080p_ref.json, with a
  .partial.json as the RA recordings; ra_nl128x64: the same at 128x64
  (5 frames, GOP 4) for the CPU tests -> data/ra_nl128x64_ref.json; both
  record per slice (coding order) the luma classes whose clip index is
  not 0, the chroma planes whose clip level is not 0 and the CTBs with
  CC-ALF on;
- rate control on low-delay streams: rc_1080p (config 3 at 1080p, 8
  frames of 'motion', ``make_lambda_controller`` at half of
  data/cfg3_1080p_ref.json's bits per frame at 30 fps; chip_smoke.py
  [main-rc]) -> data/rc_1080p_ref.json; rc128x64: both controllers
  (``make_controller``, ``make_lambda_controller``) on a 128x64
  low-delay P clip and an all-intra clip, for the CPU tests ->
  data/rc128x64_ref.json; each records the controller's arguments and
  the QP of every slice;
- sign-data hiding and dependent quantization: cfg2s, cfg2dq, cfg3dq
  (1080p, frames 0-3), ra_sdh and ra_dq (config 4 at 416x240, 17
  frames), sdhdq128x64 (five 128x64 clips for the CPU tests);
- MTT and LFNST (I pictures): cfg2q (``preset_cfg2q``, MTT + SDH, with
  config 2's segments) and cfg2ml (config 2 + MTT + LFNST), frames 0-3
  of 'mixed' at 1080p (chip_smoke.py [main-mtt], [main-mtt-lfnst]) ->
  data/cfg2q_1080p_ref.json, data/cfg2ml_1080p_ref.json; mttlfnst128x64:
  three 128x64 clips for the CPU tests (config 2 + both on 'text', the
  quality preset, a low-delay clip with deblock) ->
  data/mttlfnst128x64_ref.json.

    python tools/make_torch_refs.py [cfg2] [cfg3] [cfg2t] [lossless]
        [p128x64] [t128x64] [c128x64] [cfg4] [cfg4noalf] [ra128x64]
        [cfg4noalf_1080p] [lossless_p] [tools_ra] [lossless_ra]
        [tools128x64] [cfg4_4k] [cfg5] [gpb_wp] [wp128x64]
        [ra_nl_1080p] [ra_nl128x64] [rc_1080p] [rc128x64] [cfg2s]
        [cfg2dq] [cfg3dq] [ra_sdh] [ra_dq] [sdhdq128x64] [cfg2q] [cfg2ml]
        [mttlfnst128x64]
    # default: cfg2 to ra128x64; minutes per 1080p frame, about two
    # minutes for each 416x240 RA clip and for ra128x64, half an hour
    # for cfg4_4k
"""
import base64
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from x266_tpu.api import Decoder, Encoder  # noqa: E402
from x266_tpu.config import (CodecConfig, Profile, preset_cfg2,  # noqa
                             preset_cfg2q, preset_cfg2s, preset_cfg3,
                             preset_cfg4, preset_cfg5)
from x266_tpu.core.hashing import frame_md5  # noqa: E402
from x266_tpu.core.nal import NalType, split_nals, write_nal  # noqa: E402
from x266_tpu.core.yuv import Frame, synthetic_clip  # noqa: E402
from x266_tpu_torch.utils.clips import luma_chroma  # noqa: E402

W, H, N = 1920, 1080, 4
DATA = os.path.join(ROOT, "x266_tpu_torch", "data")
REFS = {
    "cfg2": (lambda: preset_cfg2(W, H).replace(rows_per_segment=1,
                                                ctx_inherit=True),
             "preset_cfg2(1920, 1080).replace(rows_per_segment=1, "
             "ctx_inherit=True)", "mixed"),
    "cfg3": (lambda: preset_cfg3(W, H), "preset_cfg3(1920, 1080)",
             "motion"),
    "cfg2t": (lambda: preset_cfg2(W, H).replace(
        pdpc=True, mip=True, transform_skip=True, rows_per_segment=1,
        ctx_inherit=True),
              "preset_cfg2(1920, 1080).replace(pdpc=True, mip=True, "
              "transform_skip=True, rows_per_segment=1, ctx_inherit=True)",
              "text"),
    "lossless": (lambda: CodecConfig(width=W, height=H, qp=32,
                                     lossless=True, rdoq=False),
                 "CodecConfig(width=1920, height=1080, qp=32, "
                 "lossless=True, rdoq=False)", "mixed"),
    "lossless_p": (lambda: preset_cfg3(W, H).replace(lossless=True,
                                                     rdoq=False),
                   "preset_cfg3(1920, 1080).replace(lossless=True, "
                   "rdoq=False)", "motion"),
    # sign-data hiding and dependent quantization
    "cfg2s": (lambda: preset_cfg2s(W, H).replace(rows_per_segment=1,
                                                  ctx_inherit=True),
              "preset_cfg2s(1920, 1080).replace(rows_per_segment=1, "
              "ctx_inherit=True)", "text"),
    "cfg2dq": (lambda: preset_cfg2(W, H).replace(
        rows_per_segment=1, ctx_inherit=True, dep_quant=True),
               "preset_cfg2(1920, 1080).replace(rows_per_segment=1, "
               "ctx_inherit=True, dep_quant=True)", "mixed"),
    "cfg3dq": (lambda: preset_cfg3(W, H).replace(profile=Profile.VVC,
                                                  dep_quant=True),
               "preset_cfg3(1920, 1080).replace(profile=Profile.VVC, "
               "dep_quant=True)", "motion"),
    # MTT binary splits and LFNST (I pictures): the quality preset
    # (MTT + SDH), and config 2 with the ai_vvc_mtt_lfnst fixture's tools
    "cfg2q": (lambda: preset_cfg2q(W, H).replace(rows_per_segment=1,
                                                  ctx_inherit=True),
              "preset_cfg2q(1920, 1080).replace(rows_per_segment=1, "
              "ctx_inherit=True)", "mixed"),
    "cfg2ml": (lambda: preset_cfg2(W, H).replace(
        rows_per_segment=1, ctx_inherit=True, mtt=True, lfnst=True),
               "preset_cfg2(1920, 1080).replace(rows_per_segment=1, "
               "ctx_inherit=True, mtt=True, lfnst=True)", "mixed"),
    # CCLM (I pictures): config 2 + CCLM on 'mixed' with its chroma made
    # from the luma (luma_chroma), so that both chroma models win CUs
    "cfg2c": (lambda: preset_cfg2(W, H).replace(
        rows_per_segment=1, ctx_inherit=True, cclm=True),
              "preset_cfg2(1920, 1080).replace(rows_per_segment=1, "
              "ctx_inherit=True, cclm=True)", "mixed", True),
}


def slice_nal_md5s(stream: bytes) -> list[str]:
    return [hashlib.md5(write_nal(t, rbsp)).hexdigest()
            for t, rbsp in split_nals(stream)
            if t in (NalType.IDR, NalType.TRAIL)]


def make(name: str) -> None:
    make_cfg, cfg_text, kind, *lc = REFS[name]
    cfg = make_cfg()
    frames = synthetic_clip(W, H, N, kind)
    clip = f"synthetic_clip(1920, 1080, 4, '{kind}')"
    if lc and lc[0]:
        frames = luma_chroma(frames)
        clip = f"luma_chroma({clip})"
    t0 = time.time()
    res = Encoder(cfg, with_recon=True).encode(frames)
    secs = time.time() - t0
    _, dec = Decoder().decode(res.bitstream)
    assert [frame_md5(d) for d in dec] == [frame_md5(r)
                                           for r in res.recon]
    out = {
        "source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
        "config": cfg_text,
        "clip": clip,
        "stream_md5": hashlib.md5(res.bitstream).hexdigest(),
        "frames": [
            {"poc": i, "bits": int(b), "psnr_y": float(p),
             "sse": [float(v) for v in np.asarray(e)[:3]],
             "nal_md5": n, "recon_md5": frame_md5(r)}
            for i, (b, p, e, n, r) in enumerate(zip(
                res.frame_bits, res.psnr_y(W, H), res.sse,
                slice_nal_md5s(res.bitstream), res.recon))],
    }
    path = os.path.join(DATA, f"{name}_1080p_ref.json")
    os.makedirs(DATA, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["frames"]))
    print(f"wrote {path} ({secs:.0f} s to encode)")


# the small low-delay clip: config-3 shaped at 128x64, IDR every 4 frames
P128_BASE = dict(width=128, height=64, qp=32, intra_period=4, rdoq=True,
                 ref_substitute=True)
P128_TOOLS = {"plain": {},
              "merge-amvp-rpl": dict(merge_cands=True, amvp=True, rpl=True)}


def make_p128() -> None:
    frames = synthetic_clip(128, 64, 5, "motion", seed=3)
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "clip": "synthetic_clip(128, 64, 5, 'motion', seed=3)",
           "base": P128_BASE, "variants": {}}
    for name, tools in P128_TOOLS.items():
        res = Encoder(CodecConfig(**P128_BASE, **tools),
                      with_recon=True).encode(frames)
        _, dec = Decoder().decode(res.bitstream)
        out["variants"][name] = {
            "tools": tools,
            "stream_b64": base64.b64encode(res.bitstream).decode(),
            "frame_bits": [int(b) for b in res.frame_bits],
            "psnr_y": [float(p) for p in res.psnr_y(128, 64)],
            "recon_md5": [frame_md5(r) for r in res.recon],
            "decode_md5": [frame_md5(d) for d in dec]}
    path = os.path.join(DATA, "p128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


# the small all-intra clips: cfg2t's tools on 'text' (t128x64) and
# config 2 on 'mixed' (c128x64) at 128x64
T128_CONFIG = ("preset_cfg2(128, 64).replace(pdpc=True, mip=True, "
               "transform_skip=True, rows_per_segment=1, ctx_inherit=True)")
T128_CLIP = "synthetic_clip(128, 64, 2, 'text', seed=5)"
C128_CONFIG = ("preset_cfg2(128, 64).replace(rows_per_segment=1, "
               "ctx_inherit=True)")
C128_CLIP = "synthetic_clip(128, 64, 3, 'mixed', seed=5)"
AI128 = {   # name -> (config, its text, clip kind, frames, its text)
    "t128x64": (lambda: preset_cfg2(128, 64).replace(
        pdpc=True, mip=True, transform_skip=True, rows_per_segment=1,
        ctx_inherit=True), T128_CONFIG, "text", 2, T128_CLIP),
    "c128x64": (lambda: preset_cfg2(128, 64).replace(
        rows_per_segment=1, ctx_inherit=True), C128_CONFIG, "mixed", 3,
                C128_CLIP),
}


def make_ai128(name: str) -> None:
    make_cfg, cfg_text, kind, n, clip_text = AI128[name]
    res = Encoder(make_cfg(), with_recon=True).encode(
        synthetic_clip(128, 64, n, kind, seed=5))
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": cfg_text, "clip": clip_text,
           "stream_b64": base64.b64encode(res.bitstream).decode(),
           "frame_bits": [int(b) for b in res.frame_bits],
           "sse": [[float(v) for v in np.asarray(e)[:3]] for e in res.sse],
           "psnr_y": [float(p) for p in res.psnr_y(128, 64)],
           "recon_md5": [frame_md5(r) for r in res.recon]}
    path = os.path.join(DATA, f"{name}_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


# random access with the loop filters: the JAX encoder's whole stream and
# per-frame results in display order, and the JAX decoder's MD5s
NOALF = dict(alf=False, alf_chroma=False)
# with MTS: the reference's plain inter scan codes transform skip only
# beside MTS (x266_tpu/engine/inter.py:805-807 hands its chroma TUs no
# transform index without MTS, which fails under transform skip)
TOOLS_RA = dict(profile=Profile.VVC, mts=True, pdpc=True, mip=True,
                transform_skip=True)
LOSSLESS_RA = dict(lossless=True, rdoq=False, deblock=False, sao=False,
                   sao_chroma=False, **NOALF)
RA_REFS = {   # name -> ((w, h, frames), tools, clip, file)
    "cfg4": ((416, 240, 17), {}, "mixed", "cfg4_416x240_ref.json"),
    "cfg4noalf": ((416, 240, 17), NOALF, "mixed",
                  "cfg4noalf_416x240_ref.json"),
    "cfg4noalf_1080p": ((1920, 1080, 17), NOALF, "mixed",
                        "cfg4noalf_1080p_ref.json"),
    "cfg4_4k": ((3840, 2160, 17), {}, "mixed", "cfg4_4k_ref.json"),
    # VVC's intra tools on P and B pictures: 'motion', whose B pictures
    # pick MIP and PDPC-class intra CUs ('mixed' B pictures pick no MIP)
    "tools_ra": ((1920, 1080, 17), TOOLS_RA, "motion",
                 "tools_ra_1080p_ref.json"),
    # a lossless user runs no loop filter
    "lossless_ra": ((416, 240, 17), LOSSLESS_RA, "mixed",
                    "lossless_ra_416x240_ref.json"),
    # sign-data hiding, then dependent quantization (they exclude each
    # other) on I, P and B pictures
    "ra_sdh": ((416, 240, 17), dict(sign_data_hiding=True), "motion",
               "ra_sdh_416x240_ref.json"),
    "ra_dq": ((416, 240, 17), dict(profile=Profile.VVC, dep_quant=True),
              "motion", "ra_dq_416x240_ref.json"),
}
RA128_VARIANTS = {"full": {}, "noalf": NOALF,
                  "lumaalf": dict(alf_chroma=False)}
RA128_GOP = dict(gop_size=4, intra_period=8)


def _log_slice_nals(partial: str):
    """Wrap the JAX encoder's NAL writer so that each slice NAL's MD5
    and the seconds since the start reach ``partial`` as it is written
    (coding order): a long encode that is cut still leaves the pictures
    it reached."""
    import x266_tpu.api.encoder as enc_mod
    write, t0, done = enc_mod.write_nal, time.time(), []

    def logged(t, rbsp):
        nal = write(t, rbsp)
        if t in (NalType.IDR, NalType.TRAIL):
            done.append({"nal_md5": hashlib.md5(nal).hexdigest(),
                         "bytes": len(nal),
                         "seconds": round(time.time() - t0, 1)})
            with open(partial, "w") as f:
                json.dump({"slice_nals_coding_order": done}, f, indent=1)
            print(f"slice NAL {len(done)}: {done[-1]}", flush=True)
        return nal
    enc_mod.write_nal = logged
    return lambda: setattr(enc_mod, "write_nal", write)


def _ra_record(cfg, frames, partial: str | None = None) -> dict:
    w, h = cfg.width, cfg.height
    restore = _log_slice_nals(partial) if partial else (lambda: None)
    t0 = time.time()
    try:
        res = Encoder(cfg, with_recon=True).encode(frames)
    finally:
        restore()
    secs = time.time() - t0
    _, dec = Decoder().decode(res.bitstream)
    return {"seconds": secs,
            "stream_b64": base64.b64encode(res.bitstream).decode(),
            "stream_md5": hashlib.md5(res.bitstream).hexdigest(),
            "nal_md5_coding_order": slice_nal_md5s(res.bitstream),
            "frames": [{"poc": i, "bits": int(b), "psnr_y": float(p),
                        "sse": [float(v) for v in np.asarray(e)[:3]],
                        "recon_md5": frame_md5(r), "decode_md5": frame_md5(d)}
                       for i, (b, p, e, r, d) in enumerate(zip(
                           res.frame_bits, res.psnr_y(w, h), res.sse,
                           res.recon, dec))]}


def make_ra(name: str) -> None:
    (w, h, n), tools, kind, fname = RA_REFS[name]
    cfg = preset_cfg4(w, h).replace(**tools)
    path = os.path.join(DATA, fname)
    partial = path.replace(".json", ".partial.json")
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": f"preset_cfg4({w}, {h}).replace(**{tools})",
           "clip": f"synthetic_clip({w}, {h}, {n}, '{kind}')",
           **_ra_record(cfg, synthetic_clip(w, h, n, kind), partial)}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    os.remove(partial)
    print(json.dumps(out["frames"]))
    print(f"wrote {path} ({out['seconds']:.0f} s to encode)")


def make_ra128() -> None:
    frames = synthetic_clip(128, 64, 5, "mixed", seed=4)
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": "preset_cfg4(128, 64).replace(**gop, **tools)",
           "clip": "synthetic_clip(128, 64, 5, 'mixed', seed=4)",
           "gop": RA128_GOP, "variants": {}}
    for name, tools in RA128_VARIANTS.items():
        cfg = preset_cfg4(128, 64).replace(**RA128_GOP, **tools)
        out["variants"][name] = {"tools": tools,
                                 **_ra_record(cfg, frames)}
    path = os.path.join(DATA, "ra128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


# the four intra tools on P and B pictures at 128x64, for the CPU tests:
# lossless low-delay P (I P P P I), lossless random access (GOP 4) and
# VVC's PDPC, MIP and transform skip under random access
TOOLS128 = {   # name -> (config text, tools, clip kind, seed)
    "lossless_p": ("preset_cfg3(128, 64).replace(intra_period=4, "
                   "lossless=True, rdoq=False)", None, "motion", 3),
    "lossless_ra": ("preset_cfg4(128, 64).replace(**gop, **tools)",
                    LOSSLESS_RA, "mixed", 4),
    "tools_ra": ("preset_cfg4(128, 64).replace(**gop, **tools)",
                 TOOLS_RA, "motion", 3),
}


def tools128_config(name: str):
    _, tools, _, _ = TOOLS128[name]
    if tools is None:
        return preset_cfg3(128, 64).replace(intra_period=4, lossless=True,
                                            rdoq=False)
    return preset_cfg4(128, 64).replace(**RA128_GOP, **tools)


def make_tools128() -> None:
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "gop": RA128_GOP, "variants": {}}
    for name, (text, tools, kind, seed) in TOOLS128.items():
        out["variants"][name] = {
            "config": text, "tools": {k: int(v) for k, v in
                                      (tools or {}).items()},
            "clip": f"synthetic_clip(128, 64, 5, '{kind}', seed={seed})",
            **_ra_record(tools128_config(name),
                         synthetic_clip(128, 64, 5, kind, seed=seed))}
    path = os.path.join(DATA, "tools128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


# config 5's single-device form at a small size of two CTU rows: 17
# frames cross its intra period of 16 (I, 15 P, I)
CFG5_CONFIG = "preset_cfg5(112, 80)"
CFG5_CLIP = "synthetic_clip(112, 80, 17, 'motion', seed=3)"


def make_cfg5() -> None:
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": CFG5_CONFIG, "clip": CFG5_CLIP,
           **_ra_record(preset_cfg5(112, 80),
                        synthetic_clip(112, 80, 17, "motion", seed=3))}
    path = os.path.join(DATA, "cfg5_112x80_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["frames"]))
    print(f"wrote {path} ({out['seconds']:.0f} s to encode)")


def fade(frames, g0=1.0, g1=0.5):
    """A linear luma gain ramp over the clip, from g0 on its first frame
    to g1 on its last (tests/test_weighted_pred.py's _fade with offset
    0); chroma is kept."""
    out = []
    n = len(frames)
    for i, f in enumerate(frames):
        g = g0 + (g1 - g0) * i / max(n - 1, 1)
        y = np.clip(f.y.astype(np.float64) * g, 0, 255)
        out.append(Frame(y.astype(np.uint8), f.cb, f.cr))
    return out


def slice_headers(cfg, stream: bytes) -> list:
    """Each slice header of the stream, in coding order."""
    from x266_tpu.core.headers import parse_slice_header

    return [parse_slice_header(
        rbsp, cfg.alf, cfg.ctus_y * cfg.ctus_x, cfg.alf_chroma,
        cfg.alf_nonlinear, cfg.ccalf, has_wp=cfg.weighted_pred,
        has_rpl=cfg.rpl)[0]
        for t, rbsp in split_nals(stream) if t in (NalType.IDR,
                                                   NalType.TRAIL)]


def slice_wps(cfg, stream: bytes) -> list:
    """Each slice header's (POC, type, weights), in coding order."""
    return [[sh.poc, sh.slice_type.name, sh.wp]
            for sh in slice_headers(cfg, stream)]


# GPB with signalled lists and weighted prediction at 1080p: five frames
# give I, P and B pictures on a DPB of two, three and four entries
GPB_WP_CONFIG = ("preset_cfg3(1920, 1080).replace(multi_ref=True, rpl=True, "
                 "weighted_pred=True)")
GPB_WP_CLIP = "fade(synthetic_clip(1920, 1080, 5, 'motion'), g0=1.0, g1=0.5)"


def make_gpb_wp() -> None:
    cfg = preset_cfg3(W, H).replace(multi_ref=True, rpl=True,
                                    weighted_pred=True)
    path = os.path.join(DATA, "gpb_wp_1080p_ref.json")
    partial = path.replace(".json", ".partial.json")
    rec = _ra_record(cfg, fade(synthetic_clip(W, H, 5, "motion")), partial)
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": GPB_WP_CONFIG, "clip": GPB_WP_CLIP,
           "slice_wp": slice_wps(cfg, base64.b64decode(rec["stream_b64"])),
           **rec}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    os.remove(partial)
    print(json.dumps(out["frames"]))
    print(f"wrote {path} ({out['seconds']:.0f} s to encode)")


# the 128x64 weighted-prediction and GPB variants for the CPU tests, on
# one faded clip of 6 frames (GPB: I, P, then B pictures until the
# 4-entry DPB has evicted its first picture)
WP128_CLIP = "fade(synthetic_clip(128, 64, 6, 'motion', seed=3), g0=1.0, g1=0.5)"
WP128_VARIANTS = {   # name -> (preset, its replace() arguments)
    "gpb": ("preset_cfg3", dict(intra_period=16, multi_ref=True)),
    "gpb_rpl_wp": ("preset_cfg3", dict(intra_period=16, multi_ref=True,
                                       rpl=True, weighted_pred=True)),
    "p_wp": ("preset_cfg3", dict(intra_period=4, weighted_pred=True)),
    "ra_wp": ("preset_cfg4", dict(gop_size=4, intra_period=8,
                                  weighted_pred=True)),
}


def make_wp128() -> None:
    frames = fade(synthetic_clip(128, 64, 6, "motion", seed=3))
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": "<preset>(128, 64).replace(**tools)",
           "clip": WP128_CLIP, "variants": {}}
    presets = {"preset_cfg3": preset_cfg3, "preset_cfg4": preset_cfg4}
    for name, (preset, tools) in WP128_VARIANTS.items():
        cfg = presets[preset](128, 64).replace(**tools)
        rec = _ra_record(cfg, frames)
        out["variants"][name] = {
            "preset": preset, "tools": tools,
            "slice_wp": slice_wps(cfg, base64.b64decode(rec["stream_b64"])),
            **rec}
    path = os.path.join(DATA, "wp128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


# nonlinear ALF (per-class clip levels, transposes, chroma clip levels)
# and CC-ALF under random access.  The synthetic clips' chroma is a
# gradient that owes nothing to the luma, so CC-ALF's whole-filter gate
# (x266_tpu/kernels/alf.py:558-561) keeps no CTB on ('mixed' and 'motion'
# at 1080p, every kind at 128x64); luma_chroma (x266_tpu_torch/utils/
# clips.py) derives the chroma from the luma, as camera content's is, and
# CC-ALF turns on.
NL_TOOLS = dict(alf_nonlinear=True, ccalf=True)
RA_NL_CONFIG = ("preset_cfg4(1920, 1080).replace(alf_nonlinear=True, "
                "ccalf=True)")
RA_NL_CLIP = "luma_chroma(synthetic_clip(1920, 1080, 17, 'motion'))"
RA_NL128_CONFIG = ("preset_cfg4(128, 64).replace(gop_size=4, intra_period=8, "
                   "alf_nonlinear=True, ccalf=True)")
RA_NL128_CLIP = "luma_chroma(synthetic_clip(128, 64, 5, 'motion', seed=3))"


def nl_counts(cfg, stream: bytes) -> list:
    """Per slice (coding order): [POC, luma classes whose clip index is
    not 0, chroma planes whose clip level is not 0, CTBs with CC-ALF on
    (both planes)]."""
    return [[sh.poc, sum(c != 0 for c in sh.alf_clips),
             sum(c != 0 for c in sh.alf_cclips), sum(sh.ccalf_flags)]
            for sh in slice_headers(cfg, stream)]


def make_ra_nl() -> None:
    cfg = preset_cfg4(W, H).replace(**NL_TOOLS)
    path = os.path.join(DATA, "ra_nl_1080p_ref.json")
    partial = path.replace(".json", ".partial.json")
    rec = _ra_record(cfg, luma_chroma(synthetic_clip(W, H, 17, "motion")),
                     partial)
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": RA_NL_CONFIG, "clip": RA_NL_CLIP,
           "nl_counts": nl_counts(cfg, base64.b64decode(rec["stream_b64"])),
           **rec}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    os.remove(partial)
    print(json.dumps(out["nl_counts"]))
    print(f"wrote {path} ({out['seconds']:.0f} s to encode)")


def make_ra_nl128() -> None:
    cfg = preset_cfg4(128, 64).replace(**RA128_GOP, **NL_TOOLS)
    rec = _ra_record(cfg, luma_chroma(synthetic_clip(128, 64, 5, "motion",
                                                     seed=3)))
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": RA_NL128_CONFIG, "clip": RA_NL128_CLIP,
           "nl_counts": nl_counts(cfg, base64.b64decode(rec["stream_b64"])),
           **rec}
    path = os.path.join(DATA, "ra_nl128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["nl_counts"]))
    print(f"wrote {path} ({out['seconds']:.0f} s to encode)")


# rate control: the target is half of the fixed-QP run's bits per frame
RC_CONFIG = "preset_cfg3(1920, 1080)"
RC_CLIP = "synthetic_clip(1920, 1080, 8, 'motion')"
RC128_CLIPS = {   # name -> (config text, clip kind, frames)
    "p": ("preset_cfg3(128, 64).replace(intra_period=4)", "motion", 6),
    "ai": ("preset_cfg2(128, 64)", "mixed", 4),
}
RC128_KBPS = {"p": 43.0, "ai": 22.0}    # at 30 fps: half the fixed-QP rate


def rc128_config(name: str):
    return (preset_cfg3(128, 64).replace(intra_period=4) if name == "p"
            else preset_cfg2(128, 64))


def rc_controller(kind: str, cfg, kbps: float, fps: float, n: int):
    """make_controller (kind "pi") or make_lambda_controller ("lambda",
    over a window of the clip's n frames)."""
    from x266_tpu.utils import ratecontrol

    if kind == "pi":
        return ratecontrol.make_controller(cfg, kbps, fps)
    return ratecontrol.make_lambda_controller(cfg, kbps, fps, n_frames=n)


def _rc_record(cfg, frames, kind: str, kbps: float) -> dict:
    w, h = cfg.width, cfg.height
    rc = rc_controller(kind, cfg, kbps, 30.0, len(frames))
    t0 = time.time()
    res = Encoder(cfg, with_recon=True, rate_control=rc).encode(frames)
    secs = time.time() - t0
    _, dec = Decoder().decode(res.bitstream)
    qps = [sh.qp for sh in slice_headers(cfg, res.bitstream)]
    assert len(set(qps)) >= 2, qps
    return {"controller": {"kind": kind, "bitrate_kbps": kbps, "fps": 30.0,
                           "n_frames": len(frames)},
            "seconds": secs, "qp": qps,
            "stream_b64": base64.b64encode(res.bitstream).decode(),
            "stream_md5": hashlib.md5(res.bitstream).hexdigest(),
            "nal_md5_coding_order": slice_nal_md5s(res.bitstream),
            "frames": [{"poc": i, "bits": int(b), "psnr_y": float(p),
                        "sse": [float(v) for v in np.asarray(e)[:3]],
                        "recon_md5": frame_md5(r), "decode_md5": frame_md5(d)}
                       for i, (b, p, e, r, d) in enumerate(zip(
                           res.frame_bits, res.psnr_y(w, h), res.sse,
                           res.recon, dec))]}


def make_rc() -> None:
    with open(os.path.join(DATA, "cfg3_1080p_ref.json")) as f:
        bits = [r["bits"] for r in json.load(f)["frames"]]
    kbps = 0.5 * float(np.mean(bits)) * 30.0 / 1000.0
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": RC_CONFIG, "clip": RC_CLIP,
           "target": "half of data/cfg3_1080p_ref.json's bits per frame, "
                     "at 30 fps",
           **_rc_record(preset_cfg3(W, H), synthetic_clip(W, H, 8, "motion"),
                        "lambda", kbps)}
    path = os.path.join(DATA, "rc_1080p_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(out["qp"], json.dumps(out["frames"]))
    print(f"wrote {path} ({out['seconds']:.0f} s to encode)")


def make_rc128() -> None:
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "variants": {}}
    for name, (text, kind, n) in RC128_CLIPS.items():
        for ctl in ("pi", "lambda"):
            out["variants"][f"{name}_{ctl}"] = {
                "config": text,
                "clip": f"synthetic_clip(128, 64, {n}, '{kind}', seed=3)",
                **_rc_record(rc128_config(name),
                             synthetic_clip(128, 64, n, kind, seed=3), ctl,
                             RC128_KBPS[name])}
            print(name, ctl, out["variants"][f"{name}_{ctl}"]["qp"])
    path = os.path.join(DATA, "rc128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


# sign-data hiding and dependent quantization at 128x64 for the CPU
# tests: all-intra (screen content with transform skip; DQ under
# transform skip without RDOQ, so at the default lambda), low-delay P
# without RDOQ and random access (GOP 4: I, P, B) with each flag
SDHDQ128 = {   # name -> (config text, clip kind, frames)
    "ai_sdh": ("preset_cfg2s(128, 64)", "text", 2),
    "ai_dq_ts": ("preset_cfg2(128, 64).replace(dep_quant=True, "
                 "transform_skip=True, rdoq=False)", "text", 2),
    "p_sdh": ("preset_cfg3(128, 64).replace(intra_period=4, "
              "sign_data_hiding=True, rdoq=False)", "motion", 5),
    "ra_sdh": ("preset_cfg4(128, 64).replace(**gop, sign_data_hiding=True)",
               "motion", 5),
    "ra_dq": ("preset_cfg4(128, 64).replace(**gop, profile=Profile.VVC, "
              "dep_quant=True)", "motion", 5),
}


def sdhdq128_config(name: str):
    if name == "ai_sdh":
        return preset_cfg2s(128, 64)
    if name == "ai_dq_ts":
        return preset_cfg2(128, 64).replace(dep_quant=True,
                                            transform_skip=True, rdoq=False)
    if name == "p_sdh":
        return preset_cfg3(128, 64).replace(intra_period=4,
                                            sign_data_hiding=True,
                                            rdoq=False)
    if name == "ra_sdh":
        return preset_cfg4(128, 64).replace(**RA128_GOP,
                                            sign_data_hiding=True)
    return preset_cfg4(128, 64).replace(**RA128_GOP, profile=Profile.VVC,
                                        dep_quant=True)


def make_sdhdq128() -> None:
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "gop": RA128_GOP, "variants": {}}
    for name, (text, kind, n) in SDHDQ128.items():
        out["variants"][name] = {
            "config": text,
            "clip": f"synthetic_clip(128, 64, {n}, '{kind}', seed=3)",
            **_ra_record(sdhdq128_config(name),
                         synthetic_clip(128, 64, n, kind, seed=3))}
        print(name, out["variants"][name]["nal_md5_coding_order"],
              flush=True)
    path = os.path.join(DATA, "sdhdq128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


# MTT and LFNST at 128x64 for the CPU tests: config 2 with both on 'text'
# (BT-H and BT-V leaves of 16 and 32, both LFNST kernels), the quality
# preset (MTT + SDH) and a low-delay clip with deblock (I then P
# pictures: the tools act on the I picture, deblock on its TU grid)
MTTLFNST128 = {   # name -> (config text, clip kind, frames, seed)
    "ai_text": ("preset_cfg2(128, 64).replace(mtt=True, lfnst=True)",
                "text", 2, 10),
    "ai_q": ("preset_cfg2q(128, 64)", "mixed", 1, 2),
    "ld": ("preset_cfg3(128, 64).replace(profile=Profile.VVC, mtt=True, "
           "lfnst=True, deblock=True, intra_period=4)", "motion", 3, 4),
}


def mttlfnst128_config(name: str):
    if name == "ai_text":
        return preset_cfg2(128, 64).replace(mtt=True, lfnst=True)
    if name == "ai_q":
        return preset_cfg2q(128, 64)
    return preset_cfg3(128, 64).replace(profile=Profile.VVC, mtt=True,
                                        lfnst=True, deblock=True,
                                        intra_period=4)


def make_mttlfnst128() -> None:
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "variants": {}}
    for name, (text, kind, n, seed) in MTTLFNST128.items():
        out["variants"][name] = {
            "config": text,
            "clip": f"synthetic_clip(128, 64, {n}, '{kind}', seed={seed})",
            **_ra_record(mttlfnst128_config(name),
                         synthetic_clip(128, 64, n, kind, seed=seed))}
        print(name, out["variants"][name]["nal_md5_coding_order"],
              flush=True)
    path = os.path.join(DATA, "mttlfnst128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


# CCLM at 128x64 for the CPU tests, each clip's chroma made from its luma
# (luma_chroma): CCLM alone; with MTS, transform skip, PDPC, MIP and
# substitution; with LFNST and DQ; with SDH; lossless; a low-delay I + P
# clip with deblock; random access with GOP 4.  Under LFNST the
# reference's encoder drops the LFNST index (mts bits 6-7) from the map
# it codes (x266_tpu/engine/recon.py:382-391), so that stream's decode
# differs from the encoder's recon; both are recorded.
CCLM128 = {   # name -> (config text, clip kind, frames, seed)
    "ai": ("preset_cfg2(128, 64).replace(cclm=True)", "mixed", 2, 5),
    "tools": ("preset_cfg2(128, 64).replace(cclm=True, transform_skip=True, "
              "pdpc=True, mip=True)", "text", 2, 3),
    "lfnst_dq": ("preset_cfg2(128, 64).replace(cclm=True, lfnst=True, "
                 "dep_quant=True)", "mixed", 1, 4),
    "sdh": ("preset_cfg2s(128, 64).replace(cclm=True)", "text", 1, 2),
    "lossless": ("CodecConfig(width=128, height=64, qp=32, "
                 "profile=Profile.VVC, lossless=True, rdoq=False, "
                 "cclm=True)", "mixed", 1, 6),
    "ld": ("preset_cfg3(128, 64).replace(profile=Profile.VVC, cclm=True, "
           "deblock=True, intra_period=4)", "motion", 3, 4),
    "ra": ("preset_cfg4(128, 64).replace(profile=Profile.VVC, cclm=True, "
           "gop_size=4, intra_period=8)", "mixed", 5, 4),
}


def cclm128_config(name: str):
    return eval(CCLM128[name][0])


def make_cclm128() -> None:
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "variants": {}}
    for name, (text, kind, n, seed) in CCLM128.items():
        out["variants"][name] = {
            "config": text,
            "clip": f"luma_chroma(synthetic_clip(128, 64, {n}, '{kind}', "
                    f"seed={seed}))",
            **_ra_record(cclm128_config(name), luma_chroma(
                synthetic_clip(128, 64, n, kind, seed=seed)))}
        print(name, out["variants"][name]["nal_md5_coding_order"],
              flush=True)
    path = os.path.join(DATA, "cclm128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


# the command line on the card (chip_smoke.py [cli]): the JAX package's
# own CLI on a 416x240 raw clip with CCLM, low-delay with the loop filters
CLI416_FLAGS = ["-s", "416x240", "--profile", "vvc", "--cclm", "--mts",
                "--rdoq", "--ref-subst", "--deblock", "--sao", "--gop", "4"]
CLI416_CLIP = "luma_chroma(synthetic_clip(416, 240, 4, 'mixed', seed=7))"


def make_cli416() -> None:
    import contextlib
    import io
    import tempfile

    from x266_tpu.cli.main import main as cli_main
    from x266_tpu.core.yuv import write_yuv420

    frames = luma_chroma(synthetic_clip(416, 240, 4, "mixed", seed=7))
    with tempfile.TemporaryDirectory() as tmp:
        yuv, bit = os.path.join(tmp, "in.yuv"), os.path.join(tmp, "out.266t")
        write_yuv420(yuv, frames)
        t0 = time.time()
        assert cli_main(["encode", "-i", yuv, "-o", bit,
                         *CLI416_FLAGS]) == 0
        secs = time.time() - t0
        with open(bit, "rb") as f:
            stream = f.read()
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines):
            assert cli_main(["decode", "-i", bit, "-o",
                             os.path.join(tmp, "dec.yuv")]) == 0
        md5_lines = [ln for ln in lines.getvalue().splitlines()
                     if ln.startswith("POC")]
    out = {"source": "x266_tpu.cli (JAX, CPU backend), "
                     "tools/make_torch_refs.py",
           "flags": CLI416_FLAGS, "clip": CLI416_CLIP, "seconds": secs,
           "stream_md5": hashlib.md5(stream).hexdigest(),
           "bytes": len(stream), "decode_lines": md5_lines}
    path = os.path.join(DATA, "cli416x240_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    print(f"wrote {path}")


def main() -> None:
    makers = {"p128x64": make_p128, "cfg5": make_cfg5,
              "gpb_wp": make_gpb_wp, "wp128x64": make_wp128,
              "ra_nl_1080p": make_ra_nl, "ra_nl128x64": make_ra_nl128,
              "rc_1080p": make_rc, "rc128x64": make_rc128,
              "sdhdq128x64": make_sdhdq128,
              "mttlfnst128x64": make_mttlfnst128,
              "cclm128x64": make_cclm128, "cli416x240": make_cli416,
              **{k: (lambda k=k: make_ai128(k)) for k in AI128},
              "ra128x64": make_ra128, "tools128x64": make_tools128,
              **{k: (lambda k=k: make(k)) for k in REFS},
              **{k: (lambda k=k: make_ra(k)) for k in RA_REFS}}
    for name in sys.argv[1:] or [*REFS, "p128x64", "t128x64", "cfg4",
                                 "cfg4noalf", "ra128x64"]:
        makers[name]()


if __name__ == "__main__":
    main()
