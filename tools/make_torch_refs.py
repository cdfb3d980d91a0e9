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
  data/cfg5_112x80_ref.json.

    python tools/make_torch_refs.py [cfg2] [cfg3] [cfg2t] [lossless]
        [p128x64] [t128x64] [c128x64] [cfg4] [cfg4noalf] [ra128x64]
        [cfg4noalf_1080p] [lossless_p] [tools_ra] [lossless_ra]
        [tools128x64] [cfg4_4k] [cfg5]
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
                             preset_cfg3, preset_cfg4, preset_cfg5)
from x266_tpu.core.hashing import frame_md5  # noqa: E402
from x266_tpu.core.nal import NalType, split_nals, write_nal  # noqa: E402
from x266_tpu.core.yuv import synthetic_clip  # noqa: E402

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
}


def slice_nal_md5s(stream: bytes) -> list[str]:
    return [hashlib.md5(write_nal(t, rbsp)).hexdigest()
            for t, rbsp in split_nals(stream)
            if t in (NalType.IDR, NalType.TRAIL)]


def make(name: str) -> None:
    make_cfg, cfg_text, kind = REFS[name]
    cfg = make_cfg()
    frames = synthetic_clip(W, H, N, kind)
    t0 = time.time()
    res = Encoder(cfg, with_recon=True).encode(frames)
    secs = time.time() - t0
    _, dec = Decoder().decode(res.bitstream)
    assert [frame_md5(d) for d in dec] == [frame_md5(r)
                                           for r in res.recon]
    out = {
        "source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
        "config": cfg_text,
        "clip": f"synthetic_clip(1920, 1080, 4, '{kind}')",
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


def main() -> None:
    makers = {"p128x64": make_p128, "cfg5": make_cfg5,
              **{k: (lambda k=k: make_ai128(k)) for k in AI128},
              "ra128x64": make_ra128, "tools128x64": make_tools128,
              **{k: (lambda k=k: make(k)) for k in REFS},
              **{k: (lambda k=k: make_ra(k)) for k in RA_REFS}}
    for name in sys.argv[1:] or [*REFS, "p128x64", "t128x64", "cfg4",
                                 "cfg4noalf", "ra128x64"]:
        makers[name]()


if __name__ == "__main__":
    main()
