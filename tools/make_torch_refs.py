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
- t128x64: the JAX encoder's whole stream, recon MD5s, SSE and PSNR of
  a 2-frame 128x64 cfg2t clip ('text') -> data/t128x64_ref.json, which
  tests/test_torch_pipeline.py holds the port to (the JAX encode would
  compile for ~20 s in the test; the test decodes the port's stream with
  the JAX decoder live);
- ra128x64: the same for a 5-frame 128x64 random-access clip (GOP 4:
  I, P, then B pictures at POC 2, 1, 3) with ALF ("full"), without it
  ("noalf") and with luma ALF only ("lumaalf") -> data/ra128x64_ref.json,
  for the CPU tests.

    python tools/make_torch_refs.py [cfg2] [cfg3] [cfg2t] [lossless]
        [p128x64] [t128x64] [cfg4] [cfg4noalf] [ra128x64]
        [cfg4noalf_1080p]
    # default: all but cfg4noalf_1080p; minutes per 1080p frame, about
    # two minutes for each 416x240 RA clip and for ra128x64
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
from x266_tpu.config import (CodecConfig, preset_cfg2, preset_cfg3,  # noqa
                             preset_cfg4)
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


# the small all-intra clip with VVC's intra tools (cfg2t at 128x64)
T128_CONFIG = ("preset_cfg2(128, 64).replace(pdpc=True, mip=True, "
               "transform_skip=True, rows_per_segment=1, ctx_inherit=True)")
T128_CLIP = "synthetic_clip(128, 64, 2, 'text', seed=5)"


def make_t128() -> None:
    cfg = preset_cfg2(128, 64).replace(pdpc=True, mip=True,
                                       transform_skip=True,
                                       rows_per_segment=1, ctx_inherit=True)
    res = Encoder(cfg, with_recon=True).encode(
        synthetic_clip(128, 64, 2, "text", seed=5))
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": T128_CONFIG, "clip": T128_CLIP,
           "stream_b64": base64.b64encode(res.bitstream).decode(),
           "frame_bits": [int(b) for b in res.frame_bits],
           "sse": [[float(v) for v in np.asarray(e)[:3]] for e in res.sse],
           "psnr_y": [float(p) for p in res.psnr_y(128, 64)],
           "recon_md5": [frame_md5(r) for r in res.recon]}
    path = os.path.join(DATA, "t128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


# random access with the loop filters: the JAX encoder's whole stream and
# per-frame results in display order, and the JAX decoder's MD5s
NOALF = dict(alf=False, alf_chroma=False)
RA_REFS = {   # name -> ((w, h, frames), tools)
    "cfg4": ((416, 240, 17), {}),
    "cfg4noalf": ((416, 240, 17), NOALF),
    "cfg4noalf_1080p": ((1920, 1080, 17), NOALF),
}
RA128_VARIANTS = {"full": {}, "noalf": NOALF,
                  "lumaalf": dict(alf_chroma=False)}
RA128_GOP = dict(gop_size=4, intra_period=8)


def _ra_record(cfg, frames) -> dict:
    w, h = cfg.width, cfg.height
    t0 = time.time()
    res = Encoder(cfg, with_recon=True).encode(frames)
    secs = time.time() - t0
    _, dec = Decoder().decode(res.bitstream)
    return {"seconds": secs,
            "stream_b64": base64.b64encode(res.bitstream).decode(),
            "stream_md5": hashlib.md5(res.bitstream).hexdigest(),
            "nal_md5_coding_order": slice_nal_md5s(res.bitstream),
            "frames": [{"poc": i, "bits": int(b), "psnr_y": float(p),
                        "recon_md5": frame_md5(r), "decode_md5": frame_md5(d)}
                       for i, (b, p, r, d) in enumerate(zip(
                           res.frame_bits, res.psnr_y(w, h), res.recon,
                           dec))]}


def make_ra(name: str) -> None:
    (w, h, n), tools = RA_REFS[name]
    cfg = preset_cfg4(w, h).replace(**tools)
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
           "config": f"preset_cfg4({w}, {h}).replace(**{tools})",
           "clip": f"synthetic_clip({w}, {h}, {n}, 'mixed')",
           **_ra_record(cfg, synthetic_clip(w, h, n, "mixed"))}
    path = os.path.join(DATA, f"{name}_{w}x{h}_ref.json".replace(
        "_1080p_1920x1080", "_1080p"))
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
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


def main() -> None:
    makers = {"p128x64": make_p128, "t128x64": make_t128,
              "ra128x64": make_ra128,
              **{k: (lambda k=k: make(k)) for k in REFS},
              **{k: (lambda k=k: make_ra(k)) for k in RA_REFS}}
    for name in sys.argv[1:] or [*REFS, "p128x64", "t128x64", "cfg4",
                                 "cfg4noalf", "ra128x64"]:
        makers[name]()


if __name__ == "__main__":
    main()
