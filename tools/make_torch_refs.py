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
- ra128x64: the same for a 5-frame 128x64 random-access clip (GOP 4:
  I, P, then B pictures at POC 2, 1, 3), with and without ALF ->
  data/ra128x64_ref.json, for the CPU tests;
- cfg4exact (and ra128x64's "exact" variant): the JAX encoder of config 4
  with one change, made for this run only: its ALF estimators sum their
  normal equations and per-CTB SSEs exactly and solve in float64 by the
  port's LDL^T elimination, as the port's do
  (``exact_alf_estimators``), where the reference sums and
  solves in float32 (ROADMAP queue 3, F9) ->
  data/cfg4exact_416x240_ref.json.  With ALF the port is held to these
  streams byte for byte, and to the reference's own within the F9 rule.

    python tools/make_torch_refs.py [cfg2] [cfg3] [p128x64] [cfg4]
        [cfg4noalf] [cfg4exact] [ra128x64] [cfg4noalf_1080p]
    # default: all but cfg4noalf_1080p; minutes per 1080p frame, about
    # two minutes for each 416x240 RA clip and for ra128x64
"""
import base64
import contextlib
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
             "nal_md5": n, "recon_md5": frame_md5(r)}
            for i, (b, p, n, r) in enumerate(zip(
                res.frame_bits, res.psnr_y(W, H),
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


# random access with the loop filters: the JAX encoder's whole stream and
# per-frame results in display order, and the JAX decoder's MD5s
NOALF = dict(alf=False, alf_chroma=False)
RA_REFS = {   # name -> ((w, h, frames), tools, exact ALF estimators)
    "cfg4": ((416, 240, 17), {}, False),
    "cfg4noalf": ((416, 240, 17), NOALF, False),
    "cfg4exact": ((416, 240, 17), {}, True),
    "cfg4noalf_1080p": ((1920, 1080, 17), NOALF, False),
}
RA128_VARIANTS = {"full": ({}, False), "noalf": (NOALF, False),
                  "exact": ({}, True)}
RA128_GOP = dict(gop_size=4, intra_period=8)


def _ldl_solve(a, b):
    """x of a x = b (a symmetric positive definite, float64) by the LDL^T
    elimination of x266_tpu_torch.kernels.alf.ldl_solve, written again
    here in numpy: the same sequence of elementwise ops, each rounded
    once, so the same bits."""
    n = a.shape[-1]
    a, y = a.copy(), b.copy()
    low = np.zeros_like(a)
    diag = np.zeros_like(b)
    for k in range(n):
        diag[..., k] = a[..., k, k]
        low[..., k + 1:, k] = a[..., k + 1:, k] / a[..., k, k, None]
        a[..., k + 1:, k + 1:] -= (low[..., k + 1:, k, None]
                                   * a[..., None, k + 1:, k])
    for k in range(n):
        y[..., k + 1:] -= low[..., k + 1:, k] * y[..., k, None]
    y = y / diag
    for k in reversed(range(n)):
        y[..., :k] -= low[..., k, :k] * y[..., k, None]
    return y


def _exact_alf_coeffs(feats, err, cls_px, n_classes):
    """Per-class normal equations of integer planes, summed exactly
    (float64 products of integers below 2^53), solved in float64 and
    rounded as the reference rounds."""
    from x266_tpu.kernels import alf as kalf

    t = feats.shape[0]
    f = np.asarray(feats, np.float64).reshape(t, -1)
    e = np.asarray(err, np.float64).reshape(-1)
    cls = np.asarray(cls_px).reshape(-1)
    gram = np.stack([f[:, cls == c] @ f[:, cls == c].T
                     for c in range(n_classes)])
    rhs = np.stack([f[:, cls == c] @ e[cls == c] for c in range(n_classes)])
    sol = _ldl_solve(gram + 64.0 * np.eye(t),
                          rhs * float(1 << kalf.COEF_BITS))
    return np.clip(np.round(sol), -kalf.COEF_MAX,
                   kalf.COEF_MAX).astype(np.int32)


def _exact_ctb_flags(filt, recon, orig, ctb, lam):
    """The reference's per-CTB decision with the SSEs summed in int32
    (at most 64 * 64 * 255^2 < 2^31 per CTB, so exact)."""
    h, w = orig.shape
    cy, cx = -(-h // ctb), -(-w // ctb)

    def sse(a):
        d = jnp.pad((a - orig) ** 2, ((0, cy * ctb - h), (0, cx * ctb - w)))
        return d.reshape(cy, ctb, cx, ctb).sum(axis=(1, 3))

    gain = (sse(filt) - sse(recon)).astype(jnp.float32)
    return (gain + lam * 1.5 < 0).astype(jnp.int32)


@contextlib.contextmanager
def exact_alf_estimators():
    """Within the block, x266_tpu's ``estimate_alf`` and
    ``estimate_alf_chroma`` sum exactly (host callbacks); everything else
    of the reference is unchanged.  The fused steps are cached per
    config, so the caches are emptied on the way in and out."""
    from x266_tpu.engine import fused
    from x266_tpu.kernels import alf as kalf

    def clear():
        for f in vars(fused).values():
            if hasattr(f, "cache_clear"):
                f.cache_clear()
        jax.clear_caches()

    def luma_coeffs(orig, recon):
        cls = np.asarray(kalf.classify(recon, np))
        return _exact_alf_coeffs(kalf._diff_planes(recon, np), orig - recon,
                                 np.repeat(np.repeat(cls, 4, 0), 4, 1),
                                 kalf.NUM_CLASSES)

    def chroma_coeffs(orig, recon):
        return _exact_alf_coeffs(kalf._diff_planes_chroma(recon, np),
                                 orig - recon, np.zeros(orig.shape), 1)[0]

    def estimate_alf(orig, recon, lam, bit_depth=8):
        orig, recon = (jnp.asarray(a, jnp.int32) for a in (orig, recon))
        h, w = orig.shape
        coeffs = jax.pure_callback(luma_coeffs, jax.ShapeDtypeStruct(
            (kalf.NUM_CLASSES, 12), jnp.int32), orig, recon)
        cls = kalf.classify(recon)
        all_on = jnp.ones(((h + 63) // 64, (w + 63) // 64), jnp.int32)
        filt = kalf.apply_alf(recon, cls, coeffs, all_on, bit_depth=bit_depth)
        flags = _exact_ctb_flags(filt, recon, orig, 64, lam)
        return coeffs, flags, kalf.apply_alf(recon, cls, coeffs, flags,
                                             bit_depth=bit_depth)

    def estimate_alf_chroma(orig, recon, lam, bit_depth=8):
        orig, recon = (jnp.asarray(a, jnp.int32) for a in (orig, recon))
        h, w = orig.shape
        coeffs = jax.pure_callback(chroma_coeffs, jax.ShapeDtypeStruct(
            (6,), jnp.int32), orig, recon)
        all_on = jnp.ones((-(-h // 32), -(-w // 32)), jnp.int32)
        filt = kalf.apply_alf_chroma(recon, coeffs, all_on,
                                     bit_depth=bit_depth)
        flags = _exact_ctb_flags(filt, recon, orig, 32, lam)
        return coeffs, flags, kalf.apply_alf_chroma(recon, coeffs, flags,
                                                    bit_depth=bit_depth)

    saved = kalf.estimate_alf, kalf.estimate_alf_chroma
    clear()
    kalf.estimate_alf, kalf.estimate_alf_chroma = (estimate_alf,
                                                   estimate_alf_chroma)
    try:
        yield
    finally:
        kalf.estimate_alf, kalf.estimate_alf_chroma = saved
        clear()


def _ra_record(cfg, frames, exact: bool) -> dict:
    w, h = cfg.width, cfg.height
    t0 = time.time()
    with exact_alf_estimators() if exact else contextlib.nullcontext():
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
    (w, h, n), tools, exact = RA_REFS[name]
    cfg = preset_cfg4(w, h).replace(**tools)
    out = {"source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py"
                     + (", exact ALF estimators" if exact else ""),
           "config": f"preset_cfg4({w}, {h}).replace(**{tools})",
           "clip": f"synthetic_clip({w}, {h}, {n}, 'mixed')",
           **_ra_record(cfg, synthetic_clip(w, h, n, "mixed"), exact)}
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
    for name, (tools, exact) in RA128_VARIANTS.items():
        cfg = preset_cfg4(128, 64).replace(**RA128_GOP, **tools)
        out["variants"][name] = {"tools": tools, "exact_alf": exact,
                                 **_ra_record(cfg, frames, exact)}
    path = os.path.join(DATA, "ra128x64_ref.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


def main() -> None:
    makers = {"p128x64": make_p128, "ra128x64": make_ra128,
              **{k: (lambda k=k: make(k)) for k in REFS},
              **{k: (lambda k=k: make_ra(k)) for k in RA_REFS}}
    for name in sys.argv[1:] or [*REFS, "p128x64", "cfg4", "cfg4noalf",
                                 "cfg4exact", "ra128x64"]:
        makers[name]()


if __name__ == "__main__":
    main()
