"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises, exit code non-zero):
 1. environment: torch / CUDA / nvcc versions, the card, TF32 flags off,
    the native entropy coder loaded;
 2. build: the CUDA kernels from x266_tpu_torch/csrc with nvcc;
 3. kernels K1 (encode) and K2 (decode) against the plain torch scan on
    the card, bit for bit, at 128x64 and 416x240 for a config-2 shaped
    VVC config and an HEVC config, and on the main path's frames and
    shapes (1920x1080, K1 on a batch of 4 frames, K2 on one at a time);
 4. golden stream: decode tests/fixtures/ai_hevc.266t to its manifest
    MD5 and re-encode its source to the identical bytes;
 5. main path: all-intra 1080p VVC (config 2) frames 0-3 through
    Encoder/Decoder(device="cuda"), held against the JAX reference in
    x266_tpu_torch/data/cfg2_1080p_ref.json; the kernels' launch counts
    of that run; one warm encode's frame rate.
The second line from the end is a JSON object with each kernel's
launches on the main path, its error and its times (one launch at the
main path's shapes, against the plain scan's on the same inputs); the
next is the card's name and power limit; the last line is the result.

Exits non-zero, printing no result, when no CUDA device is visible.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REF_JSON = os.path.join(ROOT, "x266_tpu_torch", "data",
                        "cfg2_1080p_ref.json")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
KERNELS = {
    "K1": ("recon_intra encode", "x266_tpu/engine/recon_pallas.py:943"),
    "K2": ("recon_intra decode", "x266_tpu/engine/recon_pallas.py:943"),
}
SOURCE = "x266_tpu_torch/csrc/recon_intra.cu"
BITS_TOL = 0.005          # relative, per frame
PSNR_TOL = 0.02           # dB, per frame (float32 SSE in the reference)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_environment():
    from x266_tpu.cabac import native_bind
    from x266_tpu_torch import _build, device

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[env] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"[env] device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log(f"[env] nvidia-smi: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device.check_precision()
    if not native_bind.available():
        raise RuntimeError("native entropy coder did not build or load")
    log("[env] TF32 off; native entropy coder loaded")


def phase_build():
    from x266_tpu_torch import _build

    t0 = time.perf_counter()
    _build.LIBRARY.build()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    for line in _build.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")


def _inputs(cfg, n, seed):
    """Padded planes and Pass-A maps of n synthetic frames, on the card."""
    from x266_tpu.core.yuv import synthetic_clip
    from x266_tpu_torch import tables
    from x266_tpu_torch.engine import fused

    tab = tables.from_reference(cfg, "cuda")
    frames = synthetic_clip(cfg.width, cfg.height, n, "mixed", seed=seed)
    planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
              .cuda() for p in ("y", "cb", "cr")]
    src = fused._unpack_padded(cfg, *planes)
    return tab, src, fused.make_pass_a(cfg, tab)(src[0])


def _max_err(got, ref) -> int:
    return max(int((g.int() - r.int()).abs().max()) for g, r in
               zip(got, ref))


def compare_kernels(cfg, n, seed, stats):
    """K1 and K2 against the plain scan on one input; bit-exact or raise.
    K1 runs on all n frames at once, as the encoder batches them; K2 on
    all n and on each frame alone, as the decoder calls it."""
    from x266_tpu_torch.engine import recon, recon_cuda

    tab, src, maps = _inputs(cfg, n, seed)
    plain_enc = recon.make_recon_pass_raw(cfg, tab, encode=True)
    plain_dec = recon.make_recon_pass_raw(cfg, tab, encode=False)
    got, k1_ms = timed(recon_cuda.recon_intra, cfg, tab, True, *src, *maps)
    ref, p1_ms = timed(plain_enc, *src, *maps)
    coefs = got[3:]
    pdec, p2_ms = timed(plain_dec, *coefs, *maps)
    dec = recon_cuda.recon_intra(cfg, tab, False, *coefs, *maps)
    err1 = _max_err(got, ref)
    err2 = max(_max_err(dec[:3], pdec[:3]), _max_err(dec[:3], got[:3]))
    k2_ms = []
    for f in range(n):
        one = [t[f:f + 1].contiguous() for t in (*coefs, *maps)]
        dec1, ms = timed(recon_cuda.recon_intra, cfg, tab, False, *one)
        k2_ms.append(ms)
        err2 = max(err2, _max_err(dec1[:3], [p[f:f + 1] for p in pdec[:3]]))
    k2_ms, p2_ms = sum(k2_ms) / n, p2_ms / n
    names = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr"]
    tag = f"{cfg.width}x{cfg.height}x{n} {cfg.profile.name}"
    log(f"[kernels] {tag}: K1 {k1_ms:.2f} ms for {n} frames (plain "
        f"{p1_ms:.0f} ms) max_abs_err {err1}; K2 {k2_ms:.2f} ms per frame "
        f"(plain {p2_ms:.0f} ms) max_abs_err {err2}")
    for n_, g, r in zip(names, got, ref):
        if not torch.equal(g, r):
            bad = (g != r).nonzero()[:5].tolist()
            raise AssertionError(f"K1 {tag} {n_} differs from the plain "
                                 f"scan at {bad}")
    if err2:
        raise AssertionError(f"K2 {tag} differs from the plain scan")
    shape = f"{cfg.width}x{cfg.height}"
    stats["K1"].update(max_abs_err=max(stats["K1"]["max_abs_err"], err1),
                       ms=k1_ms, plain_ms=p1_ms, shape=f"{shape}x{n}")
    stats["K2"].update(max_abs_err=max(stats["K2"]["max_abs_err"], err2),
                       ms=k2_ms, plain_ms=p2_ms, shape=f"{shape}x1")


def main_cfg():
    from x266_tpu.config import preset_cfg2

    return preset_cfg2(1920, 1080).replace(rows_per_segment=1,
                                           ctx_inherit=True)


def phase_kernels(stats):
    from x266_tpu.config import CodecConfig, preset_cfg2

    for w, h in ((128, 64), (416, 240)):
        compare_kernels(preset_cfg2(w, h), 2, 11, stats)
        compare_kernels(CodecConfig(width=w, height=h, qp=32, rdoq=True),
                        2, 12, stats)
    # the main path's frames and shapes: K1 on the encoder's batch of 4
    # frames, K2 on one frame at a time
    compare_kernels(main_cfg(), 4, 0, stats)


def phase_golden():
    from x266_tpu.config import CodecConfig
    from x266_tpu.core.hashing import frame_md5
    from x266_tpu.core.yuv import synthetic_clip
    from x266_tpu_torch.api import Decoder, Encoder

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        want = json.load(f)["ai_hevc"]["md5"]
    with open(os.path.join(FIXTURES, "ai_hevc.266t"), "rb") as f:
        stream = f.read()
    _, dec = Decoder(device="cuda").decode(stream)
    got = [frame_md5(d) for d in dec]
    log(f"[golden] ai_hevc decode md5 {got} manifest {want}")
    if got != want:
        raise AssertionError("ai_hevc decode MD5 differs from the manifest")
    cfg = CodecConfig(width=96, height=64, qp=32, rdoq=True)
    res = Encoder(cfg, device="cuda", with_recon=False).encode(
        synthetic_clip(96, 64, 1, "mixed", seed=77))
    same = res.bitstream == stream
    log(f"[golden] ai_hevc re-encode: {len(res.bitstream)} bytes, "
        f"byte-identical {same}")
    if not same:
        raise AssertionError("ai_hevc re-encode differs from the fixture")


def _slice_md5s(stream: bytes):
    from x266_tpu.core.nal import NalType, split_nals, write_nal

    return [hashlib.md5(write_nal(t, rbsp)).hexdigest()
            for t, rbsp in split_nals(stream)
            if t in (NalType.IDR, NalType.TRAIL)]


def phase_main(stats, card):
    from x266_tpu.core.hashing import frame_md5
    from x266_tpu.core.yuv import synthetic_clip
    from x266_tpu_torch.api import Decoder, Encoder
    from x266_tpu_torch.engine import recon_cuda

    with open(REF_JSON) as f:
        ref = json.load(f)["frames"]
    w, h, n = 1920, 1080, 4
    cfg = main_cfg()
    frames = synthetic_clip(w, h, n, "mixed")
    t0 = time.perf_counter()
    enc = Encoder(cfg, device="cuda", with_recon=True, batch_frames=4)
    dec = Decoder(device="cuda")
    log(f"[main] encoder/decoder set-up {time.perf_counter() - t0:.1f} s")

    recon_cuda.reset_launches()
    t0 = time.perf_counter()
    res = enc.encode(frames)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, decoded = dec.decode(res.bitstream)
    t_dec = time.perf_counter() - t0
    launches = dict(recon_cuda.LAUNCHES)
    log(f"[main] first encode {t_enc:.2f} s, decode {t_dec:.2f} s, "
        f"launches {launches}")

    rec_md5 = [frame_md5(r) for r in res.recon]
    dec_md5 = [frame_md5(d) for d in decoded]
    if rec_md5 != dec_md5:
        raise AssertionError("decoded pictures differ from the encoder's "
                             "recon")
    psnrs = res.psnr_y(w, h)
    nal_md5 = _slice_md5s(res.bitstream)
    for i, r in enumerate(ref):
        ident = nal_md5[i] == r["nal_md5"]
        log(f"[main] frame {i}: {res.frame_bits[i]} bits (ref {r['bits']}), "
            f"PSNR-Y {psnrs[i]:.4f} dB (ref {r['psnr_y']:.4f}), nal md5 "
            f"{nal_md5[i]} byte-identical {ident}, recon md5 "
            f"{'==' if rec_md5[i] == r['recon_md5'] else '!='} ref")
        if abs(res.frame_bits[i] - r["bits"]) > BITS_TOL * r["bits"]:
            raise AssertionError(f"frame {i} bits outside +-0.5%")
        if abs(psnrs[i] - r["psnr_y"]) > PSNR_TOL:
            raise AssertionError(f"frame {i} PSNR outside +-0.02 dB")
        if not all(f.y.shape == (h, w) for f in decoded):
            raise AssertionError("decoded picture shape")
    for k in ("K1", "K2"):
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the main path")
        stats[k]["launches"] = launches[k]

    t0 = time.perf_counter()
    enc.encode(frames)
    t_warm = time.perf_counter() - t0
    log(f"[main] warm encode of {n} 1080p frames: {t_warm:.3f} s = "
        f"{n / t_warm:.3f} fps on {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    stats = {k: {"max_abs_err": 0, "launches": 0, "ms": None,
                 "plain_ms": None} for k in KERNELS}
    phase_environment()
    card = card_line()
    phase_build()
    phase_kernels(stats)
    phase_golden()
    phase_main(stats, card)
    log(json.dumps({"kernels": [
        {"name": f"{k} {KERNELS[k][0]}", "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[k][1], "launches": stats[k]["launches"],
         "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"], "shape": stats[k]["shape"]}
        for k in KERNELS]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
