"""Where the time goes in the PyTorch port's config-2 main path, on one
NVIDIA GPU.

    python3 tools/profile_torch.py [--frames 4] [--reps 5] [--out DIR]

Encodes frames of the all-intra 1080p VVC clip of ``chip_smoke.py`` and
measures, on the card:
- the kernels K1 (encode) and K2 (decode) with CUDA events, at batch 1
  and at the encoder's batch, and the plain torch scan on one frame;
- each stage of the encode: Pass A (mode decision + MTS select) per
  frame, K1 per batch, host entropy coding per frame, and the end to end
  encode and decode rates;
- the device's busy share over one warm encode, from torch.profiler.
Prints a summary and writes profile_torch.json and the profiler's
trace, profile_torch_trace.json, to DIR (default build/profile).  Fails
when no CUDA device is visible.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from x266_tpu.config import preset_cfg2  # noqa: E402
from x266_tpu.core.yuv import synthetic_clip  # noqa: E402
from x266_tpu_torch import tables  # noqa: E402
from x266_tpu_torch.api import Decoder, Encoder  # noqa: E402
from x266_tpu_torch.engine import fused, picture, recon, recon_cuda  # noqa


def sync_ms(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn, reps, *args):
    fn(*args)                                   # warm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    w, h, n = 1920, 1080, args.frames
    cfg = preset_cfg2(w, h).replace(rows_per_segment=1, ctx_inherit=True)
    frames = synthetic_clip(w, h, n, "mixed")
    dev = torch.device("cuda")
    out = {"card": card, "frames": n, "config": "cfg2 1920x1080"}

    tab = tables.from_reference(cfg, dev)
    planes = [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
              .to(dev) for p in ("y", "cb", "cr")]
    src = fused._unpack_padded(cfg, *planes)
    pass_a = fused.make_pass_a(cfg, tab)

    pass_a(src[0][:1])                          # warm
    maps, pa = [], []
    for f in range(n):
        m, t = sync_ms(pass_a, src[0][f:f + 1])
        maps.append(m)
        pa.append(t)
    maps = [torch.cat(m) for m in zip(*maps)]
    out["pass_a_ms_per_frame"] = pa

    k1 = lambda *a: recon_cuda.recon_intra(cfg, tab, True, *a)  # noqa
    k2 = lambda *a: recon_cuda.recon_intra(cfg, tab, False, *a)  # noqa
    enc = k1(*src, *maps)
    one = [t[:1].contiguous() for t in src], [m[:1].contiguous()
                                              for m in maps]
    out["k1_ms_batch"] = event_ms(k1, args.reps, *src, *maps)
    out["k1_ms_batch1"] = event_ms(k1, args.reps, *one[0], *one[1])
    out["k2_ms_batch"] = event_ms(k2, args.reps, *enc[3:], *maps)
    coef1 = [c[:1].contiguous() for c in enc[3:]]
    out["k2_ms_batch1"] = event_ms(k2, args.reps, *coef1, *one[1])
    _, out["plain_encode_ms_batch1"] = sync_ms(
        recon.make_recon_pass_raw(cfg, tab, True), *one[0], *one[1])
    _, out["plain_decode_ms_batch1"] = sync_ms(
        recon.make_recon_pass_raw(cfg, tab, False), *coef1, *one[1])

    coefs = [c.cpu().numpy().astype(np.int32) for c in enc[3:]]
    hm = [m.cpu().numpy() for m in maps]
    ent = []
    for f in range(n):
        t0 = time.perf_counter()
        picture.code_segments(cfg, hm[0][f], hm[1][f], coefs[0][f],
                              coefs[1][f], coefs[2][f], hm[2][f])
        ent.append((time.perf_counter() - t0) * 1e3)
    out["entropy_ms_per_frame"] = ent

    encoder = Encoder(cfg, device=dev, with_recon=False, batch_frames=n)
    res = encoder.encode(frames)                 # warm
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = encoder.encode(frames)
        walls.append(time.perf_counter() - t0)
    out["encode_s"] = walls
    out["encode_fps"] = n / min(walls)
    decoder = Decoder(device=dev)
    decoder.decode(res.bitstream)
    t0 = time.perf_counter()
    decoder.decode(res.bitstream)
    out["decode_fps"] = n / (time.perf_counter() - t0)
    out["bits_per_frame"] = float(np.mean(res.frame_bits))
    out["psnr_y"] = float(np.mean(res.psnr_y(w, h)))

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encoder.encode(frames)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = collections.Counter()
    for e in kern:
        busy[e.name] += e.time_range.elapsed_us() / 1e3
    out["profiled_encode_ms"] = wall
    out["device_busy_ms"] = sum(busy.values())
    out["device_idle_share"] = 1 - out["device_busy_ms"] / wall
    out["device_kernels"] = len(kern)
    out["top_device_ops_ms"] = busy.most_common(8)
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out,
                                          "profile_torch_trace.json"))

    for k, v in out.items():
        print(f"{k}: {v}")
    with open(os.path.join(args.out, "profile_torch.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
