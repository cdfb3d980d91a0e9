"""Where the ALF estimator's time goes on one NVIDIA GPU, and how much of
its float32 sums is exact in integers.

    python3 tools/profile_alf.py [--frames 3] [--reps 10] [--out DIR]

Two data sets at 3840x2160 (luma) and 1920x1080 (chroma):
- "encoder": the planes the encoder's ALF estimators get in a short
  config-4 encode (``chip_smoke.py`` [main-ra]'s clip, first --frames
  frames in coding order: IDR, P, then B), its post-SAO recon and the
  source, captured at kernels/alf.py estimate_alf / estimate_alf_chroma;
- "noise": ``chip_smoke.py`` [kernels-alf]'s 4K planes (a source frame
  and a recon of +-255 noise around it: features near +-510, errors near
  +-255).

For each, on the card: the estimator's whole call (CUDA events), its
device time by kernel name over --reps calls (torch.profiler; the
port's ALF kernels by name, torch's own ops together), and the torch
ops that build the features (``_diff_planes``) and the per-sample class
plane (``_up4(classify)``) that the estimator used to take as inputs;
and, from int64 sums, the share of the normal equations' float32 chains
(alf.SUM_ORDERS: class, entry, block, lane) whose terms' magnitudes add
up to at most 2^24 -- so that float32 adds them exactly in any order --
and the same share of whole blocks (the lanes and their combine) and of
whole (class, entry) totals.  Prints a summary and writes
profile_alf.json to DIR (default build/profile).  Fails when no CUDA
device is visible.
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from x266_tpu_torch.config import preset_cfg4  # noqa: E402
from x266_tpu_torch.core.yuv import synthetic_clip, synthetic_frame  # noqa
from x266_tpu_torch.api import Encoder  # noqa: E402
from x266_tpu_torch.kernels import alf as kalf  # noqa: E402

EXACT = 2 ** 24


def event_ms(fn, reps, *args):
    fn(*args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(fn, reps, *args):
    """Device time per call by kernel name: the port's kernels (from
    csrc/) by name, every other kernel under "torch ops"."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"\balf_\w+", e.name)
        out[m.group(0) if m else "torch ops"] += \
            e.time_range.elapsed_us() / 1e3 / reps
    return dict(out)


def capture_encoder_planes(n_frames):
    """(luma, chroma) lists of (orig, recon, lam) the encoder's estimators
    get in a config-4 encode of the first n_frames 4K frames."""
    luma, chroma = [], []
    est_l, est_c = kalf.estimate_alf, kalf.estimate_alf_chroma

    def grab_l(orig, recon, lam, *a):
        luma.append((orig.clone(), recon.clone(), lam))
        return est_l(orig, recon, lam, *a)

    def grab_c(orig, recon, lam, *a):
        chroma.append((orig.clone(), recon.clone(), lam))
        return est_c(orig, recon, lam, *a)

    kalf.estimate_alf, kalf.estimate_alf_chroma = grab_l, grab_c
    try:
        cfg = preset_cfg4(3840, 2160)
        Encoder(cfg).encode(synthetic_clip(3840, 2160, n_frames, "mixed"))
    finally:
        kalf.estimate_alf, kalf.estimate_alf_chroma = est_l, est_c
    return luma, chroma


def noise_planes(seed=31):
    f = synthetic_frame(3840, 2160, 0, "mixed", seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for src in (f.y, f.cb):
        o = torch.from_numpy(src).cuda().int()
        r = (o + torch.randint(-255, 256, o.shape, generator=gen,
                               device="cuda", dtype=torch.int32)).clamp(0, 255)
        out.append((o, r, 100.0))
    return out


def exact_shares(orig, recon, luma: bool):
    """Shares of the normal equations' chains, blocks and totals whose
    terms' magnitudes add up to <= 2^24 (chains that hold no sample of
    their class not counted), for the gram and the rhs."""
    o, r = orig.int(), recon.int()
    diamond = kalf.DIAMOND if luma else kalf.CHROMA_DIAMOND
    f = kalf._diff_planes(r, diamond).reshape(len(diamond), -1).long().abs()
    e = (o - r).reshape(-1).long().abs()
    n = e.numel()
    if luma:
        cls, nc = kalf._up4(kalf.classify(r)).reshape(-1).long(), 25
    else:
        cls, nc = torch.zeros(n, dtype=torch.long, device=e.device), 1
    k = torch.arange(n, device=e.device)
    out = {}
    kind = "luma" if luma else "chroma"
    for q in ("gram", "rhs"):
        block, lanes, _ = kalf.SUM_ORDERS[f"{kind}_{q}"]
        block = block or n
        nb = -(-n // block)
        chain = (cls * nb + k // block) * lanes + (k % block) % lanes
        size = nc * nb * lanes
        count = torch.zeros(size, dtype=torch.long, device=e.device)
        count.index_add_(0, chain, torch.ones_like(chain))
        mags = []
        for i in range(f.shape[0]):
            t = f[i] * (f if q == "gram" else e[None])
            m = torch.zeros((t.shape[0], size), dtype=torch.long,
                            device=e.device)
            m.index_add_(1, chain, t)
            mags.append(m)
        mag = torch.cat(mags).reshape(-1, nc, nb, lanes)
        cnt = count.reshape(nc, nb, lanes)[None].expand_as(mag)
        blk, bcnt = mag.sum(-1), cnt.sum(-1)
        tot, tcnt = blk.sum(-1), bcnt.sum(-1)
        out[q] = {
            "chains": int((cnt > 0).sum()),
            "exact_chains": float(((mag <= EXACT) & (cnt > 0)).sum()
                                  / (cnt > 0).sum()),
            "exact_blocks": float(((blk <= EXACT) & (bcnt > 0)).sum()
                                  / (bcnt > 0).sum()),
            "exact_totals": float(((tot <= EXACT) & (tcnt > 0)).sum()
                                  / (tcnt > 0).sum()),
        }
    return out


def measure(orig, recon, lam, luma: bool, reps: int):
    est = kalf.estimate_alf if luma else kalf.estimate_alf_chroma
    diamond = kalf.DIAMOND if luma else kalf.CHROMA_DIAMOND
    res = {
        "estimator_ms": event_ms(est, reps, orig, recon, lam),
        "estimator_by_kernel_ms": device_ms_by_kernel(est, reps, orig, recon,
                                                      lam),
        "features_torch_ms": event_ms(kalf._diff_planes, reps, recon,
                                      diamond),
        "exact": exact_shares(orig, recon, luma),
    }
    if luma:
        res["class_plane_torch_ms"] = event_ms(
            lambda y: kalf._up4(kalf.classify(y)), reps, recon)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_alf: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = {"card": card}
    luma, chroma = capture_encoder_planes(args.frames)
    sets = {f"encoder coding-order call {i} luma": (*p, True)
            for i, p in enumerate(luma)}
    sets.update({f"encoder coding-order call {i} chroma": (*p, False)
                 for i, p in enumerate(chroma[::2])})
    (ny, nc) = noise_planes()
    sets["noise luma"] = (*ny, True)
    sets["noise chroma"] = (*nc, False)
    for name, (o, r, lam, is_luma) in sets.items():
        res = measure(o.int(), r.int(), float(lam), is_luma, args.reps)
        out[name] = res
        print(f"{name}: {json.dumps(res)}", flush=True)
    print(card)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_alf.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
