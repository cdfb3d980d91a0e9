"""Where the time goes in the PyTorch port's main paths, on one NVIDIA
GPU.

    python3 tools/profile_torch.py [--config 2|3|4] [--frames N]
                                   [--reps 5] [--out DIR]

--config 2 (default) encodes frames of the all-intra 1080p VVC clip of
``chip_smoke.py`` and measures, on the card:
- the kernels K1 (encode) and K2 (decode) with CUDA events, at batch 1
  and at the encoder's batch, and the plain torch scan on one frame;
- each stage of the encode: Pass A (mode decision + MTS select) per
  frame, K1 per batch, host entropy coding per frame, and the end to end
  encode and decode rates;
--config 3 encodes frames of the low-delay P 1080p clip (IDR + P) and
measures per P picture, on the card: ME (coarse search + K5), K4, the
whole of P Pass A, K3 (encode) and K3d (decode), the reference
pyramids, host entropy, and the end to end encode and decode rates;
--config 4 encodes the random-access 4K clip of ``chip_smoke.py``
[main-ra] (17 frames: IDR, P, 15 B, deblock, SAO and ALF) in coding
order and measures the IDR and P steps whole and, per B picture: B Pass
A whole and its two ME searches (coarse search + K5 each), K4 on L0
(T = 6) and L1 (T = 2), K3-B encode and decode, the loop filters, the
reference pyramids (referenced B pictures only), host entropy, and the
end to end encode and decode rates;
all measure the device's busy share over one warm encode, from
torch.profiler.  Prints a summary and writes profile_torch_cfg<N>.json
and (configs 2 and 3) the profiler's trace, profile_torch_cfg<N>_trace.json,
to DIR (default build/profile).  Fails when no CUDA device is visible.
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

from x266_tpu_torch.config import (preset_cfg2, preset_cfg3,  # noqa: E402
                                   preset_cfg4)
from x266_tpu_torch.core.yuv import synthetic_clip  # noqa: E402
from x266_tpu_torch import tables  # noqa: E402
from x266_tpu_torch.api import Decoder, Encoder  # noqa: E402
from x266_tpu_torch.engine import fused, inter, picture, recon  # noqa
from x266_tpu_torch.engine import recon_cuda  # noqa: E402
from x266_tpu_torch.kernels import me, me_cuda  # noqa: E402


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


def rates(out, encoder, frames, w, h, reps=3):
    """Warm encode (best of reps) and decode rates of the clip."""
    n = len(frames)
    res = encoder.encode(frames)                 # warm
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = encoder.encode(frames)
        walls.append(time.perf_counter() - t0)
    out["encode_s"] = walls
    out["encode_fps"] = n / min(walls)
    decoder = Decoder()
    decoder.decode(res.bitstream)
    t0 = time.perf_counter()
    decoder.decode(res.bitstream)
    out["decode_fps"] = n / (time.perf_counter() - t0)
    out["bits_per_frame"] = [int(b) for b in res.frame_bits]
    out["psnr_y"] = res.psnr_y(w, h)


def busy_share(out, encoder, frames, path=None):
    """Device busy and idle share over one profiled warm encode."""
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
    if path is not None:
        prof.export_chrome_trace(path)


def profile_cfg2(args, dev, frames, out):
    w, h, n = 1920, 1080, args.frames
    cfg = preset_cfg2(w, h).replace(rows_per_segment=1, ctx_inherit=True)
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
    return Encoder(cfg, device=dev, with_recon=False, batch_frames=n), cfg


def profile_cfg3(args, dev, frames, out):
    """Per P picture of the clip, each stage on its own, its reference
    being the previous picture's recon as in the encoder."""
    h, w = frames[0].y.shape
    cfg = preset_cfg3(w, h)
    tab = tables.from_reference(cfg, dev)
    step_i = fused.make_encode_step_i(cfg, tab, True, True)
    mdp = inter.make_mode_decision_p_raw(cfg, tab)
    lam = float(cfg.lambda_mode)
    stages = collections.defaultdict(list)

    def planes(f):
        return [torch.from_numpy(getattr(f, p)[None].copy()).to(dev)
                for p in ("y", "cb", "cr")]

    step_i(*planes(frames[0]))                  # warm (builds the kernels)
    res, t = sync_ms(step_i, *planes(frames[0]))
    stages["i_step_ms"].append(t)
    pyrs = res["pyramids"]
    for f in frames[1:]:
        src = fused._unpack_padded(cfg, *planes(f))
        cur = me._ceil_pad(src[0][0, 1:1 + h, 1:1 + w].to(torch.int32)) \
            .contiguous()
        base, t = sync_ms(me.coarse_search, cur, pyrs[0], lam)
        stages["coarse_search_ms"].append(t)
        stages["k5_ms"].append(event_ms(me_cuda.refine_search, args.reps,
                                        cur, pyrs[0], base))
        mdp(src[0][0], pyrs[0])                 # warm
        maps, t = sync_ms(mdp, src[0][0], pyrs[0])
        stages["pass_a_ms"].append(t)
        grid = me_cuda.refine_search(cur, pyrs[0], base)
        fields = torch.stack([grid] * 6).contiguous()
        stages["k4_ms"].append(event_ms(me_cuda.warp_frames_cuda,
                                        args.reps, pyrs[0], fields))
        maps = [m[None] for m in maps]
        a = (maps[0], maps[1], torch.zeros_like(maps[0]), *maps[2:], *pyrs)
        enc = recon_cuda.recon_inter(cfg, tab, True, *src, *a)
        stages["k3_ms"].append(event_ms(
            lambda: recon_cuda.recon_inter(cfg, tab, True, *src, *a),
            args.reps))
        da = (*a[:4], enc[6].int(), enc[7].int(), *pyrs)
        stages["k3d_ms"].append(event_ms(
            lambda: recon_cuda.recon_inter(cfg, tab, False, *enc[3:6], *da),
            args.reps))
        stages["pyramids_ms"].append(event_ms(
            lambda: fused.build_pyramids_device(*(r[0] for r in enc[:3])),
            args.reps))
        hm = [m[0].cpu().numpy() for m in maps]
        coefs = [c[0].cpu().numpy().astype(np.int32) for c in enc[3:6]]
        mv = [m[0].cpu().numpy().astype(np.int32) for m in enc[6:]]
        t0 = time.perf_counter()
        picture.code_segments(cfg, hm[0], hm[1], *coefs,
                              np.zeros_like(hm[0]), (hm[2], *mv))
        stages["entropy_ms"].append((time.perf_counter() - t0) * 1e3)
        pyrs = fused.build_pyramids_device(*(r[0] for r in enc[:3]))
    out.update(stages)
    return Encoder(cfg, device=dev, with_recon=False), cfg


def profile_cfg4(args, dev, frames, out):
    """The RA clip in coding order, each stage of each B picture on its
    own, the references being the encoder's (the filtered recon of the
    pictures the encoder codes before it)."""
    h, w = frames[0].y.shape
    cfg = preset_cfg4(w, h)
    tab = tables.from_reference(cfg, dev)
    steps = (fused.make_encode_step_i(cfg, tab, True, True),
             fused.make_encode_step_p(cfg, tab, True))
    lam = float(cfg.lambda_mode)
    stages = collections.defaultdict(list)

    def planes(f):
        return [torch.from_numpy(getattr(f, p)[None].copy()).to(dev)
                for p in ("y", "cb", "cr")]

    steps[0](*planes(frames[0]))                # warm (builds the kernels)
    dpb = {}
    for poc, kind in picture.gop_coding_order(len(frames), cfg.intra_period,
                                              cfg.gop_size):
        if kind != "B":
            ref = max((p for p in dpb if p < poc), default=None)
            step = steps[0] if kind == "I" else (
                lambda *a, r=dpb.get(ref): steps[1](*a, *r))
            res, t = sync_ms(step, *planes(frames[poc]))
            stages[f"{kind.lower()}_step_ms"].append(t)
            dpb[poc] = res["pyramids"]
            continue
        l0 = max(p for p in dpb if p < poc)
        l1 = min(p for p in dpb if p > poc)
        p0, p1 = dpb[l0], dpb[l1]
        bc = cfg.replace(qp=cfg.qp + picture.b_qp_offset(cfg, poc))
        is_ref = poc % 2 == 0
        src = fused._unpack_padded(bc, *planes(frames[poc]))
        cur = me._ceil_pad(src[0][0, 1:1 + h, 1:1 + w].to(torch.int32)) \
            .contiguous()
        bases = []
        for pyr in (p0, p1):
            base, t = sync_ms(me.coarse_search, cur, pyr[0], lam)
            bases.append(base)
            stages["coarse_search_ms"].append(t)
            stages["k5_ms"].append(event_ms(me_cuda.refine_search,
                                            args.reps, cur, pyr[0], base))
        mdb = inter.make_mode_decision_b_raw(bc, tab)
        mdb(src[0][0], p0[0], p1[0])            # warm
        maps, t = sync_ms(mdb, src[0][0], p0[0], p1[0])
        stages["pass_a_ms"].append(t)
        grid = me_cuda.refine_search(cur, p0[0], bases[0])
        for pyr, n_f, key in ((p0, 6, "k4_l0_ms"), (p1, 2, "k4_l1_ms")):
            fields = torch.stack([grid] * n_f).contiguous()
            stages[key].append(event_ms(me_cuda.warp_frames_cuda, args.reps,
                                        pyr[0], fields))
        maps = [m[None] for m in maps]
        a = (maps[0], maps[1], torch.zeros_like(maps[0]), *maps[2:5], *p0,
             *p1, maps[5], maps[6])
        enc = recon_cuda.recon_inter(bc, tab, True, *src, *a)
        stages["k3b_ms"].append(event_ms(
            lambda: recon_cuda.recon_inter(bc, tab, True, *src, *a),
            args.reps))
        da = (*a[:4], enc[6].int(), enc[7].int(), *a[6:])
        stages["k3bd_ms"].append(event_ms(
            lambda: recon_cuda.recon_inter(bc, tab, False, *enc[3:6],
                                           *da), args.reps))
        orig = [p[0] for p in planes(frames[poc])]
        db = (maps[2][0], enc[6][0].int(), enc[7][0].int(), enc[3][0].int())
        (filt, sao, alf), t = sync_ms(
            fused.loop_filters, bc, *(r[0] for r in enc[:3]), maps[0][0],
            orig, db)
        stages["loop_filters_ms"].append(t)
        if is_ref:
            stages["pyramids_ms"].append(event_ms(
                lambda: fused.build_pyramids_device(*filt), args.reps))
        hm = [m[0].cpu().numpy() for m in maps]
        coefs = [c[0].cpu().numpy().astype(np.int32) for c in enc[3:6]]
        mv = [m[0].cpu().numpy().astype(np.int32) for m in enc[6:]]
        t0 = time.perf_counter()
        picture.code_segments(bc, hm[0], hm[1], *coefs, np.zeros_like(hm[0]),
                              (hm[2], *mv, hm[5], hm[6]),
                              tuple(x.cpu().numpy() for x in sao))
        stages["entropy_ms"].append((time.perf_counter() - t0) * 1e3)
        # the encoder's own step gives the references of later pictures
        res = fused.make_encode_step_b(bc, tab, False, is_ref)(
            *planes(frames[poc]), *p0, *p1)
        if is_ref:
            dpb[poc] = res["pyramids"]
    out.update(stages)
    return Encoder(cfg, device=dev, with_recon=False), cfg


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, choices=(2, 3, 4), default=2)
    ap.add_argument("--frames", type=int, default=None,
                    help="default 4 (configs 2, 3) or 17 (config 4)")
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
    ra = args.config == 4
    w, h = (3840, 2160) if ra else (1920, 1080)
    n = args.frames or (17 if ra else 4)
    dev = torch.device("cuda")
    frames = synthetic_clip(w, h, n, "motion" if args.config == 3
                            else "mixed")
    out = {"card": card, "frames": n, "config": f"cfg{args.config} "
           f"{w}x{h}"}
    profile = {2: profile_cfg2, 3: profile_cfg3, 4: profile_cfg4}[
        args.config]
    encoder, cfg = profile(args, dev, frames, out)
    rates(out, encoder, frames, w, h, reps=1 if ra else 3)
    os.makedirs(args.out, exist_ok=True)
    tag = f"profile_torch_cfg{args.config}"
    # a 4K RA encode's trace runs to hundreds of MB: summary only
    busy_share(out, encoder, frames,
               None if ra else os.path.join(args.out, f"{tag}_trace.json"))
    for k, v in out.items():
        print(f"{k}: {v}")
    with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
