"""Where the ALF estimator's time goes on one NVIDIA GPU, and how much of
its float32 sums is exact in integers.

    python3 tools/profile_alf.py [--frames 3] [--reps 10] [--out DIR]
    python3 tools/profile_alf.py --parent FILE [--reps 20] [--out DIR]

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

--parent FILE builds FILE, an earlier csrc/alf.cu whose x266_alf_normal
takes no feature kind (e.g. ``git show 476f66d:x266_tpu_torch/csrc/
alf.cu > parent_src/alf.cu``), beside the package's library, and times
the linear normal equations (kernels only, alf_cuda._launch) of both on
the IDR's 4K luma and chroma of the encode above and on the noise planes
in turns (parent, new, new, parent; chip_smoke.event_ms, --reps calls
each), after checking that both give the same coefficients, gram and
rhs; writes profile_alf_<FILE's name>.json.  With --parent-kinds FILE's
x266_alf_normal takes the feature kinds, as the package's does.

--parent FILE --gate-cls (FILE's CC-ALF gate a launch of its own behind
the CTB kernel and its class SSE on int32 levels, as in ``git show
7db3715:x266_tpu_torch/csrc/alf.cu > parent_src/alf_7db3715.cu``) times
instead, on chip_smoke.py [kernels-alf]'s encoder and noise planes, after
checking that both libraries' outputs are equal: the CTB decision
without the gate on 4K luma (64x64 CTBs) and 4K chroma (32x32); CC-ALF's
gate as chip_smoke.py measures it, the CTB call with the gate less the
call without it, each turn timing both, on 4K and 1080p chroma; and the
class SSE (x266_alf_class_sse: the parent's on the four levels in int32,
the package's on the same levels in uint8) on 4K luma, with the class
SSE's longest ordered lane chain and its dependent-add floor.
"""

import argparse
import collections
import ctypes
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


def declare_parent(lib):
    """The entry point of an alf.cu without feature kinds."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.x266_alf_normal.argtypes = [i] * 4 + [p] * 3 + [i] * 6 + [p] * 11
    lib.x266_alf_normal.restype = i
    return lib


class Linear:
    """A library without feature kinds, called as alf_cuda._launch calls
    the package's: the kind's arguments (tmap, clip, luma, base, lh, lw)
    must be the linear kind's and are dropped."""

    def __init__(self, lib):
        self.lib = lib

    def x266_alf_normal(self, h, w, t, nc, recon, orig, cls, tmap, clip,
                        luma, base, lh, lw, *rest):
        assert tmap is None and clip == 0 and luma is None
        return self.lib.x266_alf_normal(h, w, t, nc, recon, orig, cls,
                                        *rest)


def declare_kinds(lib):
    """The entry point of an alf.cu with feature kinds."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.x266_alf_normal.argtypes = ([i] * 4 + [p] * 4 + [i] + [p] * 2
                                    + [i] * 8 + [p] * 11)
    lib.x266_alf_normal.restype = i
    return lib


def compare_parent(path, kinds, reps, card) -> dict:
    """The linear normal equations of FILE's kernels against the
    package's, in turns, on the 4K planes of capture_encoder_planes(1)
    and noise_planes()."""
    import profile_common as pc

    from x266_tpu_torch import _build
    from x266_tpu_torch.kernels import alf_cuda

    parent = (pc.build([path], (), declare_kinds).lib if kinds else
              Linear(pc.build([path], (), declare_parent).lib))
    new = _build.LIBRARY.build()
    luma, chroma = capture_encoder_planes(1)
    (ny, nc) = noise_planes()
    sets = {"encoder IDR luma": (*luma[0][:2], True),
            "encoder IDR chroma": (*chroma[0][:2], False),
            "noise luma": (*ny[:2], True), "noise chroma": (*nc[:2], False)}
    out = {"card": card, "parent": os.path.relpath(path, ROOT)}
    for name, (o, r, is_luma) in sets.items():
        o, r = o.int().contiguous(), r.int().contiguous()
        cls = kalf.classify(r).int().contiguous() if is_luma else None

        def run(lib):
            return pc.checked(alf_cuda._launch(lib, pc.stream(), r, o, cls))

        a, b = run(parent), run(new)
        for x, y, what in zip(a[:3], b[:3], ("coef", "gram", "rhs")):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: {what} differs from the "
                                     "parent's")
        res = pc.in_turns(parent, new, run, reps)
        out[name] = res
        print(f"[parent] {name}: parent {res['ms_parent']:.4f} ms, new "
              f"{res['ms_new']:.4f} ms (turns {res['turns_ms']}); outputs "
              "equal", flush=True)
    print(card)
    return out


def declare_gate_cls(lib):
    """The entry points of an alf.cu whose CC-ALF gate has no ticket."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    declare_kinds(lib)
    lib.x266_alf_ctb_flags.argtypes = [i] * 3 + [fl] + [p] * 6 + [fl, p, p]
    lib.x266_alf_ctb_flags.restype = i
    lib.x266_alf_class_sse.argtypes = [i] * 3 + [p] * 8
    lib.x266_alf_class_sse.restype = i
    return lib


class NoTicket:
    """A library whose CTB entry point takes no ticket, called as
    alf_cuda._launch_flags calls the package's: the ticket is dropped."""

    def __init__(self, lib):
        self.lib = lib

    def x266_alf_ctb_flags(self, *args):
        return self.lib.x266_alf_ctb_flags(*args[:-2], args[-1])


def class_sse_int32(lib, stream, filt, orig, cls):
    """The class SSE of a library whose levels are int32 (it zeroes its
    chain totals itself): (error code, (sse, stats))."""
    lv, h, w = filt.shape
    dev = orig.device
    dblk = torch.empty(lv * (h // 4) * (w // 4), dtype=torch.int32,
                       device=dev)
    tot = torch.empty(lv * kalf.NUM_CLASSES * 16, dtype=torch.int64,
                      device=dev)
    out = torch.empty((lv, kalf.NUM_CLASSES), dtype=torch.float32,
                      device=dev)
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    code = lib.x266_alf_class_sse(lv, h, w, filt.data_ptr(), orig.data_ptr(),
                                  cls.data_ptr(), dblk.data_ptr(),
                                  tot.data_ptr(), out.data_ptr(),
                                  stats.data_ptr(), stream)
    return code, (out, stats)


def compare_gate_cls(path, reps, card) -> dict:
    """FILE's CTB decision, CC-ALF gate and class SSE against the
    package's, in turns (see the module doc)."""
    import chip_smoke as cs
    import profile_common as pc

    from x266_tpu_torch import _build
    from x266_tpu_torch.kernels import alf_cuda

    lib_p = pc.build([path], (), declare_gate_cls).lib
    lib_n = _build.LIBRARY.build()
    parent, new = NoTicket(lib_p), lib_n
    ticket, tot = alf_cuda.new_work("cuda")
    out = {"card": card, "parent": os.path.relpath(path, ROOT),
           "sm_clock_max_mhz": cs.sm_clock_mhz()}

    def equal(name, a, b):
        for x, y in zip(a, b):
            if x is not None and not torch.equal(x, y):
                raise AssertionError(f"{name}: the outputs differ from the "
                                     "parent's")

    for w, h in ((3840, 2160), (1920, 1080)):
        data = cs._alf_data(w, h, 31)
        for kind in ("encoder", "noise"):
            o, r, lam = data[kind]["luma"]
            oc, rc, _ = data[kind]["chroma"]
            tag = f"{w}x{h} {kind}"
            filts, cls, _ = cs.nl_levels(o, r)
            cfilt = cs.cc_filtered(r, rc, oc)
            lum = [x.int().contiguous() for x in (filts[0], r, o)]
            chrom = [x.int().contiguous() for x in (cfilt, rc, oc)]
            worth = torch.empty(1, dtype=torch.int32, device="cuda")

            def flags(lib, planes, ctb):
                return pc.checked(alf_cuda._launch_flags(
                    lib, pc.stream(), *planes, ctb, lam, False))

            def gate(lib):
                return pc.checked(alf_cuda._launch_flags(
                    lib, pc.stream(), *chrom, 32, lam, False, worth,
                    ticket)) + (worth.clone(),)

            sets = [("ctb flags chroma", lambda lib: flags(lib, chrom, 32))]
            if w == 3840:
                sets.insert(0, ("ctb flags luma",
                                lambda lib: flags(lib, lum, 64)))
            for name, run in sets:
                equal(f"{tag} {name}", run(parent), run(new))
                res = pc.in_turns(parent, new, run, reps)
                out[f"{tag} {name}"] = res
                print(f"[parent] {tag} {name}: parent {res['ms_parent']:.4f}"
                      f" ms, new {res['ms_new']:.4f} ms (turns "
                      f"{res['turns_ms']}); outputs equal", flush=True)
            equal(f"{tag} gate", gate(parent), gate(new))
            turns = []
            for lib in (parent, new, new, parent):
                g = cs.event_ms(gate, lib, reps=reps)
                f = cs.event_ms(flags, lib, chrom, 32, reps=reps)
                turns.append({"with_gate_ms": g, "without_ms": f,
                              "gate_ms": g - f})
            gp = (turns[0]["gate_ms"] + turns[3]["gate_ms"]) / 2
            gn = (turns[1]["gate_ms"] + turns[2]["gate_ms"]) / 2
            cy, cx = -(-rc.shape[0] // 32), -(-rc.shape[1] // 32)
            floor = cs.add_floor(cs.gate_adds(cy, cx))
            out[f"{tag} gate"] = {"ms_parent": gp, "ms_new": gn,
                                  "turns": turns, "ctbs": cy * cx,
                                  "dependent_add_floor": floor}
            print(f"[parent] {tag} CC-ALF gate ({cy * cx} CTBs): parent "
                  f"{gp:.4f} ms, new {gn:.4f} ms (turns {turns}); "
                  f"dependent-add floor {floor}; outputs equal", flush=True)
            if w != 3840:
                continue
            f32 = filts.int().contiguous()
            o32, c32 = o.int().contiguous(), cls.int().contiguous()

            def cls_sse(lib):
                if lib is parent:
                    return pc.checked(class_sse_int32(lib_p, pc.stream(),
                                                      f32, o32, c32))
                return pc.checked(alf_cuda._launch_class(
                    lib, pc.stream(), filts, o32, c32, tot))

            equal(f"{tag} class sse", cls_sse(parent), cls_sse(new))
            res = pc.in_turns(parent, new, cls_sse, reps)
            chains = cs.class_chain_lengths(filts, o, cls)
            res["chains"] = chains
            res["dependent_add_floor"] = cs.add_floor(
                chains["longest_blocks"])
            out[f"{tag} class sse"] = res
            print(f"[parent] {tag} class sse: parent {res['ms_parent']:.4f}"
                  f" ms, new {res['ms_new']:.4f} ms (turns "
                  f"{res['turns_ms']}); {chains}, floor "
                  f"{res['dependent_add_floor']}; outputs equal", flush=True)
    print(card)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent")
    ap.add_argument("--parent-kinds", action="store_true")
    ap.add_argument("--gate-cls", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_alf: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.parent:
        path = os.path.abspath(args.parent)
        out = (compare_gate_cls(path, args.reps, card) if args.gate_cls else
               compare_parent(path, args.parent_kinds, args.reps, card))
        os.makedirs(args.out, exist_ok=True)
        name = os.path.splitext(os.path.basename(args.parent))[0]
        with open(os.path.join(args.out, f"profile_alf_{name}.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
        return
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
