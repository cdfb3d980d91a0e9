"""The motion kernels K4 (MC warp) and K5 (ME refine) of csrc/me.cu,
and the picture SSE of csrc/sse.cu, against other versions of those
sources on the same card.

    python3 tools/profile_me.py --parent FILE [--split] [--sass]
                                [--reps 20] [--out DIR]
    python3 tools/profile_me.py [--sse-parent FILE] [--sse-split]
                                [--reps 20] [--out DIR]

The workloads are chip_smoke.py's shapes, on its inputs
(chip_smoke.me_inputs): config 3's 1920x1080 P picture ([kernels-p]: K5,
then K4 on P Pass A's T = 6 fields of K5's grid) and config 4's
3840x2160 ([kernels-me-4k]: K5, then K4 on B Pass A's L0 fields, T = 6,
and L1 fields, T = 2).

--parent FILE builds FILE in place of csrc/me.cu (e.g. the parent
commit's, from ``git show REV:x266_tpu_torch/csrc/me.cu`` into
parent_src/, which .gitignore lists) and the package's me.cu; checks
that both libraries give the plain version's outputs on every workload,
and times each workload with both in turns (parent, new, new, parent;
chip_smoke.event_ms, --reps launches each).  Each build prints nvcc's
-Xptxas -v lines (registers, stack, spills) for its kernels.

--sass prints, for the package's library, each motion kernel's and the
SSE kernel's SASS instruction count and most frequent opcodes (cuobjdump
-sass from the toolkit) and writes the listing to DIR/sass.txt.

--split builds the package's me.cu with X266_ME_PHASES (K5's clock64()
split, which the main build never sets) and prints, per workload after
warm launches, K5's mean cycles per ME block in each stage (lane 0 of
its warp: the window loads, stage 1's SADs and its argmins, the stage-2
window's wait, stage 2's SADs and its argmin) and the instrumented
kernel's time.  For each K4 workload the time of one fill_ of a tensor
of its output's shape is printed too: the card's rate for writing those
bytes.

--sse-parent FILE builds FILE, an sse.cu with the one-plane entry point
x266_plane_sse (``git show 40deb28:x266_tpu_torch/csrc/sse.cu``), and
times the step's SSE outputs (engine/fused.py ``_sse_outputs``: float32
"sse" and int64 "sse_exact" of the three planes) as that commit computed
them -- frame_sse's torch passes and one x266_plane_sse call per plane
-- against the package's own ``_sse_outputs``, in turns, at config 2's
step (4 x 1920x1080 luma, 2 x 4 x 960x540 chroma) and one 3840x2160
picture, near and far from the source; both must equal the plain
versions (cost.plane_sse_f32_plain, fused.frame_sse) on both.

--sse-split builds the package's sse.cu with X266_SSE_PHASES and prints,
at the same two shapes after warm launches, the instrumented kernel's
time and its last launch's clock64() split: the SMs and schedulers its
tiles (warps) ran on, each tile's level-1 cycles and, of them, the
cycles it waited on its ring's copies and released slots; the tiles that
added blocks of level-1 sums (having taken a block's last ticket) and
their cycles; and on the card's globaltimer, from the first tile's
start, when the last tile started, when the last one finished level 1
and when the last one ended.  Only the SSE runs when none of the motion options is given.

Libraries go to build/x266_tpu_torch/profile-<hash>/ (ignored by git),
each through _build.Library with the package's flags
(profile_common.build); JSON results to
DIR (default build/profile).  Fails when no CUDA device is visible.
"""

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import profile_common as pc  # noqa: E402
from x266_tpu_torch import _build  # noqa: E402
from x266_tpu_torch.engine import fused  # noqa: E402
from x266_tpu_torch.kernels import (cost, interp, me, me_cuda,  # noqa
                                    sse_cuda)

ME = os.path.join(_build.PKG, "csrc", "me.cu")
SSE = os.path.join(_build.PKG, "csrc", "sse.cu")
SSE_WINDOW = 32         # the reference's reduction window
SSE_SHAPES = (("config 2 step", (4, 1080, 1920)),
              ("4K picture", (1, 2160, 3840)))
# csrc/sse.cu's per-CTA slots under X266_SSE_PHASES
SSE_PHASES = ["level-1 cycles", "copy-wait cycles", "slot-release cycles",
              "block cycles", "start ns", "level-1 end ns", "end ns",
              "sm | warpid << 16", "block copy-wait cycles",
              "level-2 window cycles", "plane-ticket cycles"]
# csrc/me.cu's K5 stages under X266_ME_PHASES, in slot order
PHASES = ["window loads", "stage 1 SADs", "stage 1 argmins",
          "stage 2 window wait", "stage 2 SADs", "stage 2 argmin"]


class Workload:
    """One launch at a main-path shape: name, kernel, run(lib) -> the
    output on the current stream, and the plain version's output."""

    def __init__(self, name, kernel, run, want):
        self.name, self.kernel, self.run, self.want = name, kernel, run, want


def workloads():
    """chip_smoke.py's K4 and K5 shapes (see the module doc)."""
    out = []
    for tag, cfg in (("1080p config 3", cs.cfg3()),
                     ("4K config 4", cs.cfg4())):
        _, pyrs, cur, base = cs.me_inputs(cfg, 3)
        pyr = pyrs[0]
        grid = me.refine_search_ref(cur, pyr, base)
        out.append(Workload(
            f"K5 {tag}", "K5",
            lambda lib, cur=cur, pyr=pyr, base=base: pc.checked(
                me_cuda._launch_refine(lib, pc.stream(), cur, pyr, base)),
            grid))
        bd = interp.mv_bounds(cfg, 16) - 8
        fields = cs.me_fields(grid.clamp(-bd, bd), cfg.max_cu_size)
        if cfg.height == 1080:        # P Pass A warps L0's fields only
            fields = fields[:1]
        for mvs in fields:
            out.append(Workload(
                f"K4 {tag} T={mvs.shape[0]}", "K4",
                lambda lib, pyr=pyr, mvs=mvs: pc.checked(
                    me_cuda._launch_warp(lib, pc.stream(), pyr, mvs)),
                me_cuda.warp_frames_ref(pyr, mvs)))
    return out


def compare(parent, new, wl, reps) -> dict:
    """Both libraries on one workload: the plain version's output from
    each, then the times in turns."""
    same = [torch.equal(wl.run(lib), wl.want) for lib in (parent, new)]
    if not all(same):
        print(f"[compare] {wl.name}: outputs differ from the plain version "
              f"(parent, new): {same}", flush=True)
        return {"workload": wl.name, "equal": False}
    r = pc.in_turns(parent, new, wl.run, reps)
    print(f"[compare] {wl.name}: parent {r['ms_parent']:.4f} ms, new "
          f"{r['ms_new']:.4f} ms ({r['speedup']:.2f}x; turns "
          f"{[round(t, 4) for t in r['turns_ms']]}); outputs equal the "
          "plain version's", flush=True)
    return {"workload": wl.name, "equal": True, "kernel": wl.kernel, **r}


def sass(out_dir) -> dict:
    """Each motion and SSE kernel's SASS instruction count and opcode
    histogram in the library of the package's me.cu and sse.cu; the whole
    listing goes to out_dir/sass.txt."""
    so = pc.build([ME, SSE], (), lambda lib: _build.declare_sse(
        _build.declare_me(lib))).path
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    with open(os.path.join(out_dir, "sass.txt"), "w") as f:
        f.write(text)
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = cs.kernel_name(m.group(1))
            out[name] = collections.Counter()
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and name:
            out[name][m.group(1).split(".")[0]] += 1
    res = {}
    for k, hist in out.items():
        res[k] = {"instructions": sum(hist.values()),
                  "top": hist.most_common(16)}
        print(f"[sass] {k}: {res[k]['instructions']} instructions; "
              + ", ".join(f"{op} {n}" for op, n in res[k]["top"]),
              flush=True)
    return res


def split(lib, wl, reps) -> dict:
    """K5's mean cycles per ME block by stage over one launch (after a
    warm launch), and the instrumented kernel's time."""
    buf = np.zeros(len(PHASES), dtype=np.uint64)
    ms = cs.event_ms(wl.run, lib, reps=reps)
    blocks = wl.want.numel() // 2
    if lib.x266_me_phases(buf.ctypes.data, blocks) != 0:
        raise RuntimeError("reading the phase split failed")
    res = {"workload": wl.name, "blocks": blocks, "ms_instrumented": ms,
           "cycles_per_block": {n: float(c) / blocks
                                for n, c in zip(PHASES, buf)}}
    print(f"[split] {wl.name}: {blocks} ME blocks, {ms:.4f} ms with the "
          "split; cycles per block: " + ", ".join(
              f"{n} {v:.0f}" for n, v in res["cycles_per_block"].items()),
          flush=True)
    return res


def fill_ms(wl, reps) -> float:
    """The time of one fill of a tensor of K4's output shape (a memset
    kernel: the card's rate for writing the same bytes)."""
    out = torch.empty_like(wl.want)
    ms = cs.event_ms(out.fill_, 1, reps=reps)
    print(f"[fill] {wl.name}: {out.numel() * 4} bytes written by fill_ in "
          f"{ms:.4f} ms", flush=True)
    return ms


def declare_plane_sse(lib):
    """The C signature of an sse.cu with x266_plane_sse (40deb28's)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.x266_plane_sse.argtypes = [i] * 3 + [p] * 6
    lib.x266_plane_sse.restype = i
    return lib


def plane_sse_outputs(lib, rec, src) -> dict:
    """fused._sse_outputs as 40deb28 computed it: frame_sse's torch
    passes for "sse_exact", and per plane one x266_plane_sse call of lib
    (a launch per tree level) for "sse"."""
    sse = []
    for r, o in zip(rec, src):
        n, h, w = o.shape
        cells = n * -(-h // SSE_WINDOW) * -(-w // SSE_WINDOW)
        scratch = torch.empty((2, cells), dtype=torch.float32,
                              device=o.device)
        out = torch.empty(n, dtype=torch.float32, device=o.device)
        sse.append(pc.checked((lib.x266_plane_sse(
            n, h, w, r.data_ptr(), o.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), out.data_ptr(), pc.stream()), out)))
    return {"sse_exact": torch.stack([fused.frame_sse(r, o)
                                      for r, o in zip(rec, src)], dim=1),
            "sse": torch.stack(sse, dim=1)}


def sse_planes(n, h, w, seed):
    """Three (n, h, w) / (n, h/2, w/2) uint8 source planes on the card
    and two reconstructions of them: near (+-6, exact float32 sums) and
    far (sums past 2^24 that round)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src, near, far = [], [], []
    for shape in ((n, h, w), (n, h // 2, w // 2), (n, h // 2, w // 2)):
        o = torch.randint(0, 256, shape, device="cuda", generator=gen)
        src.append(o.to(torch.uint8))
        near.append((o + torch.randint(-6, 7, shape, device="cuda",
                                       generator=gen)).clamp(0, 255)
                    .to(torch.uint8))
        far.append((torch.where(o < 128, 255, 0) ^ torch.randint(
            0, 64, shape, device="cuda", generator=gen)).to(torch.uint8))
    return src, near, far


def compare_sse(parent, reps) -> list:
    """The step's SSE outputs, 40deb28's way (parent: its library) and
    the package's, at config 2's step and a 4K picture: equal to the
    plain versions near and far, then timed in turns on near."""
    res = []
    for name, shape in SSE_SHAPES:
        src, near, far = sse_planes(*shape, seed=7)
        equal = True
        for kind, rec in (("near", near), ("far", far)):
            want = {"sse": torch.stack([cost.plane_sse_f32_plain(r, o)
                                        for r, o in zip(rec, src)], dim=1),
                    "sse_exact": torch.stack([fused.frame_sse(r, o)
                                              for r, o in zip(rec, src)],
                                             dim=1)}
            for who, got in (("parent", plane_sse_outputs(parent, rec, src)),
                             ("new", fused._sse_outputs(rec, src))):
                same = all(torch.equal(got[k], want[k]) for k in want)
                equal &= same
                print(f"[sse] {name} {kind}: {who} equal to the plain "
                      f"versions {same}", flush=True)
        b = cs.bound(cs.nbytes(*near, *src) + 12 * shape[0] * 3, 0)
        r = pc.in_turns(lambda: plane_sse_outputs(parent, near, src),
                        lambda: fused._sse_outputs(near, src),
                        lambda fn: fn(), reps)
        print(f"[sse] {name}: parent {r['ms_parent']:.4f} ms, new "
              f"{r['ms_new']:.4f} ms ({r['speedup']:.2f}x; turns "
              f"{[round(t, 4) for t in r['turns_ms']]}); bound "
              f"{b[0]:.4f} ms ({b[1]})", flush=True)
        res.append({"workload": f"SSE {name}", "equal": equal,
                    "kernel": "SSE", "bound_ms": b[0], **r})
    return res


def declare_sse_phases(lib):
    """csrc/sse.cu's entry point and X266_SSE_PHASES's reader."""
    _build.declare_sse(lib)
    lib.x266_sse_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.x266_sse_phases.restype = ctypes.c_int
    return lib


def sse_tiles(frames, shapes) -> int:
    """The tiles (warps) of one launch of csrc/sse.cu: per frame and
    plane, one for a plane of at most 32 x 32, else one per 32 windows of
    each window row."""
    n = 0
    for h, w in shapes:
        small = h <= SSE_WINDOW and w <= SSE_WINDOW
        n += 1 if small else (sse_cuda._dim(h)[1]
                              * -(-sse_cuda._dim(w)[1] // 32))
    return frames * n


def split_sse(reps) -> list:
    """The clock64()/globaltimer split of csrc/sse.cu's last launch at
    each shape (near data), after warm launches."""
    lib = pc.build([SSE], ("X266_SSE_PHASES",), declare_sse_phases).lib
    res = []
    for name, shape in SSE_SHAPES:
        src, near, _ = sse_planes(*shape, seed=7)
        shapes = [tuple(o.shape[1:]) for o in src]
        work = sse_cuda.new_work(shape[0], shapes, "cuda")

        def run():
            return pc.checked(sse_cuda._launch(lib, pc.stream(), near, src,
                                               work))

        want = (torch.stack([cost.plane_sse_f32_plain(r, o)
                             for r, o in zip(near, src)], dim=1),
                torch.stack([fused.frame_sse(r, o)
                             for r, o in zip(near, src)], dim=1))
        equal = all(torch.equal(g, w) for g, w in zip(run(), want))
        ms = cs.event_ms(run, reps=reps)
        n = sse_tiles(shape[0], shapes)
        buf = np.zeros((n, len(SSE_PHASES)), dtype=np.uint64)
        if lib.x266_sse_phases(buf.ctypes.data, n) != 0:
            raise RuntimeError("reading the SSE split failed")
        l1, wait, iss, blk = (buf[:, k].astype(np.float64) for k in range(4))
        g = buf[:, 4:7].astype(np.int64) - int(buf[:, 4].min())
        sel = np.flatnonzero(blk)                 # tiles that added blocks
        sel = sel[np.argsort(blk[sel])]
        sm = (buf[:, 7] & 0xffff).astype(np.int64)
        sched = sm * 4 + (buf[:, 7] >> 16).astype(np.int64) % 4
        r = {"workload": f"SSE {name}", "equal": equal,
             "ms_instrumented": ms, "tiles": n,
             "sms": len(np.unique(sm)),
             "max_tiles_a_scheduler": int(np.bincount(sched).max()),
             "level1_cycles_mean": l1.mean(), "level1_cycles_max": l1.max(),
             "wait_share": wait.sum() / l1.sum(),
             "release_share": iss.sum() / l1.sum(),
             "block_cycles": blk[sel].tolist(),
             "block_split": {k: buf[sel, 8 + n].astype(np.float64)
                             .tolist() for n, k in enumerate(
                                 ("copy_wait", "level2_window",
                                  "plane_ticket"))},
             "last_start_us": g[:, 0].max() / 1e3,
             "last_level1_end_us": g[:, 1].max() / 1e3,
             "last_end_us": g[:, 2].max() / 1e3}
        print(f"[sse-split] {name}: {ms:.4f} ms instrumented, {n} tiles on "
              f"{r['sms']} SMs, at most {r['max_tiles_a_scheduler']} a "
              f"scheduler; level 1 {r['level1_cycles_mean']:.0f} cycles a "
              f"tile (max {r['level1_cycles_max']:.0f}), "
              f"{100 * r['wait_share']:.1f} % of them waiting on copies, "
              f"{100 * r['release_share']:.1f} % releasing slots; "
              f"{len(r['block_cycles'])} tiles added blocks, in "
              f"{[int(t) for t in r['block_cycles']]} cycles (of them "
              f"copy waits {[int(t) for t in r['block_split']['copy_wait']]},"
              f" level-2 windows "
              f"{[int(t) for t in r['block_split']['level2_window']]}, "
              f"plane tickets "
              f"{[int(t) for t in r['block_split']['plane_ticket']]}); "
              f"from the first "
              f"start: last start {r['last_start_us']:.2f} us, last level-1 "
              f"end {r['last_level1_end_us']:.2f} us, last end "
              f"{r['last_end_us']:.2f} us; outputs equal to the plain "
              f"versions {equal}", flush=True)
        res.append(r)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sse-parent")
    ap.add_argument("--sse-split", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_me: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"[env] {card}; torch {torch.__version__}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    result = {"card": card, "compare": [], "split": []}
    if args.sse_parent:
        result["compare"] = compare_sse(
            pc.build([args.sse_parent], (), declare_plane_sse).lib,
            args.reps)
    if args.sse_split:
        result["sse_split"] = split_sse(args.reps)
    motion = (args.parent or args.split
              or not (args.sse_parent or args.sse_split or args.sass))
    wls = workloads() if motion else []
    result["fill_ms"] = {wl.name: fill_ms(wl, args.reps) for wl in wls
                         if wl.kernel == "K4"}
    if args.sass:
        result["sass"] = sass(args.out)
    if args.parent:
        parent = pc.build([args.parent], (), _build.declare_me).lib
        new = pc.build([ME], (), _build.declare_me).lib
        result["compare"] += [compare(parent, new, wl, args.reps)
                              for wl in wls]
    if args.split:
        lib = pc.build([ME], ("X266_ME_PHASES",), _build.declare_me).lib
        lib.x266_me_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.x266_me_phases.restype = ctypes.c_int
        result["split"] = [split(lib, wl, args.reps) for wl in wls
                           if wl.kernel == "K5"]
    with open(os.path.join(args.out, "profile_me.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"[done] {card}", flush=True)
    return int(not all(r["equal"] for r in result["compare"]))


if __name__ == "__main__":
    sys.exit(main())
