"""The motion kernels K4 (MC warp) and K5 (ME refine) of csrc/me.cu
against another version of that source on the same card.

    python3 tools/profile_me.py --parent FILE [--split] [--sass]
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

--sass prints, for the package's library, each motion kernel's SASS
instruction count and its most frequent opcodes (cuobjdump -sass from
the toolkit).

--split builds the package's me.cu with X266_ME_PHASES (K5's clock64()
split, which the main build never sets) and prints, per workload after
warm launches, K5's mean cycles per ME block in each stage (lane 0 of
its warp: the window loads, stage 1's SADs and its argmins, the stage-2
window's wait, stage 2's SADs and its argmin) and the instrumented
kernel's time.  For each K4 workload the time of one fill_ of a tensor
of its output's shape is printed too: the card's rate for writing those
bytes.

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
from x266_tpu_torch.kernels import interp, me, me_cuda  # noqa: E402

ME = os.path.join(_build.PKG, "csrc", "me.cu")
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


def sass() -> dict:
    """Each motion kernel's SASS instruction count and opcode histogram in
    the library of the package's me.cu."""
    so = pc.build([ME], (), _build.declare_me).path
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--sass", action="store_true")
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
    wls = workloads()
    result["fill_ms"] = {wl.name: fill_ms(wl, args.reps) for wl in wls
                         if wl.kernel == "K4"}
    if args.sass:
        result["sass"] = sass()
    if args.parent:
        parent = pc.build([args.parent], (), _build.declare_me).lib
        new = pc.build([ME], (), _build.declare_me).lib
        result["compare"] = [compare(parent, new, wl, args.reps)
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
