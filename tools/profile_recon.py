"""Where the recon kernels' time goes on one NVIDIA GPU, phase by phase,
and the recon kernel against another version of its source on the same
card.

    python3 tools/profile_recon.py --split [FILE ...] [--only NAME ...]
    python3 tools/profile_recon.py --split-parent FILE [--only NAME ...]
    python3 tools/profile_recon.py --parent FILE [--reps 5] [--out DIR]

The workloads are chip_smoke.py's main-path shapes, on its inputs: K1 on
config 2's, cfg2t's and lossless's batches of four 1080p frames; K2 on
frame 0 of each; K3-P encode and decode on config 3's and lossless_p's
1080p P picture; K3-B encode and decode on config 4's 3840x2160 and
tools_ra's 1080p B picture.

--split builds the kernel library with X266_RECON_PHASES (the clock64()
phase split of csrc/recon_intra.cu, which the main path's build never
sets), from each FILE in place of csrc/recon_intra.cu (default: the
package's own), and prints, for each workload after a warm launch, the
share of the blocks' cycles in each block-level phase and, per plane and
TU size, the TUs walked and the cycles per TU of each TU phase.  The
phases' slots are the Phase enum of csrc/recon_intra.cu; a source with
another TU pipeline may leave some empty or stamp others.  A FILE without
the split (no x266_recon_phases) is refused.

--split-parent FILE takes the parent commit's recon_intra.cu as ``git
show d418144:x266_tpu_torch/csrc/recon_intra.cu`` gives it, adds the
phase split of tools/recon_intra_d418144_phases.patch (the same Phase
slots around that source's one-thread-per-step pipeline), writes it
beside FILE as <name>_phases.cu and splits it first.

--parent FILE builds FILE in place of csrc/recon_intra.cu (e.g. the
parent commit's, from ``git show REV:x266_tpu_torch/csrc/recon_intra.cu``
into a directory .gitignore lists) and the package's own source, both
without the phase split, checks that both give the same outputs on
every workload, and times each workload with both libraries in turns
(parent, new, new, parent; chip_smoke.event_ms, --reps launches each),
with the TUs each launch walks (from the size map) and both times per
CTU and per luma TU on the wavefront's chain (chip_smoke.tu_walk).

Libraries go to build/x266_tpu_torch/profile-<hash>/ (ignored by git),
each through _build.Library with the package's flags
(profile_common.build); JSON results to DIR (default build/profile).
Fails when no CUDA device is visible.
"""

import argparse
import ctypes
import json
import os
import re
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import profile_common as pc  # noqa: E402
from x266_tpu_torch import _build, tables  # noqa: E402
from x266_tpu_torch.core.yuv import synthetic_clip  # noqa: E402
from x266_tpu_torch.engine import fused, inter, recon_cuda  # noqa: E402

RECON = os.path.join(_build.PKG, "csrc", "recon_intra.cu")
# the recon kernels' SDH and DQ instances and their CCLM ones, compiled
# beside RECON
RECON_QUANT = os.path.join(_build.PKG, "csrc", "recon_quant.cu")
RECON_CCLM = os.path.join(_build.PKG, "csrc", "recon_cclm.cu")
# the phase split added to the parent commit's recon_intra.cu (d418144),
# at the same Phase slots as the package's
PARENT_PATCH = os.path.join(ROOT, "tools", "recon_intra_d418144_phases.patch")
# csrc/recon_intra.cu's Phase enum and its slots
BLOCK_PHASES = {2: "MV state / staging", 0: "row wait", 1: "window load",
                13: "CU set-up", 12: "the CUs' TUs", 3: "window store"}
TU_PHASES = ["ref load", "substitution", "extension", "prediction",
             "forward transform", "quant / level load", "dequant",
             "inverse vertical", "inverse horizontal + write"]
N_PHASES, SLOTS = 16, 14 * 16
PLANES = ("Y", "Cb", "Cr")
SIZES = (4, 8, 16, 32)                      # csrc size_index order


class OlderSignature:
    """A library built from an older recon_intra.cu, whose
    x266_recon_intra / x266_recon_inter lack arguments that the wrappers
    pass: calls reach it without them (drop_intra / drop_inter, the
    dropped positions), each of which must be 0 (flags) or a table the
    older source never reads."""

    def __init__(self, lib, drop_intra, drop_inter, zero_intra,
                 zero_inter):
        self.lib = lib
        self.drop = {"x266_recon_intra": (drop_intra, zero_intra),
                     "x266_recon_inter": (drop_inter, zero_inter)}

    def __getattr__(self, name):
        if name not in self.drop:
            return getattr(self.lib, name)
        drop, zero = self.drop[name]

        def call(*a):
            assert all(a[i] == 0 for i in zero), (
                f"this source's {name} has no such tool")
            return getattr(self.lib, name)(
                *(v for i, v in enumerate(a) if i not in drop))

        return call


def declare_older(lib, sdh_dq: bool, mtt: bool = False):
    """The C signatures of an older library: without the cclm argument
    and the mts map out (mtt: the source has mtt and lfnst and the LFNST
    table), without those and mtt, lfnst and the LFNST table (sdh_dq: the
    source has sdh and dq), or without those and sdh and dq too."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    q = 2 if sdh_dq else 0
    m = 2 if mtt else 0
    lib.x266_recon_intra.argtypes = (
        [i] * 9 + [fl] + [i] * (7 + q + m) + [p] * (22 + (mtt)) + [p])
    lib.x266_recon_intra.restype = i
    lib.x266_recon_inter.argtypes = (
        [i] * 8 + [fl] + [i] * (12 + q) + [p] * 35 + [p])
    lib.x266_recon_inter.restype = i
    lib.x266_error_string.argtypes = [i]
    lib.x266_error_string.restype = ctypes.c_char_p
    return lib


def quant_part(recon_src: str) -> str:
    """The SDH / DQ instances of an older recon_intra.cu: a file beside it,
    <name>_quant.cu, that compiles it with X266_RECON_QUANT_PART (as
    csrc/recon_quant.cu compiles the package's); its path."""
    out = os.path.splitext(recon_src)[0] + "_quant.cu"
    with open(out, "w") as f:
        f.write("#define X266_RECON_QUANT_PART\n"
                f'#include "{os.path.basename(recon_src)}"\n')
    return out


def build(recon_src: str, phases: bool):
    """A library of recon_src, a version of csrc/recon_intra.cu (the
    phase split on when phases; the package's own with
    csrc/recon_quant.cu, an older one with its quant_part when it has
    the SDH / DQ instances), built by _build.Library into
    build/x266_tpu_torch/profile-<hash>/; a source without the mtt and
    lfnst arguments (or the sdh and dq ones) comes wrapped in
    OlderSignature."""
    with open(recon_src) as f:
        text = f.read()
    sdh_dq, mtt = "int sdh, int dq" in text, "int mtt," in text
    cclm = "int cclm," in text
    if recon_src == RECON:
        srcs = [recon_src, RECON_QUANT, RECON_CCLM]
    elif "X266_RECON_QUANT_PART" in text:
        srcs = [recon_src, quant_part(recon_src)]
    else:
        srcs = [recon_src]
    so = pc.build(srcs, ["X266_RECON_PHASES"] if phases else [],
                  _build.declare_recon if cclm
                  else (lambda lib: declare_older(lib, sdh_dq, mtt))).lib
    if not cclm:
        # x266_recon_intra: sdh, dq at 17, 18; mtt, lfnst at 19, 20; cclm
        # at 21; the LFNST table at 43 and the mts map out at 44;
        # x266_recon_inter: sdh, dq at 16, 17
        so = (OlderSignature(so, {21, 44}, set(), {21}, set()) if mtt else
              OlderSignature(so, {19, 20, 21, 43, 44}, set(), {19, 20, 21},
                             set()) if sdh_dq else
              OlderSignature(so, {17, 18, 19, 20, 21, 43, 44}, {16, 17},
                             {17, 18, 19, 20, 21}, {16, 17}))
    if phases:
        if not hasattr(so, "x266_recon_phases"):
            raise SystemExit(
                f"profile_recon: {os.path.relpath(recon_src, ROOT)} has no "
                "phase split (no x266_recon_phases under X266_RECON_PHASES); "
                "for the parent commit's source use --split-parent")
        so.x266_recon_phases.argtypes = [ctypes.c_void_p]
        so.x266_recon_phases.restype = ctypes.c_int
    return so


class Workload:
    """One recon launch at a main-path shape: name, kernel, its config,
    its size map (numpy) and run(lib) -> outputs on the current stream."""

    def __init__(self, name, kernel, cfg, size_map, run):
        self.name, self.kernel, self.cfg = name, kernel, cfg
        self.size_map, self.run = size_map, run


def intra_workloads(lib, tag, cfg, kind):
    """K1 on a batch of four frames, K2 on frame 0 of its levels."""
    tab, src, maps = cs._inputs(cfg, 4, 0, kind)
    got = pc.checked(recon_cuda._launch(lib, pc.stream(), cfg, tab, True,
                                        *src, *maps))
    one = [t[:1].contiguous() for t in (*got[3:], *maps)]
    sm = maps[0].cpu().numpy()
    return [
        Workload(f"K1 {tag} x4", "K1", cfg, sm,
                 lambda lib: pc.checked(recon_cuda._launch(
                     lib, pc.stream(), cfg, tab, True, *src, *maps))),
        Workload(f"K2 {tag}", "K2", cfg, sm[:1],
                 lambda lib: pc.checked(recon_cuda._launch(
                     lib, pc.stream(), cfg, tab, False, *one)))]


def inter_workloads(lib, tag, cfg, b, planes, p0, p1=None):
    """K3-P (or K3-B with p1) encode and decode on one picture."""
    tab = tables.from_reference(cfg, "cuda")
    src = fused._unpack_padded(cfg, *planes)
    if b:
        maps = inter.make_mode_decision_b_raw(cfg, tab)(src[0][0], p0[0],
                                                       p1[0])
    else:
        maps = inter.make_mode_decision_p_raw(cfg, tab)(src[0][0], p0[0])
    maps = [m[None].contiguous() for m in maps]
    mts = torch.zeros_like(maps[0])
    args = (maps[0], maps[1], mts, *maps[2:5], *p0)
    if b:
        args += (*p1, maps[5], maps[6])
    got = pc.checked(recon_cuda._launch_inter(lib, pc.stream(), cfg, tab,
                                              True, *src, *args))
    dargs = (*got[3:6], *args[:4], got[6].int(), got[7].int(), *args[6:])
    k = "K3B" if b else "K3"
    sm = maps[0].cpu().numpy()
    return [
        Workload(f"{k} {tag}", k, cfg, sm,
                 lambda lib: pc.checked(recon_cuda._launch_inter(
                     lib, pc.stream(), cfg, tab, True, *src, *args))),
        Workload(f"{k}d {tag}", k + "d", cfg, sm,
                 lambda lib: pc.checked(recon_cuda._launch_inter(
                     lib, pc.stream(), cfg, tab, False, *dargs)))]


def workloads(lib, only=()):
    """chip_smoke.py's main-path recon shapes (see the module doc)."""
    out = []
    want = (lambda tag: not only or any(o in tag for o in only))
    for tag, cfg, kind in (("config2", cs.main_cfg(), "mixed"),
                           ("cfg2t", cs.cfg2t(), "text"),
                           ("lossless", cs.lossless_cfg(), "mixed")):
        if want(tag):
            out += intra_workloads(lib, tag, cfg, kind)
    if want("config3"):
        cfg = cs.cfg3()
        planes = cs._upload(synthetic_clip(1920, 1080, 1, "mixed", seed=3))
        refs = [torch.roll(p[0], sh, (0, 1))
                for p, sh in zip(planes, ((2, -3), (1, -1), (1, -1)))]
        out += inter_workloads(lib, "config3", cfg, False, planes,
                               fused.build_pyramids_device(*refs))
    if want("lossless_p"):
        planes = cs._upload(synthetic_clip(1920, 1080, 1, "motion", seed=9))
        out += inter_workloads(lib, "lossless_p", cs.lossless_p_cfg(), False,
                               planes, cs.b_references(planes, amp=40)[0])
    if want("4K"):
        planes = cs._upload(synthetic_clip(3840, 2160, 1, "mixed", seed=21))
        out += inter_workloads(lib, "4K", cs.cfg4(), True, planes,
                               *cs.b_references(planes))
    if want("tools_ra"):
        planes = cs._upload(synthetic_clip(1920, 1080, 1, "motion", seed=9))
        out += inter_workloads(lib, "tools_ra", cs.tools_ra_cfg(), True,
                               planes, *cs.b_references(planes, amp=40))
    return out


def split(lib, wl) -> dict:
    """One launch's phase split (after a warm launch)."""
    buf = np.zeros(SLOTS, dtype=np.uint64)
    wl.run(lib)
    if lib.x266_recon_phases(buf.ctypes.data) != 0:
        raise RuntimeError("reading the phase split failed")
    wl.run(lib)
    if lib.x266_recon_phases(buf.ctypes.data) != 0:
        raise RuntimeError("reading the phase split failed")
    ph = buf.astype(np.float64).reshape(14, N_PHASES)
    block = ph[12]
    total = block[14]
    res = {"workload": wl.name, "block_cycles": total,
           "block": {name: block[i] / total for i, name in
                     BLOCK_PHASES.items()},
           "tus": {}}
    for p, plane in enumerate(PLANES):
        for si, s in enumerate(SIZES):
            n = ph[13][p * 4 + si]
            if n == 0:
                continue
            cyc = ph[p * 4 + si][4:13]
            res["tus"][f"{plane} {s}x{s}"] = {
                "count": int(n), "cycles_per_tu": float(cyc.sum() / n),
                "phases": {name: float(c / n)
                           for name, c in zip(TU_PHASES, cyc)}}
    return res


def print_split(r):
    blk = ", ".join(f"{k} {100 * v:.1f} %" for k, v in r["block"].items())
    print(f"[split] {r['workload']}: {r['block_cycles']:.4g} block cycles; "
          f"{blk}", flush=True)
    for key, t in r["tus"].items():
        ph = ", ".join(f"{k} {v:.0f}" for k, v in t["phases"].items())
        print(f"[split] {r['workload']} {key}: {t['count']} TUs, "
              f"{t['cycles_per_tu']:.0f} cycles per TU: {ph}", flush=True)


def compare(parent, new, wl, reps) -> dict:
    """Both libraries on one workload: equal outputs, then the times in
    turns, the TUs walked and the microseconds per chain TU."""
    a, b = wl.run(parent), wl.run(new)
    same = [torch.equal(x, y) for x, y in zip(a, b)]
    if not all(same):
        print(f"[compare] {wl.name}: outputs differ: {same}", flush=True)
        return {"workload": wl.name, "equal": False}
    t = pc.in_turns(parent, new, wl.run, reps)
    ms_parent, ms_new = t["ms_parent"], t["ms_new"]
    walk = cs.tu_walk(wl.size_map, wl.cfg.width, wl.cfg.height)
    r = {"workload": wl.name, "equal": True, "kernel": wl.kernel, **t,
         **walk, "parent": cs.per_chain(walk, ms_parent),
         "new": cs.per_chain(walk, ms_new)}
    print(f"[compare] {wl.name}: parent {ms_parent:.3f} ms, new "
          f"{ms_new:.3f} ms ({r['speedup']:.2f}x; turns "
          f"{[round(x, 3) for x in t['turns_ms']]}); outputs equal; "
          f"{cs.chain_text(walk, parent=ms_parent, new=ms_new)}",
          flush=True)
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split", nargs="*")
    ap.add_argument("--split-parent")
    ap.add_argument("--parent")
    ap.add_argument("--only", nargs="*", default=())
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_recon: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"[env] {card}; torch {torch.__version__}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    result = {"card": card}
    result["split"] = {}
    sources = [RECON] if args.split == [] else list(args.split or [])
    if args.split_parent:
        sources.insert(0, parent_phases(args.split_parent))
    for src in sources:
        print(f"[split] source {os.path.relpath(src, ROOT)}", flush=True)
        lib = build(src, True)
        rows = result["split"][os.path.relpath(src, ROOT)] = []
        for wl in workloads(lib, args.only):
            rows.append(split(lib, wl))
            print_split(rows[-1])
    if args.parent:
        parent, new = build(args.parent, False), build(RECON, False)
        result["compare"] = [compare(parent, new, wl, args.reps)
                             for wl in workloads(new, args.only)]
    with open(os.path.join(args.out, "profile_recon.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"[done] {card}", flush=True)
    return int(not all(r["equal"] for r in result.get("compare", [])))


if __name__ == "__main__":
    sys.exit(main())
