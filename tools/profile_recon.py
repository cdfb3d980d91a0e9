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
tools_ra's 1080p B picture; and the SDH and DQ instances on
chip_smoke.py time_quant_flags's shapes (K1 on config 2's batch, K3-P on
config 3's and K3-B on config 4's 1080p picture, each with SDH and with
DQ, and the DQ decodes): ``--only sdh dq`` takes those alone.

--split builds the kernel library with X266_RECON_PHASES (the clock64()
phase split of csrc/recon_intra.cu, which the main path's build never
sets), from each FILE in place of csrc/recon_intra.cu (default: the
package's own), and prints, for each workload after a warm launch, the
share of the blocks' cycles in each block-level phase and, per plane and
TU size, the TUs walked and the cycles per TU of each TU phase (under
SDH and DQ also the quantizer's own steps, csrc/recon_intra.cu's
kPhDq* / kPhSdh*, taken out of its quant phase).  The
phases' slots are the Phase enum of csrc/recon_intra.cu; a source with
another TU pipeline may leave some empty or stamp others.  A FILE without
the split (no x266_recon_phases) is refused.

--split-parent FILE takes a parent commit's recon_intra.cu as ``git show
REV:x266_tpu_torch/csrc/recon_intra.cu`` gives it, saved as
recon_intra_REV.cu, adds the phase split of
tools/recon_intra_REV_phases.patch (d418144: the same Phase slots around
that source's one-thread-per-step pipeline; 74ae6c4: the sums of its
SDH / DQ and CCLM parts, which its own split left out), writes it beside
FILE as <name>_phases.cu and splits it first.

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
# the recon kernels' SDH and DQ instances, their CCLM ones and their CU-64
# ones (without and with CCLM), compiled beside RECON
RECON_PARTS = [os.path.join(_build.PKG, "csrc", f"recon_{name}.cu")
               for name in ("quant", "cclm", "cu64", "cu64_cclm")]
# csrc/recon_intra.cu's Phase enum and its slots
BLOCK_PHASES = {2: "MV state / staging", 0: "row wait", 1: "window load",
                13: "CU set-up", 12: "the CUs' TUs", 3: "window store"}
TU_PHASES = ["ref load", "substitution", "extension", "prediction",
             "forward transform", "quant / level load", "dequant",
             "inverse vertical", "inverse horizontal + write"]
# a TU row's slots 0-3: the TU-wide quantizer's own steps (csrc Phase),
# taken out of "quant / level load"
QUANT_STEPS = ["quant step 1", "quant step 2", "quant step 3",
               "quant step 4"]
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


def declare_older(lib, sdh_dq: bool, mtt: bool = False, cclm: bool = False):
    """The C signatures of an older library: without the cu64 argument
    (cclm: the source has cclm and the mts map out), without those and
    the cclm argument and the mts map out (mtt: the source has mtt and
    lfnst and the LFNST table), without those and mtt, lfnst and the
    LFNST table (sdh_dq: the source has sdh and dq), or without those and
    sdh and dq too."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    q = 2 if sdh_dq else 0
    m = 2 if mtt else 0
    lib.x266_recon_intra.argtypes = (
        [i] * 9 + [fl] + [i] * (7 + q + m + cclm)
        + [p] * (22 + mtt + cclm) + [p])
    lib.x266_recon_intra.restype = i
    lib.x266_recon_inter.argtypes = (
        [i] * 8 + [fl] + [i] * (12 + q) + [p] * 35 + [p])
    lib.x266_recon_inter.restype = i
    lib.x266_error_string.argtypes = [i]
    lib.x266_error_string.restype = ctypes.c_char_p
    return lib


def part(recon_src: str, name: str) -> str:
    """One part of a recon_intra.cu (name "quant": its SDH / DQ
    instances, "cclm": its CCLM ones, "cu64" and "cu64_cclm": its CU-64
    ones): a file beside it, <src>_<name>.cu, that compiles it with
    X266_RECON_<NAME>_PART, as csrc/recon_<name>.cu compiles the
    package's; its path."""
    out = os.path.splitext(recon_src)[0] + f"_{name}.cu"
    with open(out, "w") as f:
        f.write(f"#define X266_RECON_{name.upper()}_PART\n"
                f'#include "{os.path.basename(recon_src)}"\n')
    return out


def apply_patch(text: str, patch: str) -> str:
    """text with a unified diff's hunks applied in order; raises where a
    hunk's context or removed lines are not text's at that place."""
    lines = text.splitlines(keepends=True)
    out, pos = [], 0
    parts = re.split(r"^@@ -(\d+)(?:,\d+)? \+\d+(?:,\d+)? @@.*\n", patch,
                     flags=re.M)
    for start, body in zip(parts[1::2], parts[2::2]):
        start = int(start) - 1
        if start < pos:
            raise ValueError(f"patch hunk at line {start + 1} overlaps")
        out += lines[pos:start]
        pos = start
        for line in body.splitlines(keepends=True):
            tag, rest = line[0], line[1:]
            if tag in " -":
                if pos >= len(lines) or lines[pos] != rest:
                    raise ValueError(f"patch does not apply at line {pos + 1}")
                if tag == " ":
                    out.append(rest)
                pos += 1
            elif tag == "+":
                out.append(rest)
    return "".join(out + lines[pos:])


def parent_phases(src: str) -> str:
    """A parent commit's recon_intra.cu (src, named recon_intra_<rev>.cu
    as ``git show <rev>:...`` gives it) with the phase split of
    tools/recon_intra_<rev>_phases.patch, written beside src as
    <name>_phases.cu; its path."""
    name = os.path.splitext(os.path.basename(src))[0]
    with open(src) as f, open(os.path.join(
            ROOT, "tools", f"{name}_phases.patch")) as g:
        text = apply_patch(f.read(), g.read())
    out = os.path.splitext(src)[0] + "_phases.cu"
    with open(out, "w") as f:
        f.write(text)
    return out


def build(recon_src: str, phases: bool):
    """A library of recon_src, a version of csrc/recon_intra.cu (the
    phase split on when phases; the package's own with
    RECON_PARTS, an older one with the parts it has, part()), built by
    _build.Library
    into build/x266_tpu_torch/profile-<hash>/; a source without the cu64
    argument (or the cclm, the mtt and lfnst, the sdh and dq ones) comes
    wrapped in OlderSignature."""
    with open(recon_src) as f:
        text = f.read()
    sdh_dq, mtt = "int sdh, int dq" in text, "int mtt," in text
    cclm, cu64 = "int cclm," in text, "int cu64," in text
    if recon_src == RECON:
        srcs = [recon_src, *RECON_PARTS]
    else:
        srcs = [recon_src] + [part(recon_src, name)
                              for name in ("quant", "cclm", "cu64",
                                           "cu64_cclm")
                              if f"X266_RECON_{name.upper()}_PART" in text]
    so = pc.build(srcs, ["X266_RECON_PHASES"] if phases else [],
                  _build.declare_recon if cu64
                  else (lambda lib: declare_older(lib, sdh_dq, mtt,
                                                  cclm))).lib
    if not cu64:
        # x266_recon_intra: sdh, dq at 17, 18; mtt, lfnst at 19, 20; cclm
        # at 21; cu64 at 22; the LFNST table at 44 and the mts map out at
        # 45; x266_recon_inter: sdh, dq at 16, 17
        so = (OlderSignature(so, {22}, set(), {22}, set()) if cclm else
              OlderSignature(so, {21, 22, 45}, set(), {21, 22}, set())
              if mtt else
              OlderSignature(so, {19, 20, 21, 22, 44, 45}, set(),
                             {19, 20, 21, 22}, set()) if sdh_dq else
              OlderSignature(so, {17, 18, 19, 20, 21, 22, 44, 45}, {16, 17},
                             {17, 18, 19, 20, 21, 22}, {16, 17}))
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
    return out + quant_workloads(lib, want)


def quant_workloads(lib, want):
    """The SDH and DQ instances on chip_smoke.time_quant_flags's inputs:
    K1 on config 2's batch of four 1080p frames, K3-P on config 3's and
    K3-B on config 4's 1080p picture (both on the VVC profile), each with
    SDH and with DQ; under DQ also the decode (K2 on frame 0, K3d, K3Bd)
    of lib's levels (a decode under SDH is the element-wise instance)."""
    from x266_tpu_torch.config import Profile

    def runner(cfg, tab, pic, encode, inputs):
        if pic == "I":
            return lambda lib: pc.checked(recon_cuda._launch(
                lib, pc.stream(), cfg, tab, encode, *inputs))
        return lambda lib: pc.checked(recon_cuda._launch_inter(
            lib, pc.stream(), cfg, tab, encode, *inputs))

    vvc = dict(profile=Profile.VVC)
    out = []
    for tag, cfg, pic in (("config2", cs.main_cfg(), "I"),
                          ("config3", cs.cfg3().replace(**vvc), "P"),
                          ("config4 1080p",
                           cs.cfg4(1920, 1080).replace(**vvc), "B")):
        for flag in ("sdh", "dq"):
            name = f"{tag} {flag}"
            if not want(name):
                continue
            c = cfg.replace(sign_data_hiding=flag == "sdh",
                            dep_quant=flag == "dq")
            if pic == "I":
                tab, src, maps = cs._inputs(c, 4, 0, "mixed")
                enc_in, args = (*src, *maps), tuple(maps)
            else:
                tab, enc_in, args, maps = cs._quant_inputs(c, pic, 9,
                                                           "motion")
            k, kd = cs.QUANT_KERNELS[pic]
            sm = maps[0].cpu().numpy()
            run = runner(c, tab, pic, True, enc_in)
            out.append(Workload(f"{k} {name}" + (" x4" if pic == "I" else ""),
                                k, c, sm, run))
            if flag != "dq":
                continue
            got = run(lib)
            one = (got[3:6] if pic != "I" else
                   [g[:1].contiguous() for g in got[3:6]])
            a1 = args if pic != "I" else [m[:1].contiguous() for m in args]
            dec_in = cs._dec_inputs(pic, (*got[:3], *one, *got[6:]), a1)
            out.append(Workload(f"{kd} {name}", kd, c,
                                sm[:1] if pic == "I" else sm,
                                runner(c, tab, pic, False, dec_in)))
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
            cyc, steps = ph[p * 4 + si][4:13], ph[p * 4 + si][:4]
            phases = {name: float(c / n) for name, c in zip(TU_PHASES, cyc)}
            phases.update({name: float(c / n) for name, c in
                           zip(QUANT_STEPS, steps) if c})
            res["tus"][f"{plane} {s}x{s}"] = {
                "count": int(n),
                "cycles_per_tu": float((cyc.sum() + steps.sum()) / n),
                "phases": phases}
    # DQ's fallback to dq_dequant: TUs by plane (slots 12-14 of counts)
    if wl.kernel in ("K1", "K3", "K3B") and " dq" in wl.name:
        res["dq_fallback"] = {
            plane: [int(ph[13][12 + p]),
                    int(sum(ph[13][p * 4 + si] for si in range(4)))]
            for p, plane in enumerate(PLANES)}
    return res


def print_split(r):
    blk = ", ".join(f"{k} {100 * v:.1f} %" for k, v in r["block"].items())
    print(f"[split] {r['workload']}: {r['block_cycles']:.4g} block cycles; "
          f"{blk}", flush=True)
    for key, t in r["tus"].items():
        ph = ", ".join(f"{k} {v:.0f}" for k, v in t["phases"].items())
        print(f"[split] {r['workload']} {key}: {t['count']} TUs, "
              f"{t['cycles_per_tu']:.0f} cycles per TU: {ph}", flush=True)
    if "dq_fallback" in r:
        fb = ", ".join(f"{k} {a} of {n}" for k, (a, n) in
                       r["dq_fallback"].items())
        print(f"[split] {r['workload']}: TUs whose dequantization fell back "
              f"to dq_dequant: {fb}", flush=True)


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
