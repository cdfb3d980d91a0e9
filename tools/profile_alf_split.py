"""Where CC-ALF's gate and the class SSE (ALFCLS) spend their time on one
NVIDIA GPU: builds of csrc/alf.cu with edits, written to build/profile/
(the package's source is never changed).

    python3 tools/profile_alf_split.py [--reps 20] [--out DIR]

On chip_smoke.py [kernels-alf]'s encoder and noise planes:
- stamps: a copy with globaltimer stamps in the gate's last block (the
  CTB part, from the first block's start to the last ticket; the kept
  gains' loads; the lanes; thread 0's fold and remaining rows), at 4K
  and 1080p, and clock64 counts of the ordered class chains' walker
  (warp 0) and first compacting warp (working, waiting at the tile
  barrier) at 4K;
- variants, timed in turns (each in order, then in reverse; CUDA
  events): the package's source ("new"), without the gate's tail
  ("notail"), with relaxed ticket atomics too ("relaxed_notail"),
  without the block SSEs' stores ("nodblk"), with 2 or 8 blocks a
  thread in the exact pass ("cls2", "cls8") and without the ordered
  walk ("light"): the gate (the CTB call with it less the call without
  it) and the class SSE at 4K, with the class SSE's device time by
  kernel (torch.profiler).  Only "new" is held to the plain versions;
  the others compute other things.
Prints each line and writes profile_alf_split.json to DIR (default
build/profile).  Fails when no CUDA device is visible.
"""

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
from x266_tpu_torch import _build  # noqa: E402
from x266_tpu_torch.kernels import alf as kalf  # noqa: E402
from x266_tpu_torch.kernels import alf_cuda  # noqa: E402

SRC = os.path.join(ROOT, "x266_tpu_torch", "csrc", "alf.cu")
NO_TAIL = ("    if (gate) ccalf_gate(p);",
           "    if (gate && tid == 0) { p.worth[0] = 0; *p.ticket = 0; }")
VARIANTS = {
    "new": [],
    "notail": [NO_TAIL],
    "relaxed_notail": [NO_TAIL, ("x266_atom_add_acq_rel(p.ticket, 1)",
                                 "atomicAdd(p.ticket, 1ull)")],
    "nodblk": [("        p.dblk[(size_t)lv * p.n + b] = acc;\n", "")],
    "cls2": [("constexpr int kClsPerThread = 4;",
              "constexpr int kClsPerThread = 2;")],
    "cls8": [("constexpr int kClsPerThread = 4;",
              "constexpr int kClsPerThread = 8;")],
    "light": [("  if (any) {\n    float* s = (float*)slot;",
               "  if (false) {\n    float* s = (float*)slot;")],
}
STAMPS = [
    ('#include "x266_device.cuh"\n', '''#include "x266_device.cuh"
__device__ unsigned long long g_stamp[8];
__device__ long long g_cyc[128][4];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''),
    ("  const int ctb = p.mode == 0 ? 64 : 32, nw = p.mode == 0 ? 4 : 1;\n",
     "  const int ctb = p.mode == 0 ? 64 : 32, nw = p.mode == 0 ? 4 : 1;\n"
     "  if (GATE && tid == 0) atomicMin(&g_stamp[0], gtime());\n"),
    ("             (unsigned long long)(p.cy * p.cx - 1);\n",
     "             (unsigned long long)(p.cy * p.cx - 1);\n"
     "    if (GATE && last) g_stamp[1] = gtime();\n"),
    ("  __syncthreads();\n  const int nl = p.cy == 4 ? 4 : p.cy >= 8 ? 8 : 0;",
     "  __syncthreads();\n  if (tid == 0) g_stamp[2] = gtime();\n"
     "  const int nl = p.cy == 4 ? 4 : p.cy >= 8 ? 8 : 0;"),
    ("    lanes[tid] = acc;\n  }\n  __syncthreads();\n  if (tid == 0) {",
     "    lanes[tid] = acc;\n  }\n  __syncthreads();\n"
     "  if (tid == 0) g_stamp[3] = gtime();\n  if (tid == 0) {"),
    ("    *p.ticket = 0;\n", "    *p.ticket = 0;\n    g_stamp[4] = gtime();\n"),
    ("  for (int t = 0; t <= tiles; ++t) {\n    const int buf = t & 1;",
     "  long long cw = 0, cs = 0;\n"
     "  for (int t = 0; t <= tiles; ++t) {\n"
     "    const long long c0 = clock64();\n    const int buf = t & 1;"),
    ("    __syncthreads();\n  }\n  return past ? acc : (float)exact;",
     "    const long long c1 = clock64();\n    __syncthreads();\n"
     "    cw += c1 - c0;\n    cs += clock64() - c1;\n  }\n"
     "  if (q == 0 && warp <= 1) {\n"
     "    g_cyc[blockIdx.x][2 * warp] = cw;\n"
     "    g_cyc[blockIdx.x][2 * warp + 1] = cs;\n  }\n"
     "  return past ? acc : (float)exact;"),
]
STAMPS_TAIL = '''
extern "C" int x266_stamps(void* stamp, void* cyc, int reset) {
  if (reset) {
    unsigned long long s[8] = {~0ull, 0, 0, 0, 0, 0, 0, 0};
    long long c[128][4] = {};
    cudaMemcpyToSymbol(g_stamp, s, sizeof(s));
    return (int)cudaMemcpyToSymbol(g_cyc, c, sizeof(c));
  }
  cudaMemcpyFromSymbol(stamp, g_stamp, sizeof(g_stamp));
  return (int)cudaMemcpyFromSymbol(cyc, g_cyc, sizeof(g_cyc));
}
'''


def edited(edits, text=None) -> str:
    """csrc/alf.cu with each (anchor, replacement) applied; an anchor must
    occur exactly once."""
    text = open(SRC).read() if text is None else text
    for a, b in edits:
        if text.count(a) != 1:
            raise ValueError(f"anchor not found once in alf.cu: {a[:60]!r}")
        text = text.replace(a, b)
    return text


def declare(lib):
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.x266_alf_ctb_flags.argtypes = [i] * 3 + [fl] + [p] * 6 + [fl, p, p, p]
    lib.x266_alf_ctb_flags.restype = i
    lib.x266_alf_class_sse.argtypes = [i] * 3 + [p] * 8
    lib.x266_alf_class_sse.restype = i
    if hasattr(lib, "x266_stamps"):
        lib.x266_stamps.argtypes = [p, p, i]
        lib.x266_stamps.restype = i
    return lib


def build_all(out_dir) -> dict:
    """The variants and the stamped copy, built at once: name -> CDLL."""
    os.makedirs(out_dir, exist_ok=True)
    texts = {n: edited(e) for n, e in VARIANTS.items()}
    texts["stamps"] = edited(STAMPS) + STAMPS_TAIL
    libs = {}
    for name, text in texts.items():
        path = os.path.join(out_dir, f"alf_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        libs[name] = _build.Library([path], [], "profile-", declare)
    with cf.ThreadPoolExecutor(len(libs)) as ex:
        for fut in [ex.submit(lib.build) for lib in libs.values()]:
            fut.result()
    return {n: lib.lib for n, lib in libs.items()}


def planes(data, kind):
    """(levels, o32, cls32, chroma planes, lam) of a data set."""
    o, r, lam = data[kind]["luma"]
    oc, rc, _ = data[kind]["chroma"]
    filts, cls, _ = cs.nl_levels(o, r)
    chrom = [x.int().contiguous() for x in (cs.cc_filtered(r, rc, oc), rc,
                                            oc)]
    return filts, o.int().contiguous(), cls.int().contiguous(), chrom, lam


def stamps(lib, tag, chrom, lam, levels=None):
    """The gate's phases (ns, three calls) and, with levels = (filts, o,
    cls), the ordered chains' cycles."""
    stream = torch.cuda.current_stream().cuda_stream
    ticket, tot = alf_cuda.new_work("cuda")
    worth = torch.empty(1, dtype=torch.int32, device="cuda")
    stamp = (ctypes.c_ulonglong * 8)()
    cyc = (ctypes.c_longlong * 512)()
    out = {"gate_ns": []}
    for _ in range(3):
        lib.x266_stamps(None, None, 1)
        alf_cuda._launch_flags(lib, stream, *chrom, 32, lam, False, worth,
                               ticket)
        torch.cuda.synchronize()
        lib.x266_stamps(stamp, cyc, 0)
        s = list(stamp)
        out["gate_ns"].append({"ctb_part": s[1] - s[0], "loads": s[2] - s[1],
                               "lanes": s[3] - s[2], "thread0": s[4] - s[3]})
    print(f"[split] {tag} gate's last block (ns): {out['gate_ns']}",
          flush=True)
    if levels is not None:
        lib.x266_stamps(None, None, 1)
        alf_cuda._launch_class(lib, stream, *levels, tot)
        torch.cuda.synchronize()
        lib.x266_stamps(stamp, cyc, 0)
        rows = {b: list(cyc[4 * b:4 * b + 4]) for b in range(128)
                if any(cyc[4 * b:4 * b + 4])}
        out["chains_cycles"] = rows
        print(f"[split] {tag} ordered chains, (level * 25 + class): [walker "
              f"working, waiting, compacting warp working, waiting] cycles "
              f"{rows}", flush=True)
    return out


def variants(libs, tag, levels, chrom, lam, want, reps) -> dict:
    stream = torch.cuda.current_stream().cuda_stream
    ticket, tot = alf_cuda.new_work("cuda")
    worth = torch.empty(1, dtype=torch.int32, device="cuda")

    def gate(lib):
        return alf_cuda._launch_flags(lib, stream, *chrom, 32, lam, False,
                                      worth, ticket)

    def flags(lib):
        return alf_cuda._launch_flags(lib, stream, *chrom, 32, lam, False)

    def cls_sse(lib):
        return alf_cuda._launch_class(lib, stream, *levels, tot, False)

    got = cls_sse(libs["new"])[1][0]
    if not torch.equal(got, want[0]):
        raise AssertionError(f"{tag}: the class SSE differs from the plain")
    gate(libs["new"])
    if (not torch.equal(flags(libs["new"])[1][0], want[1])
            or bool(worth[0]) != bool(want[2])):
        raise AssertionError(f"{tag}: the gate differs from the plain")
    names = list(libs)
    res = {n: {"gate": [], "flags": [], "cls": []} for n in names}
    for n in names + names[::-1]:
        for key, fn in (("gate", gate), ("flags", flags), ("cls", cls_sse)):
            res[n][key].append(cs.event_ms(fn, libs[n], reps=reps))
    import profile_alf as pa
    for n in names:
        r = res[n]
        r["gate_ms"] = (sum(r["gate"]) - sum(r["flags"])) / 2
        r["cls_ms"] = sum(r["cls"]) / 2
        r["cls_by_kernel_ms"] = pa.device_ms_by_kernel(cls_sse, reps, libs[n])
        print(f"[split] {tag} {n}: gate {r['gate_ms']:.4f} ms, class sse "
              f"{r['cls_ms']:.4f} ms, by kernel {r['cls_by_kernel_ms']}",
              flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_alf_split: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build_all(args.out)
    stamped = libs.pop("stamps")
    out = {"card": cs.card_line(), "variants": list(libs)}
    for w, h in ((3840, 2160), (1920, 1080)):
        data = cs._alf_data(w, h, 31)
        for kind in ("encoder", "noise"):
            tag = f"{w}x{h} {kind}"
            filts, o, cls, chrom, lam = planes(data, kind)
            levels = (filts, o, cls)
            out[f"{tag} stamps"] = stamps(stamped, tag, chrom, lam,
                                          levels if w == 3840 else None)
            if w == 3840:
                want = (kalf.class_sse_plain(filts.int(), o, cls),
                        *kalf._ccalf_gate(*chrom, lam))
                out[f"{tag} variants"] = variants(libs, tag, levels, chrom,
                                                  lam, want, args.reps)
    print(out["card"])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_alf_split.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
