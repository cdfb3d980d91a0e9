"""Warm encode rates of chip_smoke.py's dependent-quantization main paths
for two checkouts of the repo, in turns on one NVIDIA GPU.

    python3 tools/compare_rates.py PARENT_ROOT [--reps 5] [--out DIR]

PARENT_ROOT is another checkout (e.g. ``git archive REV`` unpacked into a
directory .gitignore lists).  Each turn runs, in a child process on the
checkout's own code (its kernels built from its sources into its build
directory), [main-dq] (config 2 with DQ, frames 0-3 of 'mixed' at 1080p,
batches of 4) and [main-p-dq] (cfg3dq, frames 0-3 of 'motion'): one
encode to warm up, then REPS encodes on the host clock.  Both trees are
built first, at once; the turns go parent, this tree, this tree, parent.
Prints each turn's frames a second (median of its encodes) and each
tree's mean of its two turns, fails unless both trees write the same
bitstreams, and writes compare_rates.json to DIR (default build/profile).
Fails when no CUDA device is visible.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the child: run from a checkout's root, prints one JSON line
CHILD = r"""
import hashlib, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
# TF32 off, as the encoder requires on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
from x266_tpu_torch.api import Encoder
from x266_tpu_torch.core.yuv import synthetic_clip

reps = int(sys.argv[1])
paths = {"main-dq": (cs.main_cfg().replace(dep_quant=True), "mixed",
                     {"batch_frames": 4}),
         "main-p-dq": (cs.cfg3dq(), "motion", {})}
out = {}
for tag, (cfg, kind, kw) in paths.items():
    frames = synthetic_clip(cfg.width, cfg.height, 4, kind)
    enc = Encoder(cfg, with_recon=True, **kw)
    md5 = hashlib.md5(enc.encode(frames).bitstream).hexdigest()
    fps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        enc.encode(frames)
        fps.append(4 / (time.perf_counter() - t0))
    out[tag] = {"md5": md5, "fps": fps}
print(json.dumps(out))
"""


def child(root: str, reps: int) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", CHILD, str(reps)],
                            cwd=root, stdout=subprocess.PIPE, text=True)


def result(job: subprocess.Popen) -> dict:
    out, _ = job.communicate(timeout=900)
    if job.returncode != 0:
        raise SystemExit(f"child exited {job.returncode}")
    return json.loads(out.strip().splitlines()[-1])


TURNS = ("parent", "new", "new", "parent")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    roots = {"parent": os.path.abspath(args.parent), "new": ROOT}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    warm = {k: child(r, 0) for k, r in roots.items()}   # build both
    md5 = {k: result(j) for k, j in warm.items()}
    runs = [(k, result(child(roots[k], args.reps))) for k in TURNS]
    summary = {}
    for tag in ("main-dq", "main-p-dq"):
        if md5["parent"][tag]["md5"] != md5["new"][tag]["md5"]:
            raise SystemExit(f"{tag}: the trees' bitstreams differ")
        turns = [(k, statistics.median(r[tag]["fps"])) for k, r in runs]
        mean = {k: statistics.mean(f for t, f in turns if t == k)
                for k in roots}
        summary[tag] = {"turns": turns, "mean_fps": mean,
                        "runs": [(k, r[tag]["fps"]) for k, r in runs]}
        print(f"[rates] {tag}: parent {mean['parent']:.3f} fps, new "
              f"{mean['new']:.3f} fps ({mean['new'] / mean['parent']:.3f}x;"
              f" turns {[round(f, 3) for _, f in turns]}); bitstreams "
              f"equal; on {card}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "compare_rates.json"), "w") as f:
        json.dump({"card": card, "parent": roots["parent"],
                   "reps": args.reps, "paths": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
