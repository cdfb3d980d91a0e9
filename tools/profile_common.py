"""What tools/profile_recon.py and tools/profile_me.py share: libraries
built from other versions of csrc/ sources, launches on the current
stream, and two libraries timed in turns on one workload."""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from x266_tpu_torch import _build  # noqa: E402


def build(sources, defines, signatures) -> _build.Library:
    """A built library of sources (versions of csrc/ files) with -D
    defines, made by _build.Library with the package's flags into
    build/x266_tpu_torch/profile-<hash>/; prints nvcc's -Xptxas -v lines
    for its kernels (none if it was built before)."""
    lib = _build.Library(sources, list(defines), "profile-", signatures)
    lib.build()
    name = " ".join([*(os.path.relpath(s, ROOT) for s in sources),
                     *(f"-D{d}" for d in defines)])
    for line in cs.build_lines(lib.build_log):
        print(f"[build] {name}: {line}", flush=True)
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def checked(out):
    """The outputs of a launch entry's (error, outputs); raises on an
    error."""
    err, res = out
    if err != 0:
        raise RuntimeError(f"launch failed ({err})")
    return res


def in_turns(parent, new, run, reps) -> dict:
    """run(lib) timed with parent, new, new, parent (chip_smoke.event_ms,
    reps launches each): each library's mean over its two turns."""
    times = [cs.event_ms(run, lib, reps=reps)
             for lib in (parent, new, new, parent)]
    ms_parent = (times[0] + times[3]) / 2
    ms_new = (times[1] + times[2]) / 2
    return {"ms_parent": ms_parent, "ms_new": ms_new, "turns_ms": times,
            "speedup": ms_parent / ms_new}
