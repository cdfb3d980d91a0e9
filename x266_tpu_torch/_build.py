"""Build and load the port's CUDA kernels.

The sources in csrc/ have a plain C interface and are compiled with nvcc
into one shared library on first use, keyed by a hash of the sources:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/x266_tpu_torch/<hash>/libx266k.so

then loaded with ctypes (no PyTorch headers, so the build takes seconds).
-fmad=false keeps float32 expressions from being contracted into fused
multiply-adds, which round differently from the reference's decisions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
SOURCES = sorted(glob.glob(os.path.join(PKG, "csrc", "*.cu")))
HEADERS = sorted(glob.glob(os.path.join(PKG, "csrc", "*.cuh")))
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH)")
    return path


def source_hash() -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


class Library:
    """The loaded kernel library; build() makes it on first use."""

    def __init__(self):
        self.lib = None
        self.build_log = ""

    def build(self) -> ctypes.CDLL:
        if self.lib is not None:
            return self.lib
        out_dir = os.path.join(ROOT, "build", "x266_tpu_torch", source_hash())
        so = os.path.join(out_dir, "libx266k.so")
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            proc = subprocess.run([nvcc_path(), *FLAGS, "-o", tmp, *SOURCES],
                                  capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + self.build_log)
            os.replace(tmp, so)
        self.lib = declare(ctypes.CDLL(so))
        return self.lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the library's entry points."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.x266_recon_intra.argtypes = (
        [i] * 9 + [fl] + [i] * 7 + [p] * 22 + [p])   # ..., sync, stream
    lib.x266_recon_intra.restype = i
    lib.x266_recon_inter.argtypes = (
        [i] * 8 + [fl] + [i] * 12 + [p] * 35 + [p])  # ..., sync, stream
    lib.x266_recon_inter.restype = i
    lib.x266_warp_frames.argtypes = [i] * 5 + [p] * 4
    lib.x266_warp_frames.restype = i
    lib.x266_refine_search.argtypes = [i] * 4 + [p] * 5
    lib.x266_refine_search.restype = i
    lib.x266_alf_normal.argtypes = [i] * 4 + [p] * 3 + [i] * 6 + [p] * 11
    lib.x266_alf_normal.restype = i
    lib.x266_alf_ctb_flags.argtypes = [i] * 3 + [fl] + [p] * 7
    lib.x266_alf_ctb_flags.restype = i
    lib.x266_plane_sse.argtypes = [i] * 3 + [p] * 6
    lib.x266_plane_sse.restype = i
    lib.x266_error_string.argtypes = [i]
    lib.x266_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = Library()


def check(err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = LIBRARY.build().x266_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")
