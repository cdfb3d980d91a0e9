"""Build and load the port's CUDA kernels.

The sources in csrc/ have a plain C interface and are compiled with nvcc
into one shared library on first use, keyed by a hash of the sources:
one nvcc per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -Xptxas -v -I csrc -c csrc/<name>.cu -o <name>.o

then one link, ``nvcc -gencode ... -shared -o
build/x266_tpu_torch/<hash>/libx266k.so *.o``, loaded with ctypes (no PyTorch headers, so the build takes
seconds).
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH)")
    return path


def source_hash(sources, flags) -> str:
    h = hashlib.sha256()
    for src in sources + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


class Library:
    """A loaded kernel library; build() makes it on first use.

    The default is the package's: every source in csrc/.  sources,
    defines and prefix make another library from other versions of the
    sources (with csrc/ on the include path), built the same way into
    build/x266_tpu_torch/<prefix><hash>/; signatures sets the C
    signatures of the entry points it has (default: declare).  path is
    the shared library's file."""

    def __init__(self, sources=None, defines=(), prefix="", signatures=None):
        self.sources = SOURCES if sources is None else list(sources)
        self.flags = [*FLAGS, "-I", os.path.join(PKG, "csrc"),
                      *(f"-D{d}" for d in defines)]
        self.prefix = prefix
        self.signatures = signatures or declare
        self.lib = None
        self.build_log = ""

    @property
    def path(self) -> str:
        return os.path.join(ROOT, "build", "x266_tpu_torch", self.prefix
                            + source_hash(self.sources, self.flags),
                            "libx266k.so")

    def build(self) -> ctypes.CDLL:
        if self.lib is not None:
            return self.lib
        so = self.path
        if not os.path.exists(so):
            os.makedirs(os.path.dirname(so), exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            objs = [f"{tmp}.{i}.o" for i in range(len(self.sources))]
            jobs = [subprocess.Popen([nvcc_path(), *self.flags, "-c", src,
                                      "-o", obj], stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                    for src, obj in zip(self.sources, objs)]
            logs = [job.communicate()[0] for job in jobs]
            self.build_log = "".join(logs)
            if any(job.returncode for job in jobs):
                raise RuntimeError("nvcc failed:\n" + self.build_log)
            proc = subprocess.run([nvcc_path(), *ARCH, "-shared", "-o", tmp,
                                   *objs],
                                  capture_output=True, text=True)
            self.build_log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + self.build_log)
            for obj in objs:
                os.remove(obj)
            os.replace(tmp, so)
        self.lib = self.signatures(ctypes.CDLL(so))
        return self.lib


def declare_recon(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of csrc/recon_intra.cu's launch entry points."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.x266_recon_intra.argtypes = (
        [i] * 9 + [fl] + [i] * 12 + [p] * 24 + [p])  # ..., sync, stream
    lib.x266_recon_intra.restype = i
    lib.x266_recon_inter.argtypes = (
        [i] * 8 + [fl] + [i] * 14 + [p] * 35 + [p])  # ..., sync, stream
    lib.x266_recon_inter.restype = i
    lib.x266_error_string.argtypes = [i]
    lib.x266_error_string.restype = ctypes.c_char_p
    return lib


def declare_me(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of csrc/me.cu's launch entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.x266_warp_frames.argtypes = [i] * 5 + [p] * 4
    lib.x266_warp_frames.restype = i
    lib.x266_refine_search.argtypes = [i] * 4 + [p] * 5
    lib.x266_refine_search.restype = i
    return lib


def declare_sse(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signature of csrc/sse.cu's launch entry point."""
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.x266_picture_sse.argtypes = (
        [i, i] + [i, i, p, p] * 3 + [p, ll, p, ll] + [p] * 3)
    lib.x266_picture_sse.restype = i
    return lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of the library's entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    declare_recon(lib)
    declare_me(lib)
    lib.x266_alf_normal.argtypes = ([i] * 4 + [p] * 4 + [i] + [p] * 2
                                    + [i] * 8 + [p] * 11)
    lib.x266_alf_normal.restype = i
    lib.x266_alf_ctb_flags.argtypes = ([i] * 3 + [ctypes.c_float] + [p] * 6
                                       + [ctypes.c_float, p, p])
    lib.x266_alf_ctb_flags.restype = i
    lib.x266_alf_class_sse.argtypes = [i] * 3 + [p] * 8
    lib.x266_alf_class_sse.restype = i
    declare_sse(lib)
    lib.x266_subst_scan.argtypes = [i] + [p] * 3   # host stand-in tests
    lib.x266_subst_scan.restype = i
    return lib


LIBRARY = Library()


def check(err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = LIBRARY.build().x266_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")
