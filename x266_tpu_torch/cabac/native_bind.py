"""ctypes binding + on-demand build of the native entropy engine.

Builds ``native/rangecoder.cpp`` with g++ on first use (cached by source
hash under ``native/build/``).  No pybind11 in this image, hence the plain
C ABI + ctypes (task environment constraint).  Falls back cleanly when no
toolchain is available: callers check ``available()``.

Set X266T_NO_NATIVE=1 to force the pure-Python entropy path (used by the
differential tests that pin C++ == Python bit-for-bit).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from x266_tpu_torch.cabac import ctx_init as _ctx_init

_SRC = os.path.join(os.path.dirname(__file__), "native", "rangecoder.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "native", "build")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    # X266T_SANITIZE=ubsan|asan builds an instrumented library (used by
    # tools/sanitize_native.py over the differential entropy tests).
    san = os.environ.get("X266T_SANITIZE", "")
    san_flags, san_tag = [], ""
    if san == "ubsan":
        san_flags = ["-fsanitize=undefined", "-fno-sanitize-recover=all",
                     "-g", "-O1"]
        san_tag = "_ubsan"
    elif san == "asan":
        # loading into a non-ASan python needs LD_PRELOAD=libasan.so
        san_flags = ["-fsanitize=address", "-g", "-O1"]
        san_tag = "_asan"
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16] + san_tag
    so_path = os.path.join(_BUILD_DIR, f"rangecoder_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-fno-exceptions", "-o", tmp, _SRC] + san_flags
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    os.replace(tmp, so_path)
    return so_path


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("X266T_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.x266t_encode_segment.restype = ctypes.c_int64
        lib.x266t_encode_segment.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int32, i32p,
            ctypes.c_int32, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int32, i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_int64,
            i32p, ctypes.c_int32, i32p]
        lib.x266t_decode_segment.restype = ctypes.c_int64
        lib.x266t_decode_segment.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int32, i32p,
            ctypes.c_int32, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int32, i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_int64,
            i32p, ctypes.c_int32, i32p]
        lib.x266t_expand_nib.restype = None
        lib.x266t_expand_nib.argtypes = [u8p, i32p, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _i32(a: np.ndarray):
    a = np.ascontiguousarray(a, dtype=np.int32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _sao_args(cfg, sao_params):
    """Returns (plane_count 0/1/3, 3-plane (type, band, off) arrays)."""
    if sao_params is None:
        z = np.zeros((3, cfg.ctus_y, cfg.ctus_x), np.int32)
        zo = np.zeros((3, cfg.ctus_y, cfg.ctus_x, 4), np.int32)
        return 0, (z, z, zo)
    st, sb, so = (np.ascontiguousarray(a, np.int32)
                  for a in sao_params)
    if st.ndim == 2:               # legacy luma-only params
        z = np.zeros_like(st)
        st = np.ascontiguousarray(np.stack([st, z, z]))
        sb = np.ascontiguousarray(np.stack([sb, z, z]))
        zo = np.zeros_like(so)
        so = np.ascontiguousarray(np.stack([so, zo, zo]))
    return (3 if cfg.sao_chroma else 1), (st, sb, so)


def _inter_args(cfg, inter_maps):
    """inter_maps: None (intra), (pred, mvx, mvy) for P, or
    (pred, mvx, mvy, mvx1, mvy1) for B.  Returns (is_p, 5 arrays)
    where is_p is 0/1/2 (intra/P/B)."""
    z = np.zeros((cfg.units_y, cfg.units_x), np.int32)
    if inter_maps is None:
        return 0, (z, z, z, z, z)
    maps = [np.ascontiguousarray(m, np.int32) for m in inter_maps]
    if len(maps) == 3:
        return 1, (*maps, z, z)
    assert len(maps) == 5
    return 2, tuple(maps)


def encode_segment(cfg, size_map, mode_map, coef_y, coef_cb, coef_cr,
                   ctu_row0: int, ctu_row1: int, sao_params=None,
                   mts_map=None, inter_maps=None, init_states=None,
                   snapshot=None) -> bytes:
    # inter_maps: (pred_map, mvx_map, mvy_map) for P slices, else None
    # init_states: flat [pf, ps] int32 overriding the trained init
    # (WPP inheritance, P6); snapshot: int32 out-buffer (2n) filled
    # with the states after the segment's first min(2, ctus_x) CTUs
    lib = _load()
    assert lib is not None
    if mts_map is None:
        mts_map = np.zeros_like(np.asarray(size_map))
    mt, mtp = _i32(mts_map)
    sm, smp = _i32(size_map)
    mm, mmp = _i32(mode_map)
    cy, cyp = _i32(coef_y)
    cb, cbp = _i32(coef_cb)
    cr, crp = _i32(coef_cr)
    is_p, (pm, mx, my, mx1, my1) = _inter_args(cfg, inter_maps)
    pm, pmp = _i32(pm)
    mx, mxp = _i32(mx)
    my, myp = _i32(my)
    mx1, mx1p = _i32(mx1)
    my1, my1p = _i32(my1)
    has_sao, (st, sb, so) = _sao_args(cfg, sao_params)
    st, stp = _i32(st)
    sb, sbp = _i32(sb)
    so, sop = _i32(so)
    init = (init_states if init_states is not None
            else _ctx_init.flat_i32(cfg, is_p))
    initp = (init.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
             if init is not None else None)
    snap_after = min(2, cfg.ctus_x) if snapshot is not None else 0
    snapp = (snapshot.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
             if snapshot is not None else None)
    cap = 32 + 4 * (cfg.width * cfg.height * 3) // 2 + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = lib.x266t_encode_segment(
        cfg.width, cfg.height, cfg.max_cu_size, cfg.n_intra_modes,
        smp, mmp, cyp, cbp, crp,
        (int(cfg.mts) | (int(cfg.transform_skip) << 1)
         | (int(cfg.merge_cands) << 2) | (int(cfg.cclm) << 3)
         | (int(cfg.mtt) << 4) | (int(cfg.lfnst) << 5)
         | (int(cfg.mip) << 6)
         | (int(cfg.sign_data_hiding) << 7)
         | (int(cfg.amvp) << 8)), mtp,
        is_p, pmp, mxp, myp, mx1p, my1p,
        has_sao, stp, sbp, sop, ctu_row0, ctu_row1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        initp, snap_after, snapp)
    if n < 0:
        raise RuntimeError(f"native encode_segment failed ({n})")
    return out[:n].tobytes()


def decode_segment(cfg, size_map, mode_map, coef_y, coef_cb, coef_cr,
                   ctu_row0: int, ctu_row1: int, data: bytes,
                   sao_params=None, mts_map=None,
                   inter_maps=None, init_states=None,
                   snapshot=None) -> None:
    # Fills the passed arrays in place (C-contiguous int32).  When
    # cfg.sao pass sao_params=(type, band, off); when cfg.mts pass
    # mts_map; for P slices pass inter_maps=(pred, mvx, mvy) to fill.
    lib = _load()
    assert lib is not None
    if mts_map is None:
        mts_map = np.zeros_like(size_map)
    arrays = [size_map, mode_map, coef_y, coef_cb, coef_cr]
    if inter_maps is None:
        is_p, inter_maps = _inter_args(cfg, None)
    else:
        is_p = 1 if len(inter_maps) == 3 else 2
        if len(inter_maps) == 3:
            z = np.zeros((cfg.units_y, cfg.units_x), np.int32)
            inter_maps = tuple(inter_maps) + (z, z)
    has_sao = (3 if cfg.sao_chroma else 1) if cfg.sao else 0
    if sao_params is None:
        _, sao_params = _sao_args(cfg, None)
        has_sao = 0
    arrays += [mts_map] + list(inter_maps) + list(sao_params)
    for a in arrays:
        assert a.dtype == np.int32 and a.flags.c_contiguous
    buf = np.frombuffer(data, dtype=np.uint8)
    p = (buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
         if len(data) else
         ctypes.cast(ctypes.create_string_buffer(1),
                     ctypes.POINTER(ctypes.c_uint8)))
    i32 = ctypes.POINTER(ctypes.c_int32)
    ptrs = [a.ctypes.data_as(i32) for a in arrays]
    init = (init_states if init_states is not None
            else _ctx_init.flat_i32(cfg, is_p))
    initp = (init.ctypes.data_as(i32) if init is not None else None)
    snap_after = min(2, cfg.ctus_x) if snapshot is not None else 0
    snapp = (snapshot.ctypes.data_as(i32)
             if snapshot is not None else None)
    rc = lib.x266t_decode_segment(
        cfg.width, cfg.height, cfg.max_cu_size, cfg.n_intra_modes,
        ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4],
        (int(cfg.mts) | (int(cfg.transform_skip) << 1)
         | (int(cfg.merge_cands) << 2) | (int(cfg.cclm) << 3)
         | (int(cfg.mtt) << 4) | (int(cfg.lfnst) << 5)
         | (int(cfg.mip) << 6)
         | (int(cfg.sign_data_hiding) << 7)
         | (int(cfg.amvp) << 8)), ptrs[5],
        is_p, ptrs[6], ptrs[7], ptrs[8], ptrs[9], ptrs[10],
        has_sao, ptrs[11], ptrs[12], ptrs[13],
        ctu_row0, ctu_row1, p, len(data), initp, snap_after, snapp)
    if rc != 0:
        raise ValueError("corrupt or truncated entropy payload (native)")


def expand_nib(nib: np.ndarray) -> np.ndarray | None:
    """(h, w2) packed nibble plane -> (h, 2*w2) sign-extended int32
    via the native loop; None when the native lib is unavailable
    (callers fall back to the numpy LUT path in engine/fused.py)."""
    lib = _load()
    if lib is None:
        return None
    nib = np.ascontiguousarray(nib, np.uint8)
    out = np.empty((nib.shape[0], 2 * nib.shape[1]), np.int32)
    lib.x266t_expand_nib(
        nib.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(nib.size))
    return out
