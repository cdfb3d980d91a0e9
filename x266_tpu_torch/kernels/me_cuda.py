"""Wrappers of the CUDA motion kernels K4 (MC warp) and K5 (ME refine),
csrc/me.cu, with K4's plain version.

K4 replaces x266_tpu/kernels/me_pallas.py:_build_warp and K5 replaces
_build_refine2.  ``warp_frames`` routes CUDA tensors to K4 and CPU
tensors to ``warp_frames_ref``; kernels.me.me_search routes the refine
the same way (K5 or kernels.me.refine_search_ref).  The wrappers launch
the kernel or raise -- they never fall back.

LAUNCHES counts the launches of each kernel (one per call here and
nowhere else), so a run can show that its main path went through them.
"""

from __future__ import annotations

import torch

from x266_tpu_torch import _build
from x266_tpu_torch.engine.recon_cuda import check_tensor
from x266_tpu_torch.kernels.interp import REF_PAD
from x266_tpu_torch.kernels.me import ME_BLOCK

LAUNCHES = {"K4": 0, "K5": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_reads(pyramid: torch.Tensor, mvs: torch.Tensor, by: int,
                 bx: int, reach: int) -> None:
    """Every 16x16 read at the MVs (quarter-pel) +- reach full-pel lies
    inside the pyramid (the reference clamps an out-of-range start; the
    MV bounds keep every read inside, so the plain versions assert)."""
    lo_x = int((mvs[..., 0] >> 2).min()) - reach + REF_PAD
    lo_y = int((mvs[..., 1] >> 2).min()) - reach + REF_PAD
    hi_x = int((mvs[..., 0] >> 2).max()) + reach + REF_PAD + bx * ME_BLOCK
    hi_y = int((mvs[..., 1] >> 2).max()) + reach + REF_PAD + by * ME_BLOCK
    assert lo_x >= 0 and lo_y >= 0, (lo_x, lo_y)
    assert hi_y + 1 <= pyramid.shape[1] and hi_x + 1 <= pyramid.shape[2], (
        hi_y, hi_x, tuple(pyramid.shape))


def _check_words(pyramid: torch.Tensor) -> None:
    """K4 and K5 read the pyramid as aligned 32-bit words: its rows must
    be a multiple of 4 bytes wide (every pyramid the port builds is:
    widths are multiples of 8) and its data 4-byte aligned."""
    if pyramid.shape[2] % 4 or pyramid.data_ptr() % 4:
        raise ValueError("pyramid: rows must be a multiple of 4 bytes wide "
                         f"and 4-byte aligned, got {tuple(pyramid.shape)}")


def warp_index(mvs: torch.Tensor):
    """The pyramid (plane, row, column) that each output sample of K4
    reads for (T, By, Bx, 2) int32 quarter-pel MVs: three int64
    (T, 16By, 16Bx) tensors."""
    t, by, bx = mvs.shape[:3]
    m = mvs.to(torch.int64).repeat_interleave(ME_BLOCK, 1) \
        .repeat_interleave(ME_BLOCK, 2)                # (T, H16, W16, 2)
    ys = torch.arange(by * ME_BLOCK, device=mvs.device)[None, :, None]
    xs = torch.arange(bx * ME_BLOCK, device=mvs.device)[None, None, :]
    return ((m[..., 1] & 3) * 4 + (m[..., 0] & 3),
            ys + REF_PAD + (m[..., 1] >> 2), xs + REF_PAD + (m[..., 0] >> 2))


def warp_frames_ref(pyramid: torch.Tensor, mvs: torch.Tensor
                    ) -> torch.Tensor:
    """The plain version of K4: (T, By, Bx, 2) int32 quarter-pel MVs ->
    (T, 16By, 16Bx) int32 frames, block (i, j) of frame t being
    interp.mc_block(pyramid, 16j, 16i, *mvs[t, i, j], 16)."""
    _check_reads(pyramid, mvs, *mvs.shape[1:3], 0)
    return pyramid[warp_index(mvs)].to(torch.int32)


def warp_frames(pyramid: torch.Tensor, mvs: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors, warp_frames_ref on CPU tensors."""
    if pyramid.device.type == "cuda":
        return warp_frames_cuda(pyramid, mvs)
    if pyramid.device.type != "cpu":
        raise ValueError(f"unsupported device {pyramid.device}")
    return warp_frames_ref(pyramid, mvs)


def _launch_warp(lib, stream, pyramid, mvs):
    t, by, bx = mvs.shape[:3]
    out = torch.empty((t, by * ME_BLOCK, bx * ME_BLOCK), dtype=torch.int32,
                      device=pyramid.device)
    err = lib.x266_warp_frames(t, by, bx, pyramid.shape[1],
                               pyramid.shape[2], mvs.data_ptr(),
                               pyramid.data_ptr(), out.data_ptr(), stream)
    return err, out


def warp_frames_cuda(pyramid: torch.Tensor, mvs: torch.Tensor
                     ) -> torch.Tensor:
    """Launch K4: (16, Hp, Wp) uint8 pyramid, (T, By, Bx, 2) int32 MVs
    -> (T, 16By, 16Bx) int32 frames."""
    check_tensor(pyramid, "pyramid", torch.uint8, (16, *pyramid.shape[1:]))
    check_tensor(mvs, "mvs", torch.int32, (*mvs.shape[:3], 2))
    _check_words(pyramid)
    lib = _build.LIBRARY.build()
    with torch.cuda.device(pyramid.device):
        stream = torch.cuda.current_stream(pyramid.device).cuda_stream
        err, out = _launch_warp(lib, stream, pyramid, mvs)
    _build.check(err)
    LAUNCHES["K4"] += 1
    return out


def _launch_refine(lib, stream, cur, pyramid, base):
    by, bx = base.shape[:2]
    out = torch.empty((by, bx, 2), dtype=torch.int32, device=cur.device)
    err = lib.x266_refine_search(by, bx, pyramid.shape[1], pyramid.shape[2],
                                 cur.data_ptr(), pyramid.data_ptr(),
                                 base.data_ptr(), out.data_ptr(), stream)
    return err, out


def refine_search(cur: torch.Tensor, pyramid: torch.Tensor,
                  base: torch.Tensor) -> torch.Tensor:
    """Launch K5: cur (16By, 16Bx) int32 holding 8-bit samples (the
    kernel packs them into bytes), pyramid (16, Hp, Wp) uint8, base (By,
    Bx, 2) int32 full-pel -> (By, Bx, 2) int32 quarter-pel MVs, as
    kernels.me.refine_search_ref."""
    by, bx = cur.shape[0] // ME_BLOCK, cur.shape[1] // ME_BLOCK
    check_tensor(cur, "cur", torch.int32, (by * ME_BLOCK, bx * ME_BLOCK))
    check_tensor(pyramid, "pyramid", torch.uint8, (16, *pyramid.shape[1:]))
    check_tensor(base, "base", torch.int32, (by, bx, 2))
    _check_words(pyramid)
    if cur.data_ptr() % 16:
        raise ValueError("cur: expected 16-byte aligned data")
    lib = _build.LIBRARY.build()
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream(cur.device).cuda_stream
        err, out = _launch_refine(lib, stream, cur, pyramid, base)
    _build.check(err)
    LAUNCHES["K5"] += 1
    return out
