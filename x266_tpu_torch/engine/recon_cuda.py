"""Wrappers of the CUDA recon-scan kernels K1 (intra encode), K2 (intra
decode), K3-P (P-picture encode and decode) and K3-B (B-picture encode
and decode), csrc/recon_intra.cu.

They replace the Pallas kernel x266_tpu/engine/recon_pallas.py:
_build_pallas (inter=False; inter=True with b_mode False and True).  The
plain versions are engine.recon.make_recon_pass_raw and
engine.inter.make_recon_inter_raw; ``engine.recon.recon_pass`` and
``engine.inter.recon_inter_pass`` route CUDA tensors here and CPU tensors
there.  These wrappers launch the kernel or raise -- they never fall
back.

LAUNCHES counts the launches of each kernel (one per call here and
nowhere else), so a run can show that its main path went through them.
Each launch is one thread block per CTU row of each frame (the row
wavefront of csrc/recon_intra.cu), with an int32 scratch of 1 + rows for
the row ticket and the rows' progress.  cfg's sign-data hiding (encode)
and dependent quantization (encode and decode) select the kernel's SDH
and DQ instances (csrc/recon_quant.cu); their lambda is
cfg.lambda_mode, which is also their default without RDOQ.  cfg's mtt
and lfnst select K1 and K2's MTT / LFNST instances: the BT leaves of the
mts map's bits 4-5 and LFNST's index in bits 6-7, with the kernels
tab.k_lfnst.  cfg.cclm selects their CCLM instances (csrc/recon_cclm.cu):
K1 returns the mts map with its CCLM choices in bit 3, K2 reads them
there.
"""

from __future__ import annotations

import numpy as np
import torch

from x266_tpu_torch.config import CodecConfig

from x266_tpu_torch import _build
from x266_tpu_torch.engine.mode_decision import PAD
from x266_tpu_torch.tables import Tables

LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K3d": 0, "K3B": 0, "K3Bd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_tensor(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype and shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_tables(tab: Tables) -> None:
    for name, t in (("taps", tab.k_taps), ("smooth", tab.k_smooth),
                    ("tx", tab.k_tx), ("shift", tab.k_shift),
                    ("mip", tab.k_mip)):
        check_tensor(t, name, torch.int32, t.shape)
    check_tensor(tab.k_lfnst, "lfnst", torch.int32, (8, 16, 16))
    check_tensor(tab.rate, "rate", torch.float32, (32768,))


def recon_intra(cfg: CodecConfig, tab: Tables, encode: bool, a, b, c,
                size_map, mode_map, mts_map):
    """Launch K1 (encode) or K2 (decode) over a batch of F frames.

    encode: a, b, c are the padded uint8 source planes (F, 1+H+PAD,
    1+W+PAD) / (F, 1+H/2+PAD, 1+W/2+PAD); decode: the int16 level planes
    (F, H, W) / (F, H/2, W/2).  Maps are int32 (F, H/8, W/8).  Returns
    (reconY, reconCb, reconCr) uint8 and (coefY, coefCb, coefCr) int16,
    as make_recon_pass_raw; in decode the levels are the inputs.  Under
    cfg.cclm K1 also returns the mts map with its CCLM choices in bit 3
    (F, H/8, W/8) int32, as the plain scan's seventh output."""
    h, w = cfg.height, cfg.width
    ch, cw = h // 2, w // 2
    f = a.shape[0]
    if encode:
        py, pc = (1 + h + PAD, 1 + w + PAD), (1 + ch + PAD, 1 + cw + PAD)
        check_tensor(a, "srcY", torch.uint8, (f, *py))
        check_tensor(b, "srcCb", torch.uint8, (f, *pc))
        check_tensor(c, "srcCr", torch.uint8, (f, *pc))
    else:
        check_tensor(a, "coefY", torch.int16, (f, h, w))
        check_tensor(b, "coefCb", torch.int16, (f, ch, cw))
        check_tensor(c, "coefCr", torch.int16, (f, ch, cw))
    for name, m in (("size_map", size_map), ("mode_map", mode_map),
                    ("mts_map", mts_map)):
        check_tensor(m, name, torch.int32, (f, cfg.units_y, cfg.units_x))
    _check_tables(tab)

    lib = _build.LIBRARY.build()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err, out = _launch(lib, stream, cfg, tab, encode, a, b, c,
                           size_map, mode_map, mts_map)
    _build.check(err)
    if len(out) > 6:
        check_tensor(out[6], "mts_out", torch.int32, mts_map.shape)
    LAUNCHES["K1" if encode else "K2"] += 1
    return out


def _launch(lib, stream, cfg, tab, encode, a, b, c, size_map, mode_map,
            mts_map):
    """Allocate the outputs and call the library's entry point on
    checked tensors; returns (error code, outputs), K1 under CCLM's with
    the mts map out."""
    h, w = cfg.height, cfg.width
    ch, cw = h // 2, w // 2
    f = a.shape[0]
    dev = a.device
    rec = [torch.empty((f, h, w), dtype=torch.uint8, device=dev),
           torch.empty((f, ch, cw), dtype=torch.uint8, device=dev),
           torch.empty((f, ch, cw), dtype=torch.uint8, device=dev)]
    if encode:
        coef = [torch.empty((f, h, w), dtype=torch.int16, device=dev),
                torch.empty((f, ch, cw), dtype=torch.int16, device=dev),
                torch.empty((f, ch, cw), dtype=torch.int16, device=dev)]
        src, cin, cout = (a, b, c), (None,) * 3, coef
    else:
        coef = [a, b, c]
        src, cin, cout = (None,) * 3, (a, b, c), (None,) * 3
    py = src[0].shape[1:] if encode else (0, 0)
    pc = src[1].shape[1:] if encode else (0, 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    mts_out = (torch.empty_like(mts_map) if cfg.cclm and encode else None)
    sync = _sync_buffer(f, h, dev)
    err = lib.x266_recon_intra(
        int(encode), f, w, h, py[1], pc[1], py[0] * py[1], pc[0] * pc[1],
        cfg.qp, float(np.float32(cfg.lambda_mode)),
        int(cfg.rdoq and encode), int(cfg.mts), int(cfg.ref_substitute),
        cfg.n_pred_modes, int(cfg.lossless), int(cfg.transform_skip),
        int(cfg.pdpc), int(cfg.sign_data_hiding and encode),
        int(cfg.dep_quant), int(cfg.mtt), int(cfg.lfnst), int(cfg.cclm),
        *map(ptr, src), *map(ptr, cin), size_map.data_ptr(),
        mode_map.data_ptr(), mts_map.data_ptr(), *map(ptr, rec),
        *map(ptr, cout), tab.k_taps.data_ptr(), tab.k_smooth.data_ptr(),
        tab.k_tx.data_ptr(), tab.k_shift.data_ptr(), tab.rate.data_ptr(),
        tab.k_mip.data_ptr(), tab.k_lfnst.data_ptr(), ptr(mts_out),
        sync.data_ptr(), stream)
    return err, (*rec, *coef, *([] if mts_out is None else [mts_out]))


def _sync_buffer(frames: int, height: int, dev) -> torch.Tensor:
    """The wavefront's scratch: the row ticket and each CTU row's
    progress (the kernel's launcher zeroes it on the stream)."""
    return torch.empty(1 + frames * -(-height // 64), dtype=torch.int32,
                       device=dev)


def recon_inter(cfg: CodecConfig, tab: Tables, encode: bool, a, b, c,
                size_map, mode_map, mts_map, pred_map, mvx_map, mvy_map,
                pyr_y, pyr_cb, pyr_cr, *l1):
    """Launch K3-P over one P picture, or K3-B over one B picture when l1
    is given (encode, or the decoder's form).

    a, b, c and the maps as recon_intra with a frame dim of 1, plus the
    pred/mvx/mvy maps (1, H/8, W/8) int32 and the reference's pyramids
    (16, Hp, Wp) uint8; l1, for K3-B: the L1 pyramids (the shapes of
    L0's) and the mvx1/mvy1 maps (1, H/8, W/8) int32.  Returns
    recon_intra's six outputs and the final MV maps (mvx, mvy) int16
    (1, H/8, W/8), as engine.inter.make_recon_inter_raw."""
    _check_inter(cfg, tab, encode, a, b, c, size_map, mode_map, mts_map,
                 pred_map, mvx_map, mvy_map, pyr_y, pyr_cb, pyr_cr, *l1)
    lib = _build.LIBRARY.build()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err, out = _launch_inter(lib, stream, cfg, tab, encode, a, b, c,
                                 size_map, mode_map, mts_map, pred_map,
                                 mvx_map, mvy_map, pyr_y, pyr_cb, pyr_cr,
                                 *l1)
    _build.check(err)
    LAUNCHES[("K3B" if l1 else "K3") + ("" if encode else "d")] += 1
    return out


def _check_inter(cfg, tab, encode, a, b, c, size_map, mode_map, mts_map,
                 pred_map, mvx_map, mvy_map, pyr_y, pyr_cb, pyr_cr, *l1):
    """The checks of K3-P's and K3-B's arguments."""
    if len(l1) not in (0, 5):
        raise ValueError("K3-B takes the three L1 pyramids and the two mv1 "
                         f"maps, got {len(l1)} L1 arguments")
    h, w = cfg.height, cfg.width
    ch, cw = h // 2, w // 2
    if encode:
        check_tensor(a, "srcY", torch.uint8, (1, 1 + h + PAD, 1 + w + PAD))
        check_tensor(b, "srcCb", torch.uint8, (1, 1 + ch + PAD,
                                                1 + cw + PAD))
        check_tensor(c, "srcCr", torch.uint8, (1, 1 + ch + PAD,
                                                1 + cw + PAD))
    else:
        check_tensor(a, "coefY", torch.int16, (1, h, w))
        check_tensor(b, "coefCb", torch.int16, (1, ch, cw))
        check_tensor(c, "coefCr", torch.int16, (1, ch, cw))
    for name, m in (("size_map", size_map), ("mode_map", mode_map),
                    ("mts_map", mts_map), ("pred_map", pred_map),
                    ("mvx_map", mvx_map), ("mvy_map", mvy_map)):
        check_tensor(m, name, torch.int32, (1, cfg.units_y, cfg.units_x))
    check_tensor(pyr_y, "pyr_y", torch.uint8, (16, *pyr_y.shape[1:]))
    check_tensor(pyr_cb, "pyr_cb", torch.uint8, (16, *pyr_cb.shape[1:]))
    check_tensor(pyr_cr, "pyr_cr", torch.uint8, pyr_cb.shape)
    if l1:
        for name, t, ref in zip(("pyr1_y", "pyr1_cb", "pyr1_cr"), l1,
                                (pyr_y, pyr_cb, pyr_cr)):
            check_tensor(t, name, torch.uint8, ref.shape)
        for name, m in zip(("mvx1_map", "mvy1_map"), l1[3:]):
            check_tensor(m, name, torch.int32, (1, cfg.units_y, cfg.units_x))
    _check_tables(tab)


def _launch_inter(lib, stream, cfg, tab, encode, a, b, c, size_map,
                  mode_map, mts_map, pred_map, mvx_map, mvy_map, pyr_y,
                  pyr_cb, pyr_cr, *l1):
    """Allocate K3-P's outputs and call its entry point on checked
    tensors -- K3-B when l1 holds the L1 pyramids and the mv1 maps;
    returns (error code, outputs).  The intra tools reach the kernel as
    K1's do: cfg's lossless, transform_skip and pdpc flags and the MIP
    table tab.k_mip (checked by _check_tables)."""
    h, w = cfg.height, cfg.width
    ch, cw = h // 2, w // 2
    dev = a.device
    rec = [torch.empty((1, h, w), dtype=torch.uint8, device=dev),
           torch.empty((1, ch, cw), dtype=torch.uint8, device=dev),
           torch.empty((1, ch, cw), dtype=torch.uint8, device=dev)]
    mvs = [torch.empty((1, cfg.units_y, cfg.units_x), dtype=torch.int16,
                       device=dev) for _ in range(2)]
    if encode:
        coef = [torch.empty((1, h, w), dtype=torch.int16, device=dev),
                torch.empty((1, ch, cw), dtype=torch.int16, device=dev),
                torch.empty((1, ch, cw), dtype=torch.int16, device=dev)]
        src, cin, cout = (a, b, c), (None,) * 3, coef
    else:
        coef = [a, b, c]
        src, cin, cout = (None,) * 3, (a, b, c), (None,) * 3
    py = src[0].shape[1:] if encode else (0, 0)
    pc = src[1].shape[1:] if encode else (0, 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    sync = _sync_buffer(1, h, dev)
    err = lib.x266_recon_inter(
        int(encode), w, h, py[1], pc[1], py[0] * py[1], pc[0] * pc[1],
        cfg.qp, float(np.float32(cfg.lambda_mode)),
        int(cfg.rdoq and encode), int(cfg.mts), int(cfg.ref_substitute),
        cfg.n_pred_modes, int(cfg.lossless), int(cfg.transform_skip),
        int(cfg.pdpc), int(cfg.sign_data_hiding and encode),
        int(cfg.dep_quant), int(cfg.merge_cands), pyr_y.shape[1],
        pyr_y.shape[2], pyr_cb.shape[1], pyr_cb.shape[2],
        *map(ptr, src), *map(ptr, cin), size_map.data_ptr(),
        mode_map.data_ptr(), mts_map.data_ptr(), pred_map.data_ptr(),
        mvx_map.data_ptr(), mvy_map.data_ptr(), pyr_y.data_ptr(),
        pyr_cb.data_ptr(), pyr_cr.data_ptr(), *map(ptr, rec),
        *map(ptr, cout), mvs[0].data_ptr(), mvs[1].data_ptr(),
        tab.k_taps.data_ptr(), tab.k_smooth.data_ptr(), tab.k_tx.data_ptr(),
        tab.k_shift.data_ptr(), tab.rate.data_ptr(), tab.k_mip.data_ptr(),
        *(map(ptr, l1) if l1 else (None,) * 5), sync.data_ptr(), stream)
    return err, (*rec, *coef, *mvs)
