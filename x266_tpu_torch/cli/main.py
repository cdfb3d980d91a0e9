"""The port's command line: encode/decode raw YUV420 <-> x266t bitstreams
on the card (or, with --device cpu, on the CPU).

    python -m x266_tpu_torch.cli encode -i in.yuv -s 416x240 -o out.266t \
        [--qp 32] [--frames N] [--lossless] [--deblock] [--sao] \
        [--segment-rows N] [--profile vvc] [--device cuda|cpu]
    python -m x266_tpu_torch.cli decode -i out.266t -o recon.yuv
    python -m x266_tpu_torch.cli stats -i out.266t
    python -m x266_tpu_torch.cli version

Counterpart of x266_tpu/cli/main.py: the same subcommands, flags and
printed lines, and the --stats JSONL sidecar; --device (default cuda)
takes the place of the reference's X266T_PLATFORM knob, and without a
card the default fails as Encoder() and Decoder() do (no fallback to
the CPU).  It turns TF32 off for its process (device.exact_float32).
What the port's slices refuse raises NotImplementedError: --sharded,
tiles (--tile-rows, --tile-cols), 10-bit samples and CUs of 64.
--bitrate takes utils.ratecontrol's controllers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_size(s: str) -> tuple[int, int]:
    w, h = s.lower().split("x")
    return int(w), int(h)


def encode_config(args, w: int, h: int):
    """The CodecConfig of an encode's parsed arguments at w x h."""
    from x266_tpu_torch.config import CodecConfig, Profile

    return CodecConfig(
        width=w, height=h, qp=args.qp, bit_depth=args.bit_depth,
        profile=Profile.VVC if args.profile == "vvc" else
        Profile.HEVC_SUBSET,
        lossless=args.lossless, deblock=args.deblock, sao=args.sao,
        sao_chroma=args.sao_chroma,
        alf=args.alf, alf_chroma=args.alf_chroma,
        alf_nonlinear=args.alf_nonlinear, ccalf=args.ccalf,
        max_cu_size=args.max_cu,
        mts=args.mts, transform_skip=args.transform_skip,
        pdpc=args.pdpc, ref_substitute=args.ref_subst,
        rpl=args.rpl, rdoq=args.rdoq,
        sign_data_hiding=args.sdh, dep_quant=args.dep_quant,
        weighted_pred=args.weighted_pred,
        merge_cands=args.merge_cands, cclm=args.cclm, mtt=args.mtt,
        lfnst=args.lfnst, mip=args.mip, multi_ref=args.multi_ref,
        amvp=args.amvp, ctx_init=args.ctx_init,
        tile_rows=args.tile_rows, tile_cols=args.tile_cols,
        rows_per_segment=args.segment_rows,
        intra_period=args.gop, gop_size=args.bframes)


def cmd_encode(args) -> int:
    import numpy as np

    from x266_tpu_torch.api import Encoder
    from x266_tpu_torch.core.yuv import read_y4m, read_yuv420

    if args.input.endswith(".y4m"):
        frames, y4m = read_y4m(args.input, args.frames)
        w, h = y4m["width"], y4m["height"]
        if args.size and _parse_size(args.size) != (w, h):
            print("-s disagrees with the Y4M header", file=sys.stderr)
            return 1
    else:
        if not args.size:
            print("-s/--size is required for raw YUV input",
                  file=sys.stderr)
            return 1
        w, h = _parse_size(args.size)
        frames = None
    cfg = encode_config(args, w, h)
    if frames is None:
        frames = read_yuv420(args.input, w, h, args.frames,
                             bit_depth=args.bit_depth)
    if not frames:
        print("no frames read", file=sys.stderr)
        return 1

    if args.sharded:
        raise NotImplementedError("--sharded: the sharded encoder is not in "
                                  "the port's slices")
    if args.bitrate:
        if args.rc_mode == "lambda":
            from x266_tpu_torch.utils.ratecontrol import make_lambda_controller
            rc = make_lambda_controller(cfg, args.bitrate, args.fps,
                                        n_frames=len(frames))
        else:
            from x266_tpu_torch.utils.ratecontrol import make_controller
            rc = make_controller(cfg, args.bitrate, args.fps)
        enc = Encoder(cfg, device=args.device, rate_control=rc)
    else:
        enc = Encoder(cfg, device=args.device, batch_frames=args.batch)
    t0 = time.time()
    res = enc.encode(frames)
    dt = time.time() - t0

    with open(args.output, "wb") as f:
        f.write(res.bitstream)

    stats = []
    for i, (fr, rec) in enumerate(zip(frames, res.recon)):
        py, pcb, pcr = rec.psnr(fr)
        stats.append({"poc": i, "bits": res.frame_bits[i],
                      "psnr_y": round(py, 3), "psnr_cb": round(pcb, 3),
                      "psnr_cr": round(pcr, 3)})
        print(f"POC {i:4d}  {res.frame_bits[i]:9d} bits  "
              f"Y {py:6.2f} dB  Cb {pcb:6.2f}  Cr {pcr:6.2f}")
    mean_y = float(np.mean([s["psnr_y"] for s in stats]))
    bitrate = 8 * len(res.bitstream)
    print(f"-- {len(frames)} frames, {bitrate} bits total, "
          f"mean PSNR-Y {mean_y:.2f} dB, {len(frames) / dt:.3f} fps")
    if args.stats:
        with open(args.stats, "w") as f:
            for s in stats:
                f.write(json.dumps(s) + "\n")
            f.write(json.dumps({"summary": {
                "frames": len(frames), "bits": bitrate,
                "mean_psnr_y": mean_y, "fps": len(frames) / dt}}) + "\n")
    return 0


def cmd_decode(args) -> int:
    from x266_tpu_torch.api import Decoder
    from x266_tpu_torch.core.hashing import frame_md5
    from x266_tpu_torch.core.yuv import write_y4m, write_yuv420

    with open(args.input, "rb") as f:
        stream = f.read()
    t0 = time.time()
    cfg, frames = Decoder(device=args.device).decode(stream)
    dt = time.time() - t0
    if args.output.endswith(".y4m"):
        write_y4m(args.output, frames)
    else:
        write_yuv420(args.output, frames)
    for i, fr in enumerate(frames):
        print(f"POC {i:4d}  md5 {frame_md5(fr)}")
    print(f"-- decoded {len(frames)} frames {cfg.width}x{cfg.height} "
          f"in {dt:.2f}s")
    return 0


def cmd_stats(args) -> int:
    """Bitstream analyzer (C19): NAL walk printing sequence geometry,
    tool flags and per-slice type/QP/size/segment count + the SIGNALLED
    reference lists (C16 RPL, round-5) or the derivation rule."""
    from x266_tpu_torch.core import headers
    from x266_tpu_torch.core.nal import NalType, split_nals

    with open(args.input, "rb") as f:
        stream = f.read()
    cfg = None
    for nal_type, rbsp in split_nals(stream):
        if nal_type == NalType.VPS:
            v = headers.parse_vps(rbsp)
            tier = "high" if v["tier"] else "main"
            print(f"VPS  profile_idc={v['profile_idc']} tier={tier} "
                  f"level={v['level_idc']} "
                  f"max_dpb={v['max_dpb_pictures']}")
        elif nal_type == NalType.SPS:
            cfg = headers.parse_sps(rbsp)
            flags = [k for k in (
                "lossless deblock sao sao_chroma alf alf_chroma "
                "alf_nonlinear ccalf mts transform_skip pdpc "
                "ref_substitute merge_cands cclm mtt lfnst mip "
                "multi_ref ctx_init sign_data_hiding dep_quant "
                "weighted_pred amvp rpl").split()
                if getattr(cfg, k)]
            print(f"SPS  {cfg.width}x{cfg.height} {cfg.bit_depth}-bit "
                  f"profile={cfg.profile.name} ip={cfg.intra_period} "
                  f"gop={cfg.gop_size} tiles={cfg.num_tiles} "
                  f"segs={cfg.num_segments}")
            print(f"     tools: {' '.join(flags) or '(none)'}")
        elif nal_type == NalType.PPS:
            print(f"PPS  qp={headers.parse_pps(rbsp)['qp']}")
        elif nal_type in (NalType.IDR, NalType.TRAIL) and cfg:
            sh, off = headers.parse_slice_header(
                rbsp, cfg.alf, cfg.ctus_y * cfg.ctus_x,
                cfg.alf_chroma, cfg.alf_nonlinear, cfg.ccalf,
                has_wp=cfg.weighted_pred, n_bands=cfg.num_tiles,
                has_rpl=cfg.rpl)
            if sh.rpl is not None:
                lists = " ".join(
                    f"L{i}=[{','.join(str(sh.poc - d) for d in l)}]"
                    for i, l in enumerate(sh.rpl))
                refs = f"refs(signalled) {lists}"
            elif sh.slice_type != 0:
                refs = "refs derived from decode history"
            else:
                refs = ""
            print(f"{'IDR' if nal_type == NalType.IDR else 'SLC'} "
                  f"poc={sh.poc:4d} {sh.slice_type.name} qp={sh.qp} "
                  f"{len(rbsp)} bytes {len(sh.entry_points) + 1} seg "
                  f"{refs}")
    return 0


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to code on: cuda (the default; fails "
                        "without a card) or cpu")


def parser() -> argparse.ArgumentParser:
    """The command line's parser: encode, decode, stats, version."""
    p = argparse.ArgumentParser(prog="x266t")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode", help="encode raw YUV420")
    e.add_argument("-i", "--input", required=True)
    e.add_argument("-o", "--output", required=True)
    e.add_argument("-s", "--size", default=None,
                   help="WxH, e.g. 416x240 (raw YUV input; inferred "
                        "from the header for .y4m)")
    e.add_argument("--qp", type=int, default=32)
    e.add_argument("--bit-depth", type=int, default=8,
                   choices=(8, 10),
                   help="sample depth (10-bit raw input = uint16 LE)")
    e.add_argument("--frames", type=int, default=None)
    e.add_argument("--profile", choices=["hevc", "vvc"], default="hevc")
    e.add_argument("--lossless", action="store_true")
    e.add_argument("--deblock", action="store_true")
    e.add_argument("--sao", action="store_true")
    e.add_argument("--sao-chroma", action="store_true",
                   help="chroma SAO planes (requires --sao)")
    e.add_argument("--alf", action="store_true")
    e.add_argument("--alf-chroma", action="store_true",
                   help="chroma ALF 5x5 diamond (requires --alf)")
    e.add_argument("--alf-nonlinear", action="store_true",
                   help="nonlinear ALF: clipping + geometric "
                        "transposes (requires --alf)")
    e.add_argument("--ccalf", action="store_true",
                   help="cross-component ALF (requires --alf)")
    e.add_argument("--max-cu", type=int, default=32, dest="max_cu",
                   choices=(8, 16, 32, 64),
                   help="largest CU size; 64 enables the 64-pt DCT-II "
                        "with high-frequency zero-out (VVC, all-intra)")
    e.add_argument("--mts", action="store_true")
    e.add_argument("--transform-skip", action="store_true",
                   help="per-TU transform skip (screen content)")
    e.add_argument("--pdpc", action="store_true",
                   help="PDPC intra blend (requires --profile vvc)")
    e.add_argument("--ref-subst", action="store_true",
                   dest="ref_subst",
                   help="HEVC-style reference-sample substitution "
                        "(C6): fill unavailable intra refs from the "
                        "nearest available instead of mid-gray")
    e.add_argument("--rpl", action="store_true",
                   help="signalled reference picture lists (C16): "
                        "inter slice headers carry their active "
                        "reference POCs; enables the 4-entry DPB with "
                        "adaptive reference selection in GPB mode")
    e.add_argument("--rdoq", action="store_true",
                   help="RD-optimized quantization (encoder-only)")
    e.add_argument("--sdh", action="store_true",
                   help="sign-data hiding (C11): one sign per eligible CG")
    e.add_argument("--dep-quant", action="store_true", dest="dep_quant",
                   help="dependent quantization (C11, VVC): two offset "
                        "quantizers over a 4-state parity machine")
    e.add_argument("--weighted-pred", action="store_true",
                   dest="weighted_pred",
                   help="explicit weighted prediction (C7): per-slice "
                        "per-list (weight, offset) on the references")
    e.add_argument("--merge", action="store_true", dest="merge_cands",
                   help="2-candidate skip merge list (C7)")
    e.add_argument("--cclm", action="store_true",
                   help="chroma from luma (requires --profile vvc)")
    e.add_argument("--mtt", action="store_true",
                   help="multi-type tree: binary splits into "
                        "rectangular CUs (requires --profile vvc)")
    e.add_argument("--mip", action="store_true",
                   help="matrix intra prediction (C6, VVC profile)")
    e.add_argument("--multi-ref", action="store_true",
                   dest="multi_ref",
                   help="low-delay GPB 2-reference chain (C16)")
    e.add_argument("--amvp", action="store_true",
                   help="AMVP index + merge-with-residual MV coding "
                        "(C7, entropy-only)")
    e.add_argument("--ctx-init", action="store_true", dest="ctx_init",
                   help="trained per-slice-type context init tables "
                        "(C3)")
    e.add_argument("--tile-cols", type=int, default=0,
                   help="CTU columns per tile column (2-D tile grid)")
    e.add_argument("--lfnst", action="store_true",
                   help="secondary low-frequency transform "
                        "(requires --profile vvc)")
    e.add_argument("--tile-rows", type=int, default=0)
    e.add_argument("--gop", type=int, default=1,
                   help="intra period: 1 = all-intra, N = IDR every N "
                        "(low-delay P between)")
    e.add_argument("--bframes", type=int, default=1,
                   help="random-access hierarchy span (power of two): "
                        "anchors every N pocs with hierarchical B "
                        "between; 1 = no B pictures")
    e.add_argument("--segment-rows", type=int, default=0,
                   dest="segment_rows")
    e.add_argument("--sharded", action="store_true",
                   help="distribute tiles/frames over all devices")
    e.add_argument("--batch", type=int, default=1,
                   help="all-intra frames per vmapped device call")
    e.add_argument("--bitrate", type=float, default=None,
                   help="target kbps (enables rate control; QP adapts "
                        "per frame)")
    e.add_argument("--rc-mode", choices=("lambda", "pi"),
                   default="lambda", dest="rc_mode",
                   help="rate controller: lambda-domain R-lambda model "
                        "(default) or the PI loop")
    e.add_argument("--fps", type=float, default=30.0,
                   help="frame rate for --bitrate budgeting")
    e.add_argument("--stats", default=None, help="JSONL stats path")
    _device_arg(e)
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode", help="decode an x266t bitstream")
    d.add_argument("-i", "--input", required=True)
    d.add_argument("-o", "--output", required=True)
    _device_arg(d)
    d.set_defaults(fn=cmd_decode)

    s = sub.add_parser("stats", help="analyze an x266t bitstream: "
                       "per-slice type/QP/bits/segments/ref lists")
    s.add_argument("-i", "--input", required=True)
    s.set_defaults(fn=cmd_stats)

    v = sub.add_parser("version")
    v.set_defaults(fn=lambda a: print("x266t", __import__(
        "x266_tpu_torch").__version__) or 0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    # the command line owns its process: float32 in full on the card
    from x266_tpu_torch import device

    device.exact_float32()
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
