"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises, exit code non-zero):
 1. environment: torch / CUDA / nvcc versions, the card, TF32 flags off,
    the native entropy coder loaded;
 2. build: the CUDA kernels from x266_tpu_torch/csrc with nvcc;
 3. [kernels] K1 (intra encode) and K2 (intra decode) against the plain
    torch scan on the card, bit for bit, at 128x64 and 416x240 for a
    config-2 shaped VVC config and an HEVC config, and on the main
    path's frames and shapes (1920x1080, K1 on a batch of 4 frames, K2
    on one at a time), with the TUs each launch walks by plane and size
    (from the size map) and its time per CTU and per luma TU on the
    wavefront's chain (tu_walk; so for K3-P, K3-B and the tools'
    variants below); [kernels-sse] kernel SSE (one launch for the three
    planes of F frames: each plane's float32 SSE in XLA's reduction
    tree, F4, and its int64 SSE) against its plain versions, bit for
    bit, at config 2's step (four 1080p frames), a 4K picture, 112x80 and
    416x240, near and far from their source;
 4. [kernels-p] K3-P (P recon, encode and decode, final-MV planes
    included), K4 (MC warp) and K5 (ME refine) against their plain
    versions, bit for bit, at 112x80 / 128x64 on four P configs, at
    416x240 and at the config-3 main path's 1080p shapes (K4 with T=6
    fields, K5 and K3 on one P picture whose reference is the frame
    shifted); [kernels-me-4k] K5, and K4 on B Pass A's L0 (T=6) and L1
    (T=2) fields, at config 4's 3840x2160 on the same kind of picture,
    each against its plain version bit for bit and timed beside its
    bound, the plain version and the indexing gather (the kernels line's
    "at_4k");
 5. [golden] decode tests/fixtures/ai_hevc.266t, ai_hevc_lossless.266t,
    gpb_rpl_wp.266t (GPB with signalled reference lists and weighted
    prediction) and ra_alf.266t (random access, nonlinear ALF, CC-ALF)
    to their manifest MD5s and re-encode their sources to the identical
    bytes;
 6. [main] all-intra 1080p VVC (config 2) frames 0-3 through
    Encoder/Decoder (on the card by default), held against the JAX
    reference in x266_tpu_torch/data/cfg2_1080p_ref.json: every slice
    NAL and recon byte-identical, PSNR-Y equal to the reference's float32
    value; K1/K2/SSE launch counts of that run (SSE once a step); one
    warm encode's frame rate;
 7. [main-p] low-delay P 1080p (config 3) frames 0-3 (IDR + 3 P) the
    same way, against data/cfg3_1080p_ref.json; K3/K4/K5 launch counts
    of that run; one warm encode's frame rate;
    [kernels-tools] K1 and K2's lossless, transform-skip, PDPC and MIP
    branches against the plain scan, bit for bit, each tool alone at
    416x240 and cfg2t (config 2 with PDPC, MIP and transform skip) and
    lossless at 1080p (K1 on a batch of 4, frame 0 against the plain
    encode scan on the CPU; K2 on its levels against K1's recon), with
    the counts of the tools' TUs (a tool the config enables with no TU
    fails), both timed;
    [main-tools] cfg2t frames 0-3 of the 'text' clip at 1080p against
    data/cfg2t_1080p_ref.json, and [main-lossless] ai_hevc_lossless's
    configuration at 1080p against data/lossless_1080p_ref.json, each as
    [main] (SSE equal too), lossless decoding to its input plane for
    plane;
 8. [kernels-b] K3-B (B recon, encode and decode, final-MV planes
    included) against the plain B scan, bit for bit, with L1 and bi CUs
    present, at 112x80 and 128x64 (two B configs, one with merge
    candidates), 416x240, 1920x1080 and the config-4 main path's
    3840x2160, each on a B picture whose L0 and L1 references are the
    frame shifted two ways, each noisy on two thirds of its width; at
    3840x2160 the loop filters of that picture and its whole B encode
    step make no host sync (torch's sync debug mode) and the ALF
    kernel's normal equations and coefficients of that picture equal
    the plain version's bit for bit;
    [kernels-alf] the ALF kernels (the estimators' normal equations in
    XLA CPU's float32 order and their float32 solve, from the recon and
    the source; the per-CTB on/off decision from the SSEs in XLA's
    reduction order) against their plain versions, bit for bit, luma and
    chroma, at 416x240, 1920x1080 and 3840x2160, on three data sets:
    noise far from the source, the planes the encoder's estimators get
    (config 4's IDR), and the two mixed so that chains cross 2^24
    partway; the shares of chains summed exactly and in order are
    printed, and both paths must occur; the 4K times on the noise and on
    the encoder's planes; on the same data the nonlinear and CC-ALF
    paths: the luma equations of the clipped features aligned by the
    transposes and the chroma ones of the clipped diamond at each of the
    4 clip levels, CC-ALF's 7x7 equations and solve, the per-class SSE of
    4x4 blocks of the 4 filtered luma planes in uint8 (ALFCLS, with its
    longest ordered lane chain) and CC-ALF's flags and whole-filter gate
    (the CTB kernel's tail), each against its plain version bit for bit,
    with their 4K times (the gate's also at 1080p; ALFCLS's on the
    encoder's planes and on noise, with its dependent-add floor);
 9. [golden-filters] decode the fixtures lowdelay_p_filters (deblock,
    SAO) and ra_alf (random access, nonlinear ALF, CC-ALF, signalled
    reference lists) to their manifest MD5s;
    [kernels-p-tools], [kernels-b-tools] K3-P and K3-B, encode and
    decode, against the plain scan, bit for bit, with each intra tool on
    (lossless with a forced skip CU, transform skip written on the intra
    CUs, PDPC, MIP) at 416x240 on a 'motion' picture against noisy
    references, then lossless_p's and tools_ra's configurations at
    1080p, timed; each tool's CUs are counted and a tool with none
    fails;
    [main-p-lossless] lossless low-delay P at 1080p (config 3 with
    lossless, frames 0-3 of 'motion') as [main], against
    data/lossless_p_1080p_ref.json, decoding to its input;
    [main-ra-tools] config 4 at 1080p with MTS, PDPC, MIP and transform
    skip, 17 frames of 'motion', against data/tools_ra_1080p_ref.json
    (stream, slice NALs, recon, PSNR-Y and SSE), with the counts of MIP
    and PDPC-class CUs on its P and B pictures (none fails) and the
    launch counts;
10. [main-ra-ref] random access with deblock, SAO and ALF at 416x240,
    17 frames (IDR, P, 15 B): without ALF byte-identical, NAL for NAL
    and recon for recon, to the JAX reference
    (data/cfg4noalf_416x240_ref.json, and at 1920x1080
    data/cfg4noalf_1080p_ref.json); with ALF (config 4) byte-identical
    the same way to the reference with its float32 estimators
    (data/cfg4_416x240_ref.json; ROADMAP queue 3, F9), per-frame bit and
    PSNR differences printed; each JAX stream decodes to JAX's MD5s;
    each encode prints its count of B Pass-A blocks whose float32 error
    sum passes 2^24, where only XLA's order of addition gives the
    reference's sum (F10, which the port follows); lossless random
    access at 416x240 without loop filters against
    data/lossless_ra_416x240_ref.json, decoding to its input;
    [main-cfg5] config 5's single-device form (low-delay P, intra
    period 16, deblock and SAO, WPP segments) at 112x80 (two CTU rows),
    17 frames of 'motion', against data/cfg5_112x80_ref.json as
    [main-ra-ref];
    [main-gpb] config 3 at 1080p with GPB (multi_ref), signalled
    reference lists and weighted prediction, frames 0-4 of 'motion'
    under a luma fade (I, P, then B pictures on two past references
    picked from a DPB of two, three and four entries) through
    Encoder/Decoder: the stream, slice NALs, recon, PSNR-Y and SSE equal
    to data/gpb_wp_1080p_ref.json (whose clip text is checked), the
    decoded pictures equal to the recon, non-identity weights in a P and
    a B slice header, the B pictures' L1 and bi CUs counted (none
    fails), each kernel's launches in this run (launches_gpb), the
    reweight's ms per list (CUDA events) on the 1080p pyramids, one warm
    encode's frame rate;
    [main-ra-nl] config 4 at 1080p with nonlinear ALF and CC-ALF, 17
    frames of 'motion' whose chroma is made from the luma
    (utils.clips.luma_chroma: on the plain synthetic clips CC-ALF keeps
    no CTB), against data/ra_nl_1080p_ref.json as [main-ra-ref], with
    per slice the clipped luma classes, the chroma planes above level 0
    and the CTBs with CC-ALF on (a total of 0 fails), the launches
    (launches_tools["main-ra-nl"]), one warm encode's frame rate and the
    host syncs of one picture's loop filters (none);
    [main-rc] config 3 at 1080p under make_lambda_controller at half of
    data/cfg3_1080p_ref.json's bits a frame (30 fps), 8 frames of
    'motion', against data/rc_1080p_ref.json: stream, slice NALs, each
    picture's QP (at least two QPs), recon, PSNR-Y and SSE, launches_rc
    and one warm encode's frame rate;
    [kernels-sdh-dq] K1/K2, K3-P and K3-B (encode and decode) with
    sign-data hiding and with dependent quantization against the plain
    scans, bit for bit, at 416x240 (SDH beside transform skip on 'text'
    as preset_cfg2s, DQ with RDOQ and beside transform skip without
    it, the P and B pictures on noisy references; the plain scans run
    on the CPU in the worker processes; the flag must change the
    levels of the I and P pictures), timed beside their bounds; then
    each kernel's time without the flags, with SDH and with DQ, in
    turns, at config 2's (K1 a batch of 4), config 3's and config 4's
    1080p shapes;
    [main-sdh] preset_cfg2s (transform skip, SDH, substitution) with
    config 2's segments, frames 0-3 of 'text' at 1080p, against
    data/cfg2s_1080p_ref.json as [main-tools]; [main-dq] config 2 with
    DQ, frames 0-3 of 'mixed', against data/cfg2dq_1080p_ref.json;
    [main-p-dq] config 3 (VVC profile) with DQ, frames 0-3 of 'motion',
    against data/cfg3dq_1080p_ref.json; [main-ra-sdh-dq] config 4 at
    416x240 with SDH, then with DQ, 17 frames of 'motion', against
    data/ra_sdh_416x240_ref.json and data/ra_dq_416x240_ref.json as
    [main-ra-ref]; each with its launches (launches_tools);
    [kernels-mtt-lfnst] K1/K2 with MTT binary splits, with LFNST, with
    both, and in the SDH and DQ instances with them (preset_cfg2q's MTT
    + SDH; MTT + LFNST under DQ) against the plain scans run on the CPU
    in the worker processes, bit for bit, at 416x240, with the BT-H /
    BT-V leaves of 16 and 32 and the LFNST TUs of each kernel counted
    (a direction or kernel with none fails), timed beside their bounds;
    then K1 on config 2's 1080p batch and K2 on its frame 0 without the
    flags, with MTT and with MTT + LFNST, in turns;
    [main-mtt] preset_cfg2q (MTT, SDH, substitution) and
    [main-mtt-lfnst] config 2 with MTT and LFNST (the ai_vvc_mtt_lfnst
    fixture's tools), both with config 2's segments, frames 0-3 of
    'mixed' at 1080p, against data/cfg2q_1080p_ref.json and
    data/cfg2ml_1080p_ref.json as [main-sdh], with the BT leaves and
    LFNST TUs of those frames;
    [kernels-cclm] K1/K2's CCLM instances against the plain scans run on
    the CPU in the worker processes, bit for bit (K1's mts map out with
    the choices in bit 3 included), at 416x240 on clips whose chroma is
    made from the luma (utils.clips.luma_chroma): CCLM alone; with MTS,
    transform skip, PDPC, MIP and substitution; with LFNST and DQ; with
    SDH beside transform skip; lossless; with the CUs of each size
    taking CCLM and DM counted (a choice never taken fails), timed
    beside their bounds (recon_ops with CCLM's operations); then K1 on
    config 2's 1080p batch and K2 on its frame 0 without and with CCLM,
    in turns; [main-cclm] config 2 with CCLM, frames 0-3 of 'mixed' with
    chroma made from the luma, against data/cfg2c_1080p_ref.json as
    [main-mtt], with the CUs of each size taking each choice;
    [kernels-cu64] K1/K2's CU-64 instances (the 64-point DCT and its
    zero-out) against the plain scans run on the CPU in the worker
    processes, bit for bit, at 416x240 on smooth directional blocks
    (utils.clips.smooth_blocks, on which 64 CUs win) with chroma made
    from the luma: CU 64 alone, with CCLM, with LFNST; with the CUs of
    each size counted (no 64 CU fails), timed beside their bounds
    (recon_ops: a 64-TU's transforms over its coded 32x32 band); then K1
    on config 2 + CU 64's 1080p batch (frame 0's recon held to
    data/cfg2cu64_1080p_ref.json's) and K2 on its frame 0, against the
    same frames at CU 32 and with LFNST and CCLM, in turns; [main-cu64]
    config 2 with CU 64,
    frames 0-3 of 'mixed', against data/cfg2cu64_1080p_ref.json as
    [main-mtt], with its 64 CUs counted; [cli]
    ``python3 -m x266_tpu_torch.cli encode`` and ``decode`` as
    subprocesses on a 416x240 raw clip with CCLM (low-delay, deblock,
    SAO): the stream equals data/cli416x240_ref.json's (the JAX
    package's CLI on the same file and flags), the decoded MD5 lines the
    reference's, which are the recon's of Encoder() on the CLI's
    configuration;
11. [main-ra] config 4 at 3840x2160, 17 frames (bench.py's 4K leg: 1
    IDR, 1 P, 15 B) through Encoder/Decoder: decoded pictures equal the
    encoder's recon; K3B/K3Bd launch counts (15 each), the ALF kernels'
    (normal equations and CTB decisions three per picture each), SSE's
    (17: one a picture), the
    F10 count, each kernel's launches in this run (launches_cfg4),
    bits/frame, PSNR-Y, one warm encode's frame rate; the stream, slice
    NALs, recon, PSNR-Y and SSE equal to data/cfg4_4k_ref.json.
Plain versions that run on the CPU (K1's 1080p tools frame in
[kernels-tools], the chroma normal equations in [kernels-alf], the
scans of [kernels-sdh-dq] and [kernels-mtt-lfnst]) run in two
spawned worker processes while the card's phases go on; their checks
finish before the kernels line ([time] cpu-checks).
The third line from the end is a JSON object with each kernel's
launches on its main path, its error and its times (CUDA events at the
main path's shapes, against the plain version's on the same inputs and
the kernel's bound); the next is the card's name and power limit; the
last line is the result.

Exits non-zero, printing no result, when no CUDA device is visible.
"""

import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "x266_tpu_torch", "data")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
RECON_SRC = "x266_tpu_torch/csrc/recon_intra.cu"
ME_SRC = "x266_tpu_torch/csrc/me.cu"
ALF_SRC = "x266_tpu_torch/csrc/alf.cu"
SSE_SRC = "x266_tpu_torch/csrc/sse.cu"
RECON_TPU = "x266_tpu/engine/recon_pallas.py:943"
KERNELS = {
    "K1": ("recon_intra encode", RECON_SRC, RECON_TPU),
    "K2": ("recon_intra decode", RECON_SRC, RECON_TPU),
    "K3": ("recon_inter P encode", RECON_SRC, RECON_TPU),
    "K3d": ("recon_inter P decode", RECON_SRC, RECON_TPU),
    "K3B": ("recon_inter B encode", RECON_SRC, RECON_TPU),
    "K3Bd": ("recon_inter B decode", RECON_SRC, RECON_TPU),
    "K4": ("mc warp", ME_SRC, "x266_tpu/kernels/me_pallas.py:91"),
    "K5": ("me refine", ME_SRC, "x266_tpu/kernels/me_pallas.py:285"),
    # port-only (F9): no Pallas kernel; the reference's XLA dots and
    # jnp.linalg.solve at x266_tpu/kernels/alf.py:367-370
    "ALF": ("alf normal equations and solve", ALF_SRC,
            "x266_tpu/kernels/alf.py:367"),
    # port-only (F9): the reference's per-CTB SSE reduction, :379-382
    "ALFSSE": ("alf ctb sse", ALF_SRC, "x266_tpu/kernels/alf.py:379"),
    # port-only (F4): the reference's per-plane float32 SSE, fused.py:483
    "SSE": ("picture sse in xla's reduction tree", SSE_SRC,
            "x266_tpu/engine/fused.py:483"),
    # port-only (F9): the nonlinear estimator's per-class SSE of 4x4
    # blocks, the reference's XLA dot at x266_tpu/kernels/alf.py:454-456
    "ALFCLS": ("alf per-class block sse", ALF_SRC,
               "x266_tpu/kernels/alf.py:454"),
}
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s, and the float32 rate
# outside the tensor cores, which the integer work of these kernels is
# counted against (a lower bound: int32 issues at most at that rate)
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


# every kernel's entry in the kernels line has these keys
REQUIRED_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(fn, *args):
    """One call on the host clock around synchronizes: (out, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn, *args, reps=3):
    """Mean ms per call over reps calls after a warm one, CUDA events.
    The card first spins for ~20 ms (torch.cuda._sleep) while the host
    enqueues the calls, so a kernel shorter than its wrapper's host time
    is timed back to back on the card, not at the host's launch rate."""
    fn(*args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def samples(*ts) -> int:
    """The bytes of tensors that hold 8-bit values (samples, class and
    transpose indices, flags): one a value, whatever their storage."""
    return sum(t.numel() for t in ts)


# Plain versions that run on the CPU go to worker processes (spawned, no
# CUDA), so that the card's phases go on while they run: on_cpu submits
# one, finish_cpu_checks reads each result and runs its check, before
# the kernels line.  Inputs and outputs travel as numpy arrays.
CPU_WORKERS = 2
CPU_POOL = []
CPU_CHECKS = []


def on_cpu(phase, check, fn, *args):
    """fn(*args) -> (outputs, ms) in a worker; then check(outputs, ms)."""
    if not CPU_POOL:
        import multiprocessing

        CPU_POOL.append(multiprocessing.get_context("spawn").Pool(
            CPU_WORKERS, initializer=torch.set_num_threads, initargs=(2,)))
    CPU_CHECKS.append((phase, CPU_POOL[0].apply_async(fn, args), check))


def finish_cpu_checks():
    for phase, res, check in CPU_CHECKS:
        try:
            check(*res.get())
        except Exception:
            log(f"[{phase}] its check of a plain version on the CPU failed")
            raise
    CPU_CHECKS.clear()


def stop_cpu_workers():
    for pool in CPU_POOL:
        pool.terminate()
        pool.join()
    CPU_POOL.clear()


def _plain_intra_encode_cpu(cfg, inputs):
    """The plain encode scan on the CPU (a worker's): (outputs, ms)."""
    from x266_tpu_torch import tables
    from x266_tpu_torch.engine import recon

    plain = recon.make_recon_pass_raw(cfg, tables.from_reference(cfg, "cpu"),
                                      encode=True)
    t0 = time.perf_counter()
    out = plain(*(torch.from_numpy(x) for x in inputs))
    ms = (time.perf_counter() - t0) * 1e3
    return [t.numpy() for t in out], ms


def _plain_alf_cpu(recon, orig, clip=None, luma=None):
    """The chroma normal equations' plain version on the CPU (a
    worker's), with a clip value the nonlinear chroma estimator's, with
    luma CC-ALF's (recon the chroma plane): ((coef, gram, rhs), ms)."""
    from x266_tpu_torch.kernels import alf as kalf

    t0 = time.perf_counter()
    if luma is not None:
        out = kalf.cc_normal_solve_plain(torch.from_numpy(luma),
                                         torch.from_numpy(recon),
                                         torch.from_numpy(orig), True)
    else:
        out = kalf.normal_solve_plain(torch.from_numpy(recon),
                                      torch.from_numpy(orig), None,
                                      with_sums=True, clip=clip)
    ms = (time.perf_counter() - t0) * 1e3
    return [t.numpy() for t in out], ms


def read_bytes(t, *indices) -> int:
    """Bytes of t that the index tuples address, each byte counted once:
    what a kernel that reads only those elements must move."""
    mask = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    for idx in indices:
        mask[idx] = True
    return int(mask.sum()) * t.element_size()


def mc_index(x, y, mvx, mvy, size):
    """The pyramid index of interp.mc_block's size x size reads at
    picture positions (x, y) and quarter-pel MVs (mvx, mvy), 1-D."""
    from x266_tpu_torch.kernels.interp import REF_PAD

    ar = torch.arange(size, device=x.device)
    return (((mvy & 3) * 4 + (mvx & 3)).long()[:, None, None],
            (y + REF_PAD + (mvy >> 2)).long()[:, None, None] + ar[:, None],
            (x + REF_PAD + (mvx >> 2)).long()[:, None, None] + ar)


def k3_read_bytes(pyrs, size_map, pred_map, mvx, mvy) -> int:
    """Pyramid bytes a P recon scan reads for these maps: each inter or
    skip CU's MC window at its final MV, luma and both chroma planes."""
    return read_union(pyrs, [(size_map, pred_map, mvx, mvy, (1, 2))])


def k5_read_bytes(pyr, cur, base) -> int:
    """Pyramid bytes ME refine reads: the 16x16 windows of every
    candidate of its three searches, around the centres this run's data
    gives them."""
    from x266_tpu_torch.kernels import me

    b, a, ib, _ = (v.reshape(-1, 2) for v in
                   me.refine_search_stages(cur, pyr, base))
    by, bx = base.shape[:2]
    gy, gx = torch.meshgrid(torch.arange(by, device=cur.device) * 16,
                            torch.arange(bx, device=cur.device) * 16,
                            indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    idx = [mc_index(gx, gy, (c[:, 0] + dx) * 4, (c[:, 1] + dy) * 4, 16)
           for c, deltas in ((b, me._REF_DELTAS_A), (a, me._REF_DELTAS_B))
           for dx, dy in deltas]
    idx += [mc_index(gx, gy, ib[:, 0] + dx, ib[:, 1] + dy, 16)
            for dx, dy in me._QP_DELTAS]
    return read_bytes(pyr, *idx)


def bound(n_bytes: float, n_ops: float):
    """The least time the card could take: (ms, what bounds it)."""
    tb, to = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def recon_ops(size_map, encode: bool, pred_map=None, mode_map=None,
              mts_map=None, cfg=None) -> float:
    """Integer operations a recon scan needs for these maps (2 per MAC):
    per luma TU of side s and its two s/2 chroma TUs, intra prediction
    (4 taps a sample; MC copies), the forward transform when encoding
    and the inverse (each two s x s x s products), skipped for skip CUs
    when encoding.  With cfg's intra tools: a MIP luma TU predicts with
    16 MACs a sample plus its 4s-sample group sums, a PDPC-class luma TU
    adds its blend (3 MACs a sample), a transform-skip TU shifts (1 op a
    sample each way) instead of transforming, and lossless coding has
    neither transform nor quantizer (1 op a sample).  Under dependent
    quantization an encoded TU of n = side^2 positions adds its trellis,
    272 ops a position: 6 level costs of ~8 ops (48), the up-sweep's
    n - 1 (min,+) 4x4 products of 64 adds and 48 minima (112 a
    position), the down-sweep's n - 1 nodes of 8 outputs of 4 adds and
    3 minima (56) and level 0's two 4-entry (min,+) rows and argmins
    (56); a decoded or reconstructed TU adds its states and
    state-dependent dequantization (8 ops a position).  Sign-data hiding
    adds each 4x4 group's parity and span scan (2 ops a position), not
    the move search that only mismatched groups run.  Under cfg.mtt a BT
    leaf of side s counts as its four TUs of side s/2 (each with its two
    s/4 chroma TUs), at their own transform choices (tu_sizes); a luma TU
    with LFNST adds its 16x16 matrix-vector products, 256 MACs each: the
    forward and the inverse when encoding, the inverse when decoding.
    Under cfg.cclm an I picture's chroma TU adds the linear model, 10
    ops a sample (its 2x2 luma mean 5, the model's multiply, add, shift,
    add and clip 5), when encoding for every CU with both predictions'
    SSE against the source (3 ops a sample each), 16 in all, when
    decoding only for the CUs whose mts value has bit 3 set.  A 64-TU
    (CU 64) transforms only its coded low 32x32 band: the forward's
    vertical pass makes 32 rows of 64 (64 MACs each) and its horizontal
    pass their 32 low columns, the inverse the same two products."""
    ops = 0.0
    for f in range(size_map.shape[0]):
        kinds = (pred_map[f] if pred_map is not None
                 else np.zeros_like(size_map[f]))
        modes = (mode_map[f] if mode_map is not None
                 else np.zeros_like(size_map[f]))
        mts = mts_map[f] if mts_map is not None else np.zeros_like(kinds)
        sm = tu_sizes(size_map[f], mts, cfg)
        uy, ux = np.mgrid[0:sm.shape[0], 0:sm.shape[1]]
        u = sm // 8
        origin = ((ux % u) == 0) & ((uy % u) == 0)
        for s, kind, mode, mv in zip(sm[origin], kinds[origin],
                                     modes[origin], mts[origin]):
            for side, n in ((int(s), 1), (int(s) // 2, 2)):
                luma = n == 1
                # intra: 4 taps a sample; bi: an add and a shift; MC: copy
                pred = (8 * side * side if kind == 0 else
                        2 * side * side if kind == 4 else 0)
                # a 64-TU (CU 64) transforms its coded 32x32 band only:
                # each way 32 x 64 x 64 and 32 x 32 x 64 MACs
                tx = 4 * side ** 3 if side < 64 else 6 * 32 * 32 * 64
                if cfg is not None and kind == 0 and luma:
                    if cfg.mip and mode >= cfg.n_intra_modes:
                        pred = 32 * side * side + 4 * side
                    elif cfg.pdpc and mode in (0, 1, 18, 50):
                        pred += 6 * side * side
                    if cfg.transform_skip and (mv & 7) == 5:
                        tx = side * side
                if cfg is not None and cfg.lossless:
                    tx = side * side
                if (cfg is not None and cfg.cclm and pred_map is None
                        and not luma):
                    pred += (16 if encode else 10 * ((mv >> 3) & 1)) * (
                        side * side)
                if (cfg is not None and cfg.lfnst and luma and kind == 0
                        and (mv >> 6) & 3 and not mv & 7):
                    tx += 2 * 256        # each way: one 16x16 matvec
                coded = not (encode and kind == 2)
                quant = 0
                if cfg is not None and cfg.dep_quant:
                    quant = side * side * (280 if encode and coded else
                                           0 if encode else 8)
                elif cfg is not None and cfg.sign_data_hiding and encode:
                    quant = 2 * side * side * coded
                ops += n * (pred + quant + (tx if encode and coded else 0)
                            + (tx if coded or not encode else 0))
    return ops


def tu_sizes(size_map, mts_map=None, cfg=None):
    """Each unit's TU side: under cfg.mtt a BT leaf (bits 4-5 of the mts
    map) tiles as TUs of half its side; else the CU's side."""
    if cfg is None or not cfg.mtt or mts_map is None:
        return size_map
    return np.where(((mts_map >> 4) & 3) > 0, size_map // 2, size_map)


def tu_walk(size_map, width: int, height: int, mts_map=None,
            cfg=None) -> dict:
    """The TUs a recon launch walks, derived from its size maps ((F,
    H/8, W/8), numpy; the kernel does not count them): per plane, the
    TUs of each size (a CU of side s has one luma TU of s and a Cb and a
    Cr TU of s/2; under MTT a BT leaf four TUs of s/2, tu_sizes; 64 where
    a CU-64 configuration codes one); the
    CTUs on the wavefront's chain, ctus_x + 2 (ctus_y
    - 1) (a batch's rows run at once, so its chain is one frame's); and
    the luma TUs on that chain, a frame's mean luma TUs per CTU times the
    chain.  The chain counts luma TUs only because the kernel runs the
    three planes at once, where its parent (d418144) ran them one after
    another: a CTU's step is divided by the same count for both."""
    size_map = tu_sizes(size_map, mts_map, cfg)
    u = size_map // 8
    uy, ux = np.mgrid[0:size_map.shape[1], 0:size_map.shape[2]]
    origin = ((ux % u) == 0) & ((uy % u) == 0)
    sizes = size_map[origin]
    ys = (8, 16, 32) + ((64,) if (sizes == 64).any() else ())
    walk = {"Y": {str(s): int((sizes == s).sum()) for s in ys}}
    for c in ("Cb", "Cr"):
        walk[c] = {str(s // 2): n for s, n in zip(ys, walk["Y"].values())}
    ctus_x, ctus_y = -(-width // 64), -(-height // 64)
    chain = ctus_x + 2 * (ctus_y - 1)
    luma_per_ctu = sizes.size / size_map.shape[0] / (ctus_x * ctus_y)
    return {"tus_by_size_map": walk, "chain_ctus": chain,
            "chain_luma_tus": luma_per_ctu * chain}


def per_chain(walk: dict, ms: float) -> dict:
    """A launch's ms per CTU and us per luma TU on its chain (tu_walk)."""
    return {"tus_by_size_map": walk["tus_by_size_map"],
            "ms_per_chain_ctu": ms / walk["chain_ctus"],
            "us_per_chain_luma_tu": 1e3 * ms / walk["chain_luma_tus"]}


def chain_text(walk: dict, **ms) -> str:
    """tu_walk's counts and, for each kernel=ms, its per_chain rates."""
    rates = ", ".join(
        f"{k} {r['ms_per_chain_ctu']:.4f} ms per CTU, "
        f"{r['us_per_chain_luma_tu']:.3f} us per luma TU"
        for k, r in ((k, per_chain(walk, t)) for k, t in ms.items()))
    return (f"TUs by the size map {walk['tus_by_size_map']}; chain "
            f"{walk['chain_ctus']} CTUs, {walk['chain_luma_tus']:.0f} luma "
            f"TUs: {rates}")


def tool_counts(cfg, maps) -> dict:
    """The intra tools' TUs on Pass-A maps (size, mode, mts; each (F,
    H/8, W/8)): MIP CUs, transform-skip luma TUs, PDPC-class luma TUs
    (planar, DC, pure H and V) and lossless TUs (luma and chroma)."""
    sm, mm, tm = (m.cpu().numpy() for m in maps)
    uy, ux = np.mgrid[0:sm.shape[1], 0:sm.shape[2]]
    u = sm // 8
    origin = ((ux % u) == 0) & ((uy % u) == 0)
    modes, mts = mm[origin], tm[origin]
    n = int(origin.sum())
    return {"mip": int((modes >= cfg.n_intra_modes).sum()) if cfg.mip
            else 0,
            "ts": int(((mts & 7) == 5).sum()) if cfg.transform_skip else 0,
            "pdpc": int(np.isin(modes, (0, 1, 18, 50)).sum()) if cfg.pdpc
            else 0,
            "lossless": 3 * n if cfg.lossless else 0}


def phase_environment():
    from x266_tpu_torch import _build, device
    from x266_tpu_torch.cabac import native_bind

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[env] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"[env] device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log(f"[env] nvidia-smi: {card_line()}")
    device.exact_float32()
    device.check_precision()
    if not native_bind.available():
        raise RuntimeError("native entropy coder did not build or load")
    log("[env] TF32 off; native entropy coder loaded")


def phase_build():
    from x266_tpu_torch import _build

    t0 = time.perf_counter()
    _build.LIBRARY.build()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    for line in build_lines(_build.LIBRARY.build_log):
        log(f"[build] {line}")


def kernel_name(mangled: str) -> str:
    """recon_kernel<encode,inter,b,quantizer,mtt/lfnst,cclm,cu64> for a
    recon instance, else the first name of the mangled symbol's (nested)
    name that holds "kernel"."""
    t = re.search(r"recon_kernelILb(\d)ELb(\d)ELb(\d)ELi(\d)ELb(\d)E"
                  r"Lb(\d)ELb(\d)E", mangled)
    if t:
        return "recon_kernel<%s,%s,%s,%s,%s,%s,%s>" % t.groups()
    pos = 3 if mangled.startswith("_ZN") else 2
    while m := re.match(r"\d+", mangled[pos:]):
        start = pos + m.end()
        name = mangled[start:start + int(m.group())]
        if "kernel" in name:
            return name
        pos = start + len(name)
    return mangled


def build_lines(build_log: str):
    """nvcc's warnings, and ptxas's registers, stack, spills and shared
    memory of each kernel (-Xptxas -v), each line with its kernel."""
    name = "?"
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "warning" in line:
            yield line.strip()
        elif "stack frame" in line or "Used" in line:
            yield f"{name}: {line.split(':')[-1].strip()}"


def _upload(frames):
    return [torch.from_numpy(np.stack([getattr(f, p) for f in frames]))
            .cuda() for p in ("y", "cb", "cr")]


def _inputs(cfg, n, seed, kind="mixed"):
    """Padded planes and Pass-A maps of n synthetic frames, on the card."""
    from x266_tpu_torch import tables
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import fused

    tab = tables.from_reference(cfg, "cuda")
    frames = synthetic_clip(cfg.width, cfg.height, n, kind, seed=seed)
    src = fused._unpack_padded(cfg, *_upload(frames))
    return tab, src, fused.make_pass_a(cfg, tab)(src[0])


def _max_err(got, ref) -> int:
    return max(int((g.int() - r.int()).abs().max()) for g, r in
               zip(got, ref))


def _require_equal(name, tag, names, got, ref):
    for n_, g, r in zip(names, got, ref):
        if not torch.equal(g, r):
            bad = (g != r).nonzero()[:5].tolist()
            raise AssertionError(f"{name} {tag} {n_} differs from the "
                                 f"plain version at {bad}")


def _record(stats, k, err, **kw):
    stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], err)
    stats[k].update(kw)


def compare_kernels(cfg, n, seed, stats, kind="mixed", tools=None,
                    phase="kernels"):
    """K1 and K2 against the plain scan on one input; bit-exact or raise.
    K1 runs on all n frames at once, as the encoder batches them; K2 on
    all n and on each frame alone, as the decoder calls it.  tools: a
    name under which the times go to stats[k]["tools"] instead of the
    kernel's own entry; the counts of the intra tools' TUs are printed,
    and a tool the config enables with no TU raises."""
    from x266_tpu_torch.engine import recon, recon_cuda

    tab, src, maps = _inputs(cfg, n, seed, kind)
    plain_enc = recon.make_recon_pass_raw(cfg, tab, encode=True)
    plain_dec = recon.make_recon_pass_raw(cfg, tab, encode=False)
    got = recon_cuda.recon_intra(cfg, tab, True, *src, *maps)
    ref, p1_ms = timed(plain_enc, *src, *maps)
    coefs = got[3:]
    pdec, p2_ms = timed(plain_dec, *coefs, *maps)
    dec = recon_cuda.recon_intra(cfg, tab, False, *coefs, *maps)
    err1 = _max_err(got, ref)
    err2 = max(_max_err(dec[:3], pdec[:3]), _max_err(dec[:3], got[:3]))
    one = [t[:1].contiguous() for t in (*coefs, *maps)]
    for f in range(n):
        dec1 = recon_cuda.recon_intra(
            cfg, tab, False, *[t[f:f + 1].contiguous()
                               for t in (*coefs, *maps)])
        err2 = max(err2, _max_err(dec1[:3], [p[f:f + 1] for p in pdec[:3]]))
    names = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr"]
    tag = f"{cfg.width}x{cfg.height}x{n} {cfg.profile.name}" + (
        f" {tools}" if tools else "")
    k1_ms = event_ms(recon_cuda.recon_intra, cfg, tab, True, *src, *maps)
    k2_ms = event_ms(recon_cuda.recon_intra, cfg, tab, False, *one)
    counts = tool_counts(cfg, maps)
    sm = maps[0].cpu().numpy()
    walk1 = tu_walk(sm, cfg.width, cfg.height)
    walk2 = tu_walk(sm[:1], cfg.width, cfg.height)
    log(f"[{phase}] {tag}: K1 {k1_ms:.3f} ms for {n} frames (plain "
        f"{p1_ms:.0f} ms) max_abs_err {err1}; K2 {k2_ms:.3f} ms per frame "
        f"(plain {p2_ms / n:.0f} ms) max_abs_err {err2}; tool TUs {counts}")
    log(f"[{phase}] {tag}: K1 {chain_text(walk1, K1=k1_ms)}")
    log(f"[{phase}] {tag}: K2 {chain_text(walk2, K2=k2_ms)}")
    _require_equal("K1", tag, names, got, ref)
    if err2:
        raise AssertionError(f"K2 {tag} differs from the plain scan")
    for flag, key in (("mip", "mip"), ("transform_skip", "ts"),
                      ("pdpc", "pdpc"), ("lossless", "lossless")):
        if getattr(cfg, flag) and counts[key] == 0:
            raise AssertionError(f"[{phase}] {tag}: {flag} is on but no TU "
                                 "took its branch")
    if cfg.lossless:
        _require_equal("K1", tag + " lossless recon", names[:3], got[:3],
                       [p[:, 1:1 + q.shape[1], 1:1 + q.shape[2]]
                        for p, q in zip(src, got[:3])])
    shape = f"{cfg.width}x{cfg.height}"
    hm = [m.cpu().numpy() for m in maps]
    tabs = (tab.k_taps, tab.k_smooth, tab.k_tx, tab.k_shift, tab.k_mip)
    b1 = bound(nbytes(*src, *maps, *got, *tabs, tab.rate),
               recon_ops(hm[0], True, None, hm[1], hm[2], cfg))
    b2 = bound(nbytes(*one, *(d[:1] for d in dec[:3]), *tabs),
               recon_ops(hm[0][:1], False, None, hm[1][:1], hm[2][:1], cfg))
    if tools:
        for k, ms, pms, b, walk in (("K1", k1_ms, p1_ms, b1, walk1),
                                    ("K2", k2_ms, p2_ms / n, b2, walk2)):
            stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"],
                                          err1 if k == "K1" else err2)
            stats[k].setdefault("tools", {})[tools] = {
                "ms": ms, "plain_ms": pms, "bound_ms": b[0],
                "bound_by": b[1], "shape": f"{shape}x{n if k == 'K1' else 1}",
                "tool_tus": counts, **per_chain(walk, ms)}
        return
    _record(stats, "K1", err1, ms=k1_ms, plain_ms=p1_ms, bound_ms=b1[0],
            bound_by=b1[1], shape=f"{shape}x{n}", **per_chain(walk1, k1_ms))
    _record(stats, "K2", err2, ms=k2_ms, plain_ms=p2_ms / n,
            bound_ms=b2[0], bound_by=b2[1], shape=f"{shape}x1",
            **per_chain(walk2, k2_ms))


def main_cfg():
    from x266_tpu_torch.config import preset_cfg2

    return preset_cfg2(1920, 1080).replace(rows_per_segment=1,
                                           ctx_inherit=True)


def phase_kernels_sse(stats):
    """Kernel SSE against its plain versions, bit for bit, both outputs
    (the float32 SSE in XLA's order, cost.plane_sse_f32_plain, and the
    int64 SSE, fused.frame_sse), on the three planes of the main paths'
    calls: config 2's step (four 1080p frames), one 4K picture, cfg5's
    112x80 and lossless_ra's 416x240 (widths that are not multiples of
    32): each near its source (a coded picture's error, exact sums) and
    far from it (sums past 2^24 that round, so only XLA's order gives the
    same bits); one launch a call; timed at the first two beside the
    bound and the plain versions."""
    from x266_tpu_torch.engine import fused
    from x266_tpu_torch.kernels import cost, sse_cuda

    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(shape, lo, hi):
        return torch.randint(lo, hi, shape, device="cuda", generator=gen)

    def plain(recs, origs):
        return (torch.stack([cost.plane_sse_f32_plain(r, o)
                             for r, o in zip(recs, origs)], dim=1),
                torch.stack([fused.frame_sse(r, o)
                             for r, o in zip(recs, origs)], dim=1))

    for n, h, w, timed_here in ((4, 1080, 1920, True),
                                (1, 2160, 3840, True),
                                (1, 80, 112, False), (1, 240, 416, False)):
        shapes = ((n, h, w), (n, h // 2, w // 2), (n, h // 2, w // 2))
        origs = [rand(s, 0, 256).to(torch.uint8) for s in shapes]
        near = [(o.int() + rand(o.shape, -6, 7)).clamp(0, 255).to(
            torch.uint8) for o in origs]
        far = [(torch.where(o < 128, 255, 0) ^ rand(o.shape, 0, 64)).to(
            torch.uint8) for o in origs]
        tag = f"{n}x{h}x{w}"
        for kind, recs in (("near", near), ("far", far)):
            before = sse_cuda.LAUNCHES["SSE"]
            got = sse_cuda.picture_sse(recs, origs)
            if sse_cuda.LAUNCHES["SSE"] != before + 1:
                raise AssertionError("[kernels-sse] not one launch a call")
            ref, p_ms = timed(plain, recs, origs)
            _require_equal("SSE", f"{tag} {kind}", ("sse", "sse_exact"),
                           got, ref)
        if not timed_here:
            log(f"[kernels-sse] {tag}: sse and sse_exact near and far "
                "bit-exact")
            continue
        ms = event_ms(sse_cuda.picture_sse, near, origs, reps=20)
        b = bound(nbytes(*near, *origs, *got), 3.0 * sum(
            o.numel() for o in origs))
        log(f"[kernels-sse] {tag} and its chroma: SSE {ms:.4f} ms a call "
            f"(plain {p_ms:.0f} ms, bound {b[0]:.4f} ms, {b[1]}), sse and "
            "sse_exact near and far bit-exact")
        if n == 4:
            _record(stats, "SSE", 0, ms=ms, plain_ms=p_ms, bound_ms=b[0],
                    bound_by=b[1], shape=f"{tag} + 2x{n}x{h // 2}x{w // 2}")
        else:
            stats["SSE"]["at_4k"] = {"ms": ms, "plain_ms": p_ms,
                                     "bound_ms": b[0], "bound_by": b[1]}


def cfg2t(w=1920, h=1080):
    """Config 2 with VVC's intra tools: PDPC, MIP and transform skip."""
    from x266_tpu_torch.config import preset_cfg2

    return preset_cfg2(w, h).replace(pdpc=True, mip=True,
                                     transform_skip=True,
                                     rows_per_segment=1, ctx_inherit=True)


def lossless_cfg(w=1920, h=1080):
    """ai_hevc_lossless's configuration."""
    from x266_tpu_torch.config import CodecConfig

    return CodecConfig(width=w, height=h, qp=32, lossless=True, rdoq=False)


def phase_kernels_tools(stats):
    """K1 and K2's lossless, transform-skip, PDPC and MIP branches
    against the plain scan on Pass-A maps: each tool alone at 416x240
    (transform skip on text content, which it targets; PDPC and MIP on
    the motion clip, where Pass A picks MIP in some 10 % of the CUs),
    then cfg2t and lossless at 1080p: K1 on the encoder's batch of 4,
    frame 0's recon and levels against the plain encode scan (on the
    CPU, where it walks the CUs about twice as fast as on the card, in a
    worker process while the later phases run), and K2 on frame 0's
    levels against K1's recon, which equals the plain scan's; both
    timed."""
    from x266_tpu_torch.config import CodecConfig, preset_cfg2
    from x266_tpu_torch.engine import recon_cuda

    w, h = 416, 240
    for name, cfg, kind in (
            ("lossless", lossless_cfg(w, h), "mixed"),
            ("ts", CodecConfig(width=w, height=h, qp=32, rdoq=True,
                               transform_skip=True), "text"),
            ("pdpc", preset_cfg2(w, h).replace(pdpc=True), "motion"),
            ("mip", preset_cfg2(w, h).replace(mip=True), "motion")):
        compare_kernels(cfg, 1, 13, stats, kind, f"{name} {w}x{h}",
                        "kernels-tools")
    names = ("reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr")
    for name, make, kind in (("cfg2t", cfg2t, "text"),
                             ("lossless", lossless_cfg, "mixed")):
        cfg = make()
        tag = f"{name} 1080p"
        tab, src, maps = _inputs(cfg, 4, 0, kind)
        got = recon_cuda.recon_intra(cfg, tab, True, *src, *maps)
        entry = stats["K1"].setdefault("tools", {}).setdefault(
            f"{tag} x4", {})
        on_cpu("kernels-tools", k1_frame0_check(tag, names, got, entry),
               _plain_intra_encode_cpu, cfg,
               [t[:1].cpu().numpy() for t in (*src, *maps)])
        one = [t[:1].contiguous() for t in (*got[3:], *maps)]
        dec = recon_cuda.recon_intra(cfg, tab, False, *one)
        _require_equal("K2", tag, names[:3], dec[:3],
                       [g[:1] for g in got[:3]])
        if cfg.lossless:
            _require_equal("K1", tag + " lossless recon", names[:3], got[:3],
                           [p[:, 1:1 + q.shape[1], 1:1 + q.shape[2]]
                            for p, q in zip(src, got[:3])])
        counts = tool_counts(cfg, maps)
        for flag, key in (("mip", "mip"), ("transform_skip", "ts"),
                          ("pdpc", "pdpc"), ("lossless", "lossless")):
            if getattr(cfg, flag) and counts[key] == 0:
                raise AssertionError(f"[kernels-tools] {tag}: {flag} is on "
                                     "but no TU took its branch")
        k1_ms = event_ms(recon_cuda.recon_intra, cfg, tab, True, *src,
                         *maps)
        k2_ms = event_ms(recon_cuda.recon_intra, cfg, tab, False, *one)
        hm = [m.cpu().numpy() for m in maps]
        tabs = (tab.k_taps, tab.k_smooth, tab.k_tx, tab.k_shift, tab.k_mip)
        b1 = bound(nbytes(*src, *maps, *got, *tabs, tab.rate),
                   recon_ops(hm[0], True, None, hm[1], hm[2], cfg))
        b2 = bound(nbytes(*one, *(d[:1] for d in dec[:3]), *tabs),
                   recon_ops(hm[0][:1], False, None, hm[1][:1], hm[2][:1],
                             cfg))
        log(f"[kernels-tools] {tag}: K2 on frame 0's levels equals K1's "
            f"recon; K1's frame 0 is held to the plain encode scan on the "
            f"cpu in a worker process (checked before the kernels line)")
        for k, key, ms, b, sm, shape in (
                ("K1", f"{tag} x4", k1_ms, b1, hm[0], "1920x1080x4"),
                ("K2", tag, k2_ms, b2, hm[0][:1], "1920x1080x1")):
            walk = tu_walk(sm, cfg.width, cfg.height)
            tus = tool_counts(cfg, [m[:sm.shape[0]] for m in maps])
            stats[k]["tools"].setdefault(key, {}).update({
                "ms": ms, "bound_ms": b[0], "bound_by": b[1],
                "shape": shape, "tool_tus": tus, **per_chain(walk, ms)})
            log(f"[kernels-tools] {key}: {k} {ms:.3f} ms (bound "
                f"{b[0]:.4f} ms, {b[1]}); {chain_text(walk, **{k: ms})}; "
                f"tool TUs {tus}")


def k1_frame0_check(tag, names, got, entry):
    """The check of K1's frame 0 (got) against the plain encode scan's
    outputs from a worker; its CPU time goes into entry."""
    got0 = [g[:1].cpu() for g in got]

    def check(ref, ms):
        _require_equal("K1", tag, names, got0,
                       [torch.from_numpy(r) for r in ref])
        entry["plain_ms_cpu_frame"] = ms
        log(f"[kernels-tools] {tag}: K1 frame 0 of 4 equals the plain scan "
            f"(plain {ms:.0f} ms on the cpu for one frame, in a worker "
            f"process); max_abs_err 0")
    return check


def phase_kernels(stats):
    from x266_tpu_torch.config import CodecConfig, preset_cfg2

    for w, h in ((128, 64), (416, 240)):
        compare_kernels(preset_cfg2(w, h), 2, 11, stats)
        compare_kernels(CodecConfig(width=w, height=h, qp=32, rdoq=True),
                        2, 12, stats)
    # the main path's frames and shapes: K1 on the encoder's batch of 4
    # frames, K2 on one frame at a time
    compare_kernels(main_cfg(), 4, 0, stats)


def me_inputs(cfg, seed):
    """The motion kernels' inputs on the card: a 'mixed' picture's
    planes, the pyramids of its reference (the picture shifted (2, -3) in
    luma and (1, -1) in chroma), the ME block grid's current luma and the
    coarse search's base MVs: (planes, pyramids, cur, base)."""
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import fused
    from x266_tpu_torch.kernels import me

    planes = _upload(synthetic_clip(cfg.width, cfg.height, 1, "mixed",
                                    seed=seed))
    refs = [torch.roll(p[0], sh, (0, 1))
            for p, sh in zip(planes, ((2, -3), (1, -1), (1, -1)))]
    pyrs = fused.build_pyramids_device(*refs)
    cur = me._ceil_pad(planes[0][0].to(torch.int32))
    base = me.coarse_search(cur, pyrs[0], float(cfg.lambda_mode))
    return planes, pyrs, cur, base


def me_fields(grid, max_cu_size):
    """The MV fields B Pass A warps for an ME grid: L0's (T = 6 with 32x32
    CUs) and L1's (T = 2), as engine/inter.py builds them."""
    from x266_tpu_torch.engine import inter

    l1 = [grid] + ([inter._rep2(grid, *grid.shape[:2])]
                   if max_cu_size >= 32 else [])
    return (inter.warp_fields(grid, max_cu_size),
            torch.stack(l1).contiguous())


def check_k5(tag, cur, pyr, base):
    """K5 against its plain version on the card, bit for bit or raise,
    timed (CUDA events), with its bound: (the plain version's MVs, the
    pyramid bytes its candidates address, the kernel's record)."""
    from x266_tpu_torch.kernels import me, me_cuda

    mv = me_cuda.refine_search(cur, pyr, base)
    ref, p_ms = timed(me.refine_search_ref, cur, pyr, base)
    err = _max_err([mv], [ref])
    _require_equal("K5", tag, ["mv"], [mv], [ref])
    ms = event_ms(me_cuda.refine_search, cur, pyr, base, reps=20)
    reads = k5_read_bytes(pyr, cur, base)
    b = bound(nbytes(cur, base, mv) + reads,
              3.0 * 43 * 256 * base.numel() // 2)
    return ref, reads, dict(err=err, ms=ms, plain_ms=p_ms, bound_ms=b[0],
                            bound_by=b[1], shape=tag)


def check_k4(tag, pyr, mvs):
    """K4 against its plain version on the card, bit for bit or raise,
    timed, with its bound and the time of one advanced-indexing gather on
    precomputed indices (the library call: timed here, used nowhere in
    the port): (the pyramid bytes the MVs address, the kernel's record)."""
    from x266_tpu_torch.kernels import me_cuda

    got = me_cuda.warp_frames_cuda(pyr, mvs)
    ref, p_ms = timed(me_cuda.warp_frames_ref, pyr, mvs)
    err = _max_err([got], [ref])
    _require_equal("K4", tag, ["frames"], [got], [ref])
    ms = event_ms(me_cuda.warp_frames_cuda, pyr, mvs, reps=20)
    idx = me_cuda.warp_index(mvs)
    lib_ms = event_ms(lambda: pyr[idx], reps=20)
    reads = read_bytes(pyr, idx)
    b = bound(nbytes(mvs, got) + reads, 0)
    n = mvs.numel() // 2 * 256
    return reads, dict(err=err, ms=ms, plain_ms=p_ms, bound_ms=b[0],
                       bound_by=b[1], library_ms=lib_ms,
                       shape=f"{tag} T={mvs.shape[0]} ({n} samples)")


def me_text(*records) -> str:
    """K4's and K5's records as one log line's text."""
    return "; ".join(
        f"{'K4' if 'library_ms' in r else 'K5'} {r['shape']}: "
        f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
        f"{r['bound_by']}, plain {r['plain_ms']:.2f} ms"
        + (f", one indexing gather {r['library_ms']:.4f} ms"
           if 'library_ms' in r else "") + f") err {r['err']}"
        for r in records)


def compare_p_kernels(cfg, seed, stats):
    """K3-P (encode, decode), K4 and K5 against their plain versions on
    one P picture whose reference is the frame shifted (2, -3) in luma
    and (1, -1) in chroma; bit-exact or raise."""
    from x266_tpu_torch import tables
    from x266_tpu_torch.engine import fused, inter, recon_cuda
    from x266_tpu_torch.kernels import interp

    tab = tables.from_reference(cfg, "cuda")
    planes, pyrs, cur, base = me_inputs(cfg, seed)
    src = fused._unpack_padded(cfg, *planes)
    tag = f"{cfg.width}x{cfg.height} cu{cfg.max_cu_size}" + (
        " merge" if cfg.merge_cands else "") + (
        " subst" if cfg.ref_substitute else "")

    # K5 on the main path's ME inputs, K4 on Pass A's fields (T = 6 with
    # 32x32 CUs)
    ref5, reads5, r5 = check_k5(tag, cur, pyrs[0], base)
    bd = interp.mv_bounds(cfg, 16) - 8
    mvs = inter.warp_fields(ref5.clamp(-bd, bd), cfg.max_cu_size)
    reads4, r4 = check_k4(tag, pyrs[0], mvs)

    # K3-P on Pass A's maps, encode then decode of its levels
    maps = [mp[None] for mp in inter.make_mode_decision_p_raw(cfg, tab)(
        src[0][0], pyrs[0])]
    mts = torch.zeros_like(maps[0])
    args = (maps[0], maps[1], mts, *maps[2:], *pyrs)
    got = recon_cuda.recon_inter(cfg, tab, True, *src, *args)
    ref, p3_ms = timed(inter.make_recon_inter_raw(cfg, tab, True), *src,
                       *args)
    names = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr",
             "mvx_fin", "mvy_fin"]
    err3 = _max_err(got, ref)
    _require_equal("K3", tag, names, got, ref)
    dargs = (*got[3:6], maps[0], maps[1], mts, maps[2],
             got[6].int(), got[7].int(), *pyrs)
    dec = recon_cuda.recon_inter(cfg, tab, False, *dargs)
    pdec, p3d_ms = timed(inter.make_recon_inter_raw(cfg, tab, False), *dargs)
    err3d = max(_max_err(dec[:3], pdec[:3]), _max_err(dec[:3], got[:3]))
    _require_equal("K3d", tag, names[:3], dec[:3], pdec[:3])
    _require_equal("K3d", tag, names[:3], dec[:3], got[:3])
    k3_ms = event_ms(recon_cuda.recon_inter, cfg, tab, True, *src, *args)
    k3d_ms = event_ms(recon_cuda.recon_inter, cfg, tab, False, *dargs)
    kinds = np.bincount(maps[2].cpu().numpy().ravel(), minlength=3)
    log(f"[kernels-p] {tag}: units intra/inter/skip {kinds.tolist()}; "
        f"K3 {k3_ms:.3f} ms (plain {p3_ms:.0f} ms) err {err3}; K3d "
        f"{k3d_ms:.3f} ms (plain {p3d_ms:.0f} ms) err {err3d}; "
        f"{me_text(r4, r5)}")

    # bounds: every input and output whole, except the pyramids, of
    # which only the bytes this run's MVs address count
    hm = [mp.cpu().numpy() for mp in maps]
    tabs = (tab.k_taps, tab.k_smooth, tab.k_tx, tab.k_shift)
    reads3 = k3_read_bytes(pyrs, maps[0], maps[2], got[6], got[7])
    b3 = bound(nbytes(*src, *args[:6], *got, *tabs, tab.rate) + reads3,
               recon_ops(hm[0], True, hm[2]))
    b3d = bound(nbytes(*dargs[:9], *dec[:3], *tabs) + reads3,
                recon_ops(hm[0], False, hm[2]))
    log(f"[kernels-p] {tag}: pyramid bytes read (of "
        f"{nbytes(pyrs[0])} luma): K3 {reads3}, K4 {reads4}, K5 {reads5}; "
        f"bounds K3 {b3[0]:.4f} ms ({b3[1]}), K3d {b3d[0]:.4f} ms "
        f"({b3d[1]}), K4 {r4['bound_ms']:.4f} ms ({r4['bound_by']}), K5 "
        f"{r5['bound_ms']:.4f} ms ({r5['bound_by']})")
    shape = f"{cfg.width}x{cfg.height}"
    walk = tu_walk(hm[0], cfg.width, cfg.height)
    log(f"[kernels-p] {tag}: {chain_text(walk, K3=k3_ms, K3d=k3d_ms)}")
    _record(stats, "K3", err3, ms=k3_ms, plain_ms=p3_ms, bound_ms=b3[0],
            bound_by=b3[1], shape=shape, **per_chain(walk, k3_ms))
    _record(stats, "K3d", err3d, ms=k3d_ms, plain_ms=p3d_ms,
            bound_ms=b3d[0], bound_by=b3d[1], shape=shape,
            **per_chain(walk, k3d_ms))
    _record(stats, "K4", **r4)
    _record(stats, "K5", **r5)


def cfg3():
    from x266_tpu_torch.config import preset_cfg3

    return preset_cfg3(1920, 1080)


def phase_kernels_p(stats):
    from x266_tpu_torch.config import CodecConfig, preset_cfg3

    # the P configs of tests/test_recon_pallas.py (ME reaches into the
    # pad at 112x80), then 416x240, then the main path's shapes
    for cfg in (
            CodecConfig(width=112, height=80, qp=30, intra_period=8),
            CodecConfig(width=128, height=64, qp=35, intra_period=8,
                        max_cu_size=16),
            CodecConfig(width=112, height=80, qp=30, intra_period=8,
                        merge_cands=True),
            CodecConfig(width=112, height=80, qp=30, intra_period=8,
                        ref_substitute=True),
            preset_cfg3(416, 240), cfg3()):
        compare_p_kernels(cfg, 3, stats)


def phase_kernels_me_4k(stats):
    """[kernels-me-4k]: K5 and K4 at config 4's 3840x2160, on inputs built
    as [kernels-p] builds them: K5 on the coarse search's base, K4 on the
    fields B Pass A warps (L0 T = 6, L1 T = 2) of K5's grid."""
    from x266_tpu_torch.kernels import interp

    cfg = cfg4()
    _, pyrs, cur, base = me_inputs(cfg, 3)
    tag = f"{cfg.width}x{cfg.height}"
    ref5, reads5, r5 = check_k5(tag, cur, pyrs[0], base)
    bd = interp.mv_bounds(cfg, 16) - 8
    recs = [r5]
    for mvs in me_fields(ref5.clamp(-bd, bd), cfg.max_cu_size):
        reads4, r4 = check_k4(tag, pyrs[0], mvs)
        recs.append(r4)
        log(f"[kernels-me-4k] {tag}: K4 T={mvs.shape[0]} reads {reads4} "
            "pyramid bytes")
    log(f"[kernels-me-4k] {tag}: K5 reads {reads5} pyramid bytes (of "
        f"{nbytes(pyrs[0])} luma); {me_text(*recs)}")
    for k, r in zip(("K5", "K4", "K4"), recs):
        stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], r["err"])
        stats[k].setdefault("at_4k", []).append(
            {key: v for key, v in r.items() if key != "err"})


def b_references(planes, amp=8, seed=5):
    """The L0 and L1 pyramids of a B test picture: the planes (each (1,
    h, w)) shifted two ways, with noise of +-amp on L0's left two thirds
    and L1's right two thirds, so that L0, bi and L1 each pay somewhere
    (as tests/test_torch_kernel_host.py builds them)."""
    from x266_tpu_torch.engine import fused

    gen = torch.Generator(device=planes[0].device).manual_seed(seed)

    def ref(p, sh, cols):
        p = torch.roll(p[0], sh, (0, 1)).int()
        w = p.shape[1]
        n = torch.randint(-amp, amp + 1, p.shape, generator=gen,
                          device=p.device)
        keep = torch.zeros(w, dtype=torch.bool, device=p.device)
        keep[cols(w)] = True
        return (p + torch.where(keep, 0, n)).clamp(0, 255).to(torch.uint8)

    return [fused.build_pyramids_device(*(
        ref(p, sh, cols) for p, sh in zip(planes, shifts)))
        for shifts, cols in (
            (((2, -3), (1, 0), (1, 0)), lambda w: slice(2 * w // 3, w)),
            (((-1, 2), (0, -1), (0, -1)), lambda w: slice(0, w // 3)))]


def compare_b_kernels(cfg, seed, stats, record=False):
    """K3-B (encode, decode) against the plain B scan on one B picture of
    b_references, on the port's B Pass-A maps; bit-exact or raise, and
    L1 and bi CUs must occur.  record: this shape's times and bounds go
    into the kernels line."""
    from x266_tpu_torch import tables
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import fused, inter, recon_cuda

    tab = tables.from_reference(cfg, "cuda")
    planes = _upload(synthetic_clip(cfg.width, cfg.height, 1, "mixed",
                                    seed=seed))
    p0, p1 = b_references(planes)
    src = fused._unpack_padded(cfg, *planes)
    tag = f"{cfg.width}x{cfg.height} cu{cfg.max_cu_size}" + (
        " merge" if cfg.merge_cands else "") + (
        " subst" if cfg.ref_substitute else "")
    maps, pa_ms = timed(inter.make_mode_decision_b_raw(cfg, tab),
                        src[0][0], p0[0], p1[0])
    maps = [m[None] for m in maps]
    kinds = np.bincount(maps[2].cpu().numpy().ravel(), minlength=5)
    if not (kinds[inter.PRED_L1] and kinds[inter.PRED_BI]):
        raise AssertionError(f"K3B {tag}: no L1 or bi CUs ({kinds})")
    mts = torch.zeros_like(maps[0])
    args = (maps[0], maps[1], mts, *maps[2:5], *p0, *p1, maps[5], maps[6])
    got = recon_cuda.recon_inter(cfg, tab, True, *src, *args)
    ref, pb_ms = timed(inter.make_recon_inter_raw(cfg, tab, True, True),
                       *src, *args)
    names = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr",
             "mvx_fin", "mvy_fin"]
    errb = _max_err(got, ref)
    _require_equal("K3B", tag, names, got, ref)
    dargs = (maps[0], maps[1], mts, maps[2], got[6].int(), got[7].int(),
             *p0, *p1, maps[5], maps[6])
    dec = recon_cuda.recon_inter(cfg, tab, False, *got[3:6], *dargs)
    pdec, pbd_ms = timed(inter.make_recon_inter_raw(cfg, tab, False, True),
                         *got[3:6], *dargs)
    errbd = max(_max_err(dec, pdec), _max_err(dec[:3], got[:3]))
    _require_equal("K3Bd", tag, names, dec, pdec)
    _require_equal("K3Bd", tag, names[:3], dec[:3], got[:3])
    kb_ms = event_ms(recon_cuda.recon_inter, cfg, tab, True, *src, *args)
    kbd_ms = event_ms(recon_cuda.recon_inter, cfg, tab, False, *got[3:6],
                      *dargs)
    log(f"[kernels-b] {tag}: units intra/L0/skip/L1/bi {kinds.tolist()}; "
        f"B Pass A {pa_ms:.1f} ms; K3B {kb_ms:.3f} ms (plain {pb_ms:.0f} "
        f"ms) err {errb}; K3Bd {kbd_ms:.3f} ms (plain {pbd_ms:.0f} ms) "
        f"err {errbd}")
    # bounds: every input and output whole, except the pyramids, of
    # which only the windows this run's MVs address count: L0 at the
    # final MV for L0, skip and bi CUs, L1 at it for L1 CUs and at mv1
    # for bi CUs
    hm = [mp.cpu().numpy() for mp in maps]
    tabs = (tab.k_taps, tab.k_smooth, tab.k_tx, tab.k_shift)
    reads = (read_union(p0, [(maps[0], maps[2], got[6], got[7], (1, 2, 4))])
             + read_union(p1, [(maps[0], maps[2], got[6], got[7], (3,)),
                               (maps[0], maps[2], maps[5], maps[6], (4,))]))
    bb = bound(nbytes(*src, *args[:6], maps[5], maps[6], *got, *tabs,
                      tab.rate) + reads, recon_ops(hm[0], True, hm[2]))
    bbd = bound(nbytes(*dargs[:6], maps[5], maps[6], *got[3:6], *dec[:3],
                       *tabs) + reads, recon_ops(hm[0], False, hm[2]))
    log(f"[kernels-b] {tag}: pyramid bytes read {reads} (of "
        f"{2 * nbytes(*p0)}); bounds K3B {bb[0]:.4f} ms ({bb[1]}), K3Bd "
        f"{bbd[0]:.4f} ms ({bbd[1]})")
    _record(stats, "K3B", errb)
    _record(stats, "K3Bd", errbd)
    walk = tu_walk(hm[0], cfg.width, cfg.height)
    log(f"[kernels-b] {tag}: {chain_text(walk, K3B=kb_ms, K3Bd=kbd_ms)}")
    if record:
        check_filters(cfg, tab, tag, planes, p0, p1, got, maps)
        shape = f"{cfg.width}x{cfg.height}"
        _record(stats, "K3B", errb, ms=kb_ms, plain_ms=pb_ms,
                bound_ms=bb[0], bound_by=bb[1], shape=shape,
                **per_chain(walk, kb_ms))
        _record(stats, "K3Bd", errbd, ms=kbd_ms, plain_ms=pbd_ms,
                bound_ms=bbd[0], bound_by=bbd[1], shape=shape,
                **per_chain(walk, kbd_ms))


def read_union(pyrs, parts) -> int:
    """Pyramid bytes of pyrs (luma, Cb, Cr) that the MC windows of
    several (size_map, pred_map, mvx, mvy, kinds) selections read, each
    byte counted once: each CU whose kind is in kinds, at its MV (chroma
    at MV >> 1)."""
    masks = [torch.zeros(p.shape, dtype=torch.bool, device=p.device)
             for p in pyrs]
    for part in parts:
        _mark_windows(masks, *part)
    return sum(int(m.sum()) * p.element_size() for m, p in zip(masks, pyrs))


def _mark_windows(masks, size_map, pred_map, mvx, mvy, kinds):
    sm, pm = size_map[0], pred_map[0]
    mx, my = mvx[0].int(), mvy[0].int()
    uy, ux = torch.meshgrid(torch.arange(sm.shape[0], device=sm.device),
                            torch.arange(sm.shape[1], device=sm.device),
                            indexing="ij")
    u = sm // 8
    cu = ((ux % u) == 0) & ((uy % u) == 0) & torch.isin(
        pm, torch.tensor(kinds, device=pm.device))
    for s in (8, 16, 32):
        sel = cu & (sm == s)
        x, y, vx, vy = ux[sel] * 8, uy[sel] * 8, mx[sel], my[sel]
        masks[0][mc_index(x, y, vx, vy, s)] = True
        for m in masks[1:]:
            m[mc_index(x // 2, y // 2, vx >> 1, vy >> 1, s // 2)] = True


def cfg4(width=3840, height=2160):
    from x266_tpu_torch.config import preset_cfg4

    return preset_cfg4(width, height)


def phase_kernels_b(stats):
    from x266_tpu_torch.config import CodecConfig

    # the B config of tests/test_recon_pallas.py, one with merge
    # candidates and substitution, then config 4's picture sizes
    for cfg, record in (
            (CodecConfig(width=112, height=80, qp=30, intra_period=8,
                         gop_size=4), False),
            (CodecConfig(width=128, height=64, qp=32, intra_period=8,
                         gop_size=4, rdoq=True, ref_substitute=True,
                         merge_cands=True), False),
            (cfg4(416, 240), False), (cfg4(1920, 1080), False),
            (cfg4(), True)):
        compare_b_kernels(cfg, 21, stats, record)


# the intra tools on P and B pictures ([kernels-p-tools], [kernels-b-tools])
def inter_tools():
    from x266_tpu_torch.config import Profile

    return {"lossless": dict(lossless=True, rdoq=False),
            "ts": dict(transform_skip=True, rdoq=True),
            "pdpc": dict(profile=Profile.VVC, pdpc=True),
            "mip": dict(profile=Profile.VVC, mip=True)}


def tools_ra_cfg(w=1920, h=1080):
    """The tools_ra clip's configuration: config 4 with VVC's intra tools
    (with MTS: the reference codes transform skip on P and B pictures
    only beside it)."""
    from x266_tpu_torch.config import Profile

    return cfg4(w, h).replace(profile=Profile.VVC, mts=True, pdpc=True,
                              mip=True, transform_skip=True)


def lossless_p_cfg(w=1920, h=1080):
    from x266_tpu_torch.config import preset_cfg3

    return preset_cfg3(w, h).replace(lossless=True, rdoq=False)


def lossless_ra_cfg(w=416, h=240):
    """Random access, lossless, without loop filters (a lossless user
    runs none)."""
    return cfg4(w, h).replace(lossless=True, rdoq=False, deblock=False,
                              sao=False, sao_chroma=False, alf=False,
                              alf_chroma=False)


def inter_tool_counts(cfg, maps, mts) -> dict:
    """CUs of a P or B picture that take the intra tools' branches in K3:
    lossless inter and skip CUs, MIP and PDPC-class (planar, DC, pure H,
    pure V) intra CUs, transform-skip intra TUs; and the CUs predicted
    from L1 alone and from both lists (B pictures)."""
    sm, mm, pm, tm = (m[0].cpu().numpy() for m in (*maps[:3], mts))
    uy, ux = np.mgrid[0:sm.shape[0], 0:sm.shape[1]]
    u = sm // 8
    o = ((ux % u) == 0) & ((uy % u) == 0)
    intra = o & (pm == 0)
    return {"lossless_inter": int((o & (pm > 0)).sum()) if cfg.lossless
            else 0,
            "lossless_skip": int((o & (pm == 2)).sum()) if cfg.lossless
            else 0,
            "mip": int((intra & (mm >= cfg.n_intra_modes)).sum())
            if cfg.mip else 0,
            "pdpc": int((intra & np.isin(mm, (0, 1, 18, 50))).sum())
            if cfg.pdpc else 0,
            "ts": int((intra & ((tm & 7) == 5)).sum())
            if cfg.transform_skip else 0,
            "l1": int((o & (pm == 3)).sum()), "bi": int((o & (pm == 4)).sum())}


def compare_inter_tool_kernels(tag, cfg, b, stats, seed, force=None,
                               record=None):
    """K3-P (b False) or K3-B, encode and decode, against the plain scan
    on one 'motion' picture whose references are b_references with
    +-40 noise (so intra CUs, MIP and PDPC-class ones among them, sit
    beside inter ones), on the port's own Pass-A maps; bit-exact or
    raise, and each tool the config enables must have CUs.  force:
    "skip" turns one coded 16x16 inter CU into a skip CU (lossless Pass
    A never picks skip), "ts" writes transform skip (map value 5) on the
    intra CUs (a P or B picture's map is 0).  record: a name under which
    the times and bounds go to stats[k]["tools"]."""
    from x266_tpu_torch import tables
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import fused, inter, recon_cuda

    tab = tables.from_reference(cfg, "cuda")
    planes = _upload(synthetic_clip(cfg.width, cfg.height, 1, "motion",
                                    seed=seed))
    p0, p1 = b_references(planes, amp=40)
    src = fused._unpack_padded(cfg, *planes)
    if b:
        maps = inter.make_mode_decision_b_raw(cfg, tab)(src[0][0], p0[0],
                                                       p1[0])
    else:
        maps = inter.make_mode_decision_p_raw(cfg, tab)(src[0][0], p0[0])
    maps = [m[None].contiguous() for m in maps]
    mts = torch.zeros_like(maps[0])
    if force == "skip":
        sel = ((maps[2] > 0) & (maps[0] == 16)).nonzero()
        _, uy, ux = (int(v) & ~1 for v in sel[0])
        maps[2][0, uy:uy + 2, ux:ux + 2] = inter.PRED_SKIP
    elif force == "ts":
        mts = torch.where(maps[2] == inter.PRED_INTRA, 5, mts)
    counts = inter_tool_counts(cfg, maps, mts)
    args = (maps[0], maps[1], mts, *maps[2:5], *p0)
    if b:
        args += (*p1, maps[5], maps[6])
    k, kd = ("K3B", "K3Bd") if b else ("K3", "K3d")
    got = recon_cuda.recon_inter(cfg, tab, True, *src, *args)
    ref, p_ms = timed(inter.make_recon_inter_raw(cfg, tab, True, b), *src,
                      *args)
    names = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr",
             "mvx_fin", "mvy_fin"]
    err = _max_err(got, ref)
    _require_equal(k, tag, names, got, ref)
    dargs = (*args[:4], got[6].int(), got[7].int(), *args[6:])
    dec = recon_cuda.recon_inter(cfg, tab, False, *got[3:6], *dargs)
    pdec, pd_ms = timed(inter.make_recon_inter_raw(cfg, tab, False, b),
                        *got[3:6], *dargs)
    errd = max(_max_err(dec, pdec), _max_err(dec[:3], got[:3]))
    _require_equal(kd, tag, names, dec, pdec)
    _require_equal(kd, tag, names[:3], dec[:3], got[:3])
    if cfg.lossless:
        unit = (maps[2][0] == inter.PRED_SKIP).repeat_interleave(
            8, 0).repeat_interleave(8, 1)
        y = planes[0][0]
        if not torch.equal(got[0][0][~unit], y[~unit]):
            raise AssertionError(f"{k} {tag}: lossless recon differs from "
                                 "the source outside skip CUs")
    phase = "kernels-b-tools" if b else "kernels-p-tools"
    want = {"lossless": ("lossless_inter",), "mip": ("mip",),
            "pdpc": ("pdpc",), "transform_skip": ("ts",)}
    for flag, keys in want.items():
        if getattr(cfg, flag) and (flag != "transform_skip" or force):
            if not all(counts[key] for key in keys):
                raise AssertionError(f"[{phase}] {tag}: {flag} is on but "
                                     f"no CU takes its branch ({counts})")
    if force == "skip" and counts["lossless_skip"] == 0:
        raise AssertionError(f"[{phase}] {tag}: no lossless skip CU")
    k_ms = event_ms(recon_cuda.recon_inter, cfg, tab, True, *src, *args)
    kd_ms = event_ms(recon_cuda.recon_inter, cfg, tab, False, *got[3:6],
                     *dargs)
    kinds = np.bincount(maps[2].cpu().numpy().ravel(), minlength=5)
    log(f"[{phase}] {tag}: units by kind {kinds.tolist()}; tool CUs "
        f"{counts}; {k} {k_ms:.3f} ms (plain {p_ms:.0f} ms) err {err}; "
        f"{kd} {kd_ms:.3f} ms (plain {pd_ms:.0f} ms) err {errd}")
    _record(stats, k, err)
    _record(stats, kd, errd)
    if record is None:
        return
    hm = [m.cpu().numpy() for m in (*maps[:3], mts)]
    tabs = (tab.k_taps, tab.k_smooth, tab.k_tx, tab.k_shift, tab.k_mip)
    if b:
        reads = (read_union(p0, [(maps[0], maps[2], got[6], got[7],
                                  (1, 2, 4))])
                 + read_union(p1, [(maps[0], maps[2], got[6], got[7], (3,)),
                                   (maps[0], maps[2], maps[5], maps[6],
                                    (4,))]))
        extra = (maps[5], maps[6])
    else:
        reads = k3_read_bytes(p0, maps[0], maps[2], got[6], got[7])
        extra = ()
    be = bound(nbytes(*src, *args[:6], *extra, *got, *tabs, tab.rate)
               + reads, recon_ops(hm[0], True, hm[2], hm[1], hm[3], cfg))
    bd = bound(nbytes(*dargs[:6], *extra, *got[3:6], *dec[:3], *tabs)
               + reads, recon_ops(hm[0], False, hm[2], hm[1], hm[3], cfg))
    log(f"[{phase}] {tag}: bounds {k} {be[0]:.4f} ms ({be[1]}), {kd} "
        f"{bd[0]:.4f} ms ({bd[1]})")
    shape = f"{cfg.width}x{cfg.height}"
    walk = tu_walk(hm[0], cfg.width, cfg.height)
    log(f"[{phase}] {tag}: {chain_text(walk, **{k: k_ms, kd: kd_ms})}")
    for key, ms, pms, bb in ((k, k_ms, p_ms, be), (kd, kd_ms, pd_ms, bd)):
        stats[key].setdefault("tools", {})[record] = {
            "ms": ms, "plain_ms": pms, "bound_ms": bb[0],
            "bound_by": bb[1], "shape": shape, "tool_cus": counts,
            **per_chain(walk, ms)}


def phase_kernels_inter_tools(stats):
    """K3-P and K3-B with each intra tool at 416x240 (lossless with a
    forced skip CU, transform skip written on the intra CUs), then at
    the slice's 1080p shapes: K3-P under lossless_p's configuration and
    K3-B under tools_ra's, timed for the kernels line."""
    from x266_tpu_torch.config import CodecConfig

    for b in (False, True):
        for tool, kw in inter_tools().items():
            cfg = CodecConfig(width=416, height=240, qp=30, intra_period=8,
                              gop_size=4 if b else 1, **kw)
            force = {"lossless": "skip", "ts": "ts"}.get(tool)
            compare_inter_tool_kernels(f"{tool} 416x240", cfg, b, stats, 9,
                                       force)
    compare_inter_tool_kernels("lossless_p 1080p", lossless_p_cfg(), False,
                               stats, 9, record="lossless_p 1080p")
    compare_inter_tool_kernels("tools_ra 1080p", tools_ra_cfg(), True,
                               stats, 9, record="tools_ra 1080p")


# sign-data hiding and dependent quantization ([kernels-sdh-dq], [main-sdh],
# [main-dq], [main-p-dq], [main-ra-sdh-dq])
def cfg2s(w=1920, h=1080):
    """preset_cfg2s (screen content: transform skip, SDH, substitution)
    with config 2's segments and context inheritance."""
    from x266_tpu_torch.config import preset_cfg2s

    return preset_cfg2s(w, h).replace(rows_per_segment=1, ctx_inherit=True)


def cfg3dq(w=1920, h=1080):
    """Config 3 with dependent quantization (which needs the VVC
    profile)."""
    from x266_tpu_torch.config import Profile, preset_cfg3

    return preset_cfg3(w, h).replace(profile=Profile.VVC, dep_quant=True)


def _plain_quant_cpu(cfg, pic, enc_in, dec_in):
    """The plain encode and decode scans of one picture on the CPU (a
    worker's): pic "I" (make_recon_pass_raw), "P" or "B"
    (make_recon_inter_raw); ((encode outputs, decode outputs), ms of
    each)."""
    from x266_tpu_torch import tables
    from x266_tpu_torch.engine import inter, recon

    tab = tables.from_reference(cfg, "cpu")

    def plain(encode):
        if pic == "I":
            return recon.make_recon_pass_raw(cfg, tab, encode)
        return inter.make_recon_inter_raw(cfg, tab, encode, pic == "B")

    outs, ms = [], []
    for encode, inputs in ((True, enc_in), (False, dec_in)):
        t0 = time.perf_counter()
        out = plain(encode)(*(torch.from_numpy(x) for x in inputs))
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append([t.numpy() for t in out])
    return outs, ms


def _quant_inputs(cfg, pic, seed, kind):
    """(tab, encode inputs, decoder-side inputs but the levels, maps) of
    one picture on the card: an intra picture's padded planes and Pass-A
    maps, or a P or B picture's on b_references (+-40 noise) with its
    inter maps."""
    from x266_tpu_torch import tables
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import fused, inter

    if pic == "I":
        tab, src, maps = _inputs(cfg, 1, seed, kind)
        return tab, (*src, *maps), tuple(maps), maps
    tab = tables.from_reference(cfg, "cuda")
    planes = _upload(synthetic_clip(cfg.width, cfg.height, 1, kind,
                                    seed=seed))
    p0, p1 = b_references(planes, amp=40)
    src = fused._unpack_padded(cfg, *planes)
    if pic == "B":
        maps = inter.make_mode_decision_b_raw(cfg, tab)(src[0][0], p0[0],
                                                       p1[0])
    else:
        maps = inter.make_mode_decision_p_raw(cfg, tab)(src[0][0], p0[0])
    maps = [m[None].contiguous() for m in maps]
    args = (maps[0], maps[1], torch.zeros_like(maps[0]), *maps[2:5], *p0)
    if pic == "B":
        args += (*p1, maps[5], maps[6])
    return tab, (*src, *args), args, maps


def _run_quant(cfg, tab, pic, encode, *inputs):
    """K1/K2 (pic "I"), K3-P or K3-B on inputs, encode or decode."""
    from x266_tpu_torch.engine import recon_cuda

    if pic == "I":
        return recon_cuda.recon_intra(cfg, tab, encode, *inputs)
    return recon_cuda.recon_inter(cfg, tab, encode, *inputs)


def _dec_inputs(pic, got, args):
    """The decode call's inputs: the levels, then the maps (inter: the
    final MVs in place of the mv maps)."""
    if pic == "I":
        return (*got[3:6], *args)
    return (*got[3:6], *args[:4], got[6].int(), got[7].int(), *args[6:])


QUANT_KERNELS = {"I": ("K1", "K2"), "P": ("K3", "K3d"), "B": ("K3B", "K3Bd")}


def quant_bounds(cfg, tab, pic, src, args, got, dec, maps):
    """The bounds of one picture's encode and decode launch: the bytes
    (planes, maps, levels, recon and tables once; of the pyramids the
    MC blocks' samples, as [kernels-p-tools] counts them) and recon_ops
    with cfg's quantizers."""
    hm = [m.cpu().numpy() for m in maps]
    if pic == "I":
        pred, mts, maps_in, extra, reads = None, hm[2], args, (), 0
    else:
        pred, mts, maps_in = hm[2], np.zeros_like(hm[0]), args[:6]
        if pic == "P":
            extra = ()
            reads = k3_read_bytes(args[6:9], maps[0], maps[2], got[6],
                                  got[7])
        else:
            extra = (args[12], args[13])
            reads = (read_union(args[6:9], [(maps[0], maps[2], got[6], got[7],
                                             (1, 2, 4))])
                     + read_union(args[9:12], [
                         (maps[0], maps[2], got[6], got[7], (3,)),
                         (maps[0], maps[2], maps[5], maps[6], (4,))]))
    tabs = (tab.k_taps, tab.k_smooth, tab.k_tx, tab.k_shift, tab.k_mip,
            *((tab.k_lfnst,) if cfg.lfnst else ()))
    be = bound(nbytes(*src, *maps_in, *extra, *got, *tabs, tab.rate) + reads,
               recon_ops(hm[0], True, pred, hm[1], mts, cfg))
    bd = bound(nbytes(*maps_in, *extra, *got[3:6], *dec[:3], *tabs) + reads,
               recon_ops(hm[0], False, pred, hm[1], mts, cfg))
    return be, bd


def compare_quant_kernels(tag, cfg, pic, stats, seed=13, kind="mixed"):
    """K1/K2, K3-P or K3-B (encode and decode) under cfg's SDH or DQ on
    one picture, on the card; the plain scans of the same inputs run on
    the CPU in a worker process, whose check (bit for bit, before the
    kernels line) also records their times.  On an I or P picture the
    flag must change levels: the kernel without it gives others."""
    k, kd = QUANT_KERNELS[pic]
    tab, enc_in, args, maps = _quant_inputs(cfg, pic, seed, kind)
    got = _run_quant(cfg, tab, pic, True, *enc_in)
    dec_in = _dec_inputs(pic, got, args)
    dec = _run_quant(cfg, tab, pic, False, *dec_in)
    names = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr",
             "mvx_fin", "mvy_fin"]
    _require_equal(kd, tag + " (its own encode's recon)", names[:3],
                   dec[:3], got[:3])
    off = cfg.replace(sign_data_hiding=False, dep_quant=False)
    base = _run_quant(off, tab, pic, True, *enc_in)
    changed = sum(int((a != b).sum()) for a, b in zip(base[3:6], got[3:6]))
    if changed == 0 and pic != "B":
        raise AssertionError(f"[kernels-sdh-dq] {tag}: the flag changed no "
                             "level")
    k_ms = event_ms(_run_quant, cfg, tab, pic, True, *enc_in)
    kd_ms = event_ms(_run_quant, cfg, tab, pic, False, *dec_in)
    be, bd = quant_bounds(cfg, tab, pic, enc_in[:3], args, got, dec, maps)
    entry = {}
    for key, ms, b in ((k, k_ms, be), (kd, kd_ms, bd)):
        entry[key] = stats[key].setdefault("tools", {}).setdefault(tag, {})
        entry[key].update({"ms": ms, "bound_ms": b[0], "bound_by": b[1],
                           "shape": f"{cfg.width}x{cfg.height}"})
    got_h = [g.cpu() for g in got]
    dec_h = [d.cpu() for d in dec]

    def check(outs, ms):
        _require_equal(k, tag, names, got_h, [torch.from_numpy(r)
                                              for r in outs[0]])
        _require_equal(kd, tag, names, dec_h, [torch.from_numpy(r)
                                               for r in outs[1]])
        entry[k]["plain_ms_cpu"], entry[kd]["plain_ms_cpu"] = ms
        log(f"[kernels-sdh-dq] {tag}: {k} and {kd} equal the plain scans "
            f"(on the cpu in a worker: {ms[0]:.0f} / {ms[1]:.0f} ms); "
            "max_abs_err 0")

    on_cpu("kernels-sdh-dq", check, _plain_quant_cpu, cfg, pic,
           [t.cpu().numpy() for t in enc_in],
           [t.cpu().numpy() for t in dec_in])
    log(f"[kernels-sdh-dq] {tag}: {k} {k_ms:.3f} ms (bound {be[0]:.4f} ms, "
        f"{be[1]}), {kd} {kd_ms:.3f} ms (bound {bd[0]:.4f} ms, {bd[1]}); "
        f"{kd} equals {k}'s recon; {changed} levels differ from the "
        "kernel without the flag; the plain scans run on the cpu")


def time_quant_flags(tag, cfg, pic, stats, n=1, kind="mixed", seed=0):
    """One main-path shape's recon launches without the flags, with SDH
    and with DQ, on the same inputs and maps (Pass A does not read the
    flags), timed in turns (off, SDH, DQ, DQ, SDH, off)."""
    k, kd = QUANT_KERNELS[pic]
    if pic == "I":
        tab, src, maps = _inputs(cfg, n, seed, kind)
        enc_in, args = (*src, *maps), tuple(maps)
    else:
        tab, enc_in, args, maps = _quant_inputs(cfg, pic, 9, kind)
    cfgs = {"off": cfg.replace(sign_data_hiding=False, dep_quant=False),
            "sdh": cfg.replace(sign_data_hiding=True, dep_quant=False),
            "dq": cfg.replace(sign_data_hiding=False, dep_quant=True)}
    dec_in, bounds = {}, {}
    for name, c in cfgs.items():
        got = _run_quant(c, tab, pic, True, *enc_in)
        one = (got[3:6] if pic != "I" else
               [g[:1].contiguous() for g in got[3:6]])
        a1 = args if pic != "I" else [m[:1].contiguous() for m in args]
        dec_in[name] = _dec_inputs(pic, (*got[:3], *one, *got[6:]), a1)
        dec = _run_quant(c, tab, pic, False, *dec_in[name])
        # the decode's bound on its one frame
        m1 = maps if pic != "I" else [m[:1] for m in maps]
        got1 = got if pic != "I" else [g[:1] for g in got]
        bounds[name] = (
            quant_bounds(c, tab, pic, enc_in[:3], args, got, dec, maps)[0],
            quant_bounds(c, tab, pic, [t[:1] for t in enc_in[:3]], a1, got1,
                         dec, m1)[1])
    times = {key: {name: [] for name in cfgs} for key in (k, kd)}
    for name in ("off", "sdh", "dq", "dq", "sdh", "off"):
        c = cfgs[name]
        times[k][name].append(event_ms(_run_quant, c, tab, pic, True,
                                       *enc_in))
        times[kd][name].append(event_ms(_run_quant, c, tab, pic, False,
                                        *dec_in[name]))
    for i, key in enumerate((k, kd)):
        ms = {name: float(np.mean(v)) for name, v in times[key].items()}
        bd = {name: bounds[name][i] for name in cfgs}
        stats[key].setdefault("tools", {})[f"{tag} flags"] = {
            "ms_off": ms["off"], "ms_sdh": ms["sdh"], "ms_dq": ms["dq"],
            "bound_ms": {name: b[0] for name, b in bd.items()},
            "bound_by": {name: b[1] for name, b in bd.items()},
            "shape": f"{cfg.width}x{cfg.height}x{n if key == 'K1' else 1}"}
        log(f"[kernels-sdh-dq] {tag}: {key} off {ms['off']:.3f} ms, SDH "
            f"{ms['sdh']:.3f} ms, DQ {ms['dq']:.3f} ms (in turns); bounds "
            + ", ".join(f"{name} {b[0]:.4f} ms ({b[1]})"
                        for name, b in bd.items()))


def phase_kernels_sdh_dq(stats):
    """K1/K2, K3-P and K3-B with SDH and with DQ against the plain scans
    at 416x240 (SDH beside transform skip on 'text' as preset_cfg2s; DQ
    with RDOQ, and beside transform skip without it; the P and B pictures
    on noisy references); then each kernel's time without the flags,
    with SDH and with DQ at config 2's (K1 a batch of 4, K2 a frame),
    config 3's and config 4's 1080p shapes, on the VVC profile that DQ
    needs."""
    from x266_tpu_torch.config import Profile, preset_cfg2, preset_cfg3

    w, h = 416, 240
    vvc = dict(profile=Profile.VVC)
    for tag, cfg, pic, kind in (
            ("sdh I 416x240", cfg2s(w, h), "I", "text"),
            ("dq I 416x240", preset_cfg2(w, h).replace(dep_quant=True), "I",
             "mixed"),
            ("dq-ts I 416x240", preset_cfg2(w, h).replace(
                dep_quant=True, transform_skip=True, rdoq=False), "I",
             "text"),
            ("sdh P 416x240", preset_cfg3(w, h).replace(
                sign_data_hiding=True), "P", "motion"),
            ("dq P 416x240", cfg3dq(w, h), "P", "motion"),
            ("sdh B 416x240", cfg4(w, h).replace(sign_data_hiding=True),
             "B", "motion"),
            ("dq B 416x240", cfg4(w, h).replace(dep_quant=True, **vvc), "B",
             "motion")):
        compare_quant_kernels(tag, cfg, pic, stats, kind=kind)
    time_quant_flags("config2 1080p", main_cfg(), "I", stats, n=4)
    time_quant_flags("config3 1080p", cfg3().replace(**vvc), "P", stats,
                     kind="motion")
    time_quant_flags("config4 1080p", cfg4(1920, 1080).replace(**vvc), "B",
                     stats, kind="motion")


def phase_main_ra_sdh_dq(stats):
    """Config 4 at 416x240 with SDH, then with DQ, 17 frames of 'motion'
    (I, P, 15 B), against the recorded JAX references."""
    from x266_tpu_torch.config import Profile

    kernels = ("K1", "K2", "K3", "K3d", "K3B", "K3Bd", "K4", "K5")
    for name, file, cfg in (
            ("ra_sdh", "ra_sdh_416x240_ref.json",
             cfg4(416, 240).replace(sign_data_hiding=True)),
            ("ra_dq", "ra_dq_416x240_ref.json",
             cfg4(416, 240).replace(profile=Profile.VVC, dep_quant=True))):
        run_ra_ref(f"main-ra-sdh-dq {name}", name, file, cfg, "motion", stats,
                   kernels)


# MTT binary splits and LFNST on I pictures ([kernels-mtt-lfnst],
# [main-mtt], [main-mtt-lfnst])
def cfg2q(w=1920, h=1080):
    """preset_cfg2q (config 2 with MTT, SDH and substitution) with config
    2's segments and context inheritance."""
    from x266_tpu_torch.config import preset_cfg2q

    return preset_cfg2q(w, h).replace(rows_per_segment=1, ctx_inherit=True)


def cfg2ml(w=1920, h=1080):
    """Config 2 with MTT and LFNST: the ai_vvc_mtt_lfnst fixture's tools
    (VVC, MTS, substitution)."""
    from x266_tpu_torch.config import preset_cfg2

    return preset_cfg2(w, h).replace(rows_per_segment=1, ctx_inherit=True,
                                     mtt=True, lfnst=True)


def mtt_counts(cfg, maps) -> dict:
    """On Pass-A maps (size, mode, mts; each (F, H/8, W/8)): the BT-H and
    BT-V leaves of 16 and 32 (bits 4-5 of the mts map) and the luma TUs
    with LFNST kernel 1 and 2 (bits 6-7)."""
    sm, _, tm = (m.cpu().numpy() for m in maps)
    bt, lf = (tm >> 4) & 3, (tm >> 6) & 3
    out = {f"{name}{s}": int(((bt == b) & (sm == s)).sum()) // (s // 8) ** 2
           for b, name in ((1, "bt_h"), (2, "bt_v")) for s in (16, 32)}
    eff = tu_sizes(sm, tm, cfg) // 8
    uy, ux = np.mgrid[0:sm.shape[1], 0:sm.shape[2]]
    origin = ((ux % eff) == 0) & ((uy % eff) == 0)
    out.update({f"lfnst{k}": int(((lf == k) & origin).sum())
                for k in (1, 2)})
    return out


def check_mtt_counts(tag, cfg, counts):
    """A config with MTT must have BT-H and BT-V leaves, one with LFNST
    TUs of both kernels."""
    if cfg.mtt and not (counts["bt_h16"] + counts["bt_h32"]
                        and counts["bt_v16"] + counts["bt_v32"]):
        raise AssertionError(f"{tag}: MTT is on but a BT direction has no "
                             f"leaf: {counts}")
    if cfg.lfnst and not (counts["lfnst1"] and counts["lfnst2"]):
        raise AssertionError(f"{tag}: LFNST is on but a kernel has no TU: "
                             f"{counts}")


def compare_mtt_kernels(tag, cfg, stats, kind, seed):
    """K1 and K2 under cfg's MTT and LFNST on one picture (the port's
    Pass-A maps, whose BT leaves and LFNST TUs are counted), on the card;
    the plain scans of the same inputs run on the CPU in a worker
    process, whose check (bit for bit, before the kernels line) also
    records their times."""
    tab, enc_in, args, maps = _quant_inputs(cfg, "I", seed, kind)
    got = _run_quant(cfg, tab, "I", True, *enc_in)
    dec_in = _dec_inputs("I", got, args)
    dec = _run_quant(cfg, tab, "I", False, *dec_in)
    names = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr"]
    _require_equal("K2", tag + " (its own encode's recon)", names[:3],
                   dec[:3], got[:3])
    counts = mtt_counts(cfg, maps)
    check_mtt_counts(f"[kernels-mtt-lfnst] {tag}", cfg, counts)
    k_ms = event_ms(_run_quant, cfg, tab, "I", True, *enc_in)
    kd_ms = event_ms(_run_quant, cfg, tab, "I", False, *dec_in)
    be, bd = quant_bounds(cfg, tab, "I", enc_in[:3], args, got, dec, maps)
    hm = [m.cpu().numpy() for m in maps]
    walk = tu_walk(hm[0], cfg.width, cfg.height, hm[2], cfg)
    entry = {}
    for key, ms, b in (("K1", k_ms, be), ("K2", kd_ms, bd)):
        entry[key] = stats[key].setdefault("tools", {}).setdefault(tag, {})
        entry[key].update({"ms": ms, "bound_ms": b[0], "bound_by": b[1],
                           "shape": f"{cfg.width}x{cfg.height}",
                           "mtt_lfnst_tus": counts, **per_chain(walk, ms)})
    got_h = [g.cpu() for g in got]
    dec_h = [d.cpu() for d in dec]

    def check(outs, ms):
        _require_equal("K1", tag, names, got_h, [torch.from_numpy(r)
                                                 for r in outs[0]])
        _require_equal("K2", tag, names, dec_h, [torch.from_numpy(r)
                                                 for r in outs[1]])
        entry["K1"]["plain_ms_cpu"], entry["K2"]["plain_ms_cpu"] = ms
        log(f"[kernels-mtt-lfnst] {tag}: K1 and K2 equal the plain scans "
            f"(on the cpu in a worker: {ms[0]:.0f} / {ms[1]:.0f} ms); "
            "max_abs_err 0")

    on_cpu("kernels-mtt-lfnst", check, _plain_quant_cpu, cfg, "I",
           [t.cpu().numpy() for t in enc_in],
           [t.cpu().numpy() for t in dec_in])
    log(f"[kernels-mtt-lfnst] {tag}: K1 {k_ms:.3f} ms (bound {be[0]:.4f} "
        f"ms, {be[1]}), K2 {kd_ms:.3f} ms (bound {bd[0]:.4f} ms, {bd[1]}); "
        f"K2 equals K1's recon; BT leaves and LFNST TUs {counts}; the "
        f"plain scans run on the cpu; {chain_text(walk, K1=k_ms, K2=kd_ms)}")


def time_mtt_flags(stats, n=4):
    """K1 on config 2's 1080p batch of n frames and K2 on its frame 0,
    without the flags, with MTT and with MTT + LFNST, each on its own
    Pass-A maps of the same frames, timed in turns (off, MTT, MTT +
    LFNST, MTT + LFNST, MTT, off)."""
    cfgs = {"off": main_cfg(), "mtt": main_cfg().replace(mtt=True),
            "mtt_lfnst": main_cfg().replace(mtt=True, lfnst=True)}
    runs, bounds, counts = {}, {}, {}
    for name, c in cfgs.items():
        tab, src, maps = _inputs(c, n, 0, "mixed")
        enc_in = (*src, *maps)
        got = _run_quant(c, tab, "I", True, *enc_in)
        a1 = [m[:1].contiguous() for m in maps]
        dec_in = _dec_inputs("I", (*got[:3], *[g[:1].contiguous()
                                                for g in got[3:6]]), a1)
        dec = _run_quant(c, tab, "I", False, *dec_in)
        runs[name] = (c, tab, enc_in, dec_in)
        bounds[name] = (
            quant_bounds(c, tab, "I", src, maps, got, dec, maps)[0],
            quant_bounds(c, tab, "I", [t[:1] for t in src], a1,
                         [g[:1] for g in got], dec, a1)[1])
        counts[name] = mtt_counts(c, maps)
    times = {key: {name: [] for name in cfgs} for key in ("K1", "K2")}
    for name in ("off", "mtt", "mtt_lfnst", "mtt_lfnst", "mtt", "off"):
        c, tab, enc_in, dec_in = runs[name]
        times["K1"][name].append(event_ms(_run_quant, c, tab, "I", True,
                                          *enc_in))
        times["K2"][name].append(event_ms(_run_quant, c, tab, "I", False,
                                          *dec_in))
    for i, key in enumerate(("K1", "K2")):
        ms = {name: float(np.mean(v)) for name, v in times[key].items()}
        bd = {name: bounds[name][i] for name in cfgs}
        stats[key].setdefault("tools", {})["config2 1080p mtt flags"] = {
            **{f"ms_{name}": v for name, v in ms.items()},
            "bound_ms": {name: b[0] for name, b in bd.items()},
            "bound_by": {name: b[1] for name, b in bd.items()},
            "mtt_lfnst_tus": counts,
            "shape": f"1920x1080x{n if key == 'K1' else 1}"}
        log(f"[kernels-mtt-lfnst] config2 1080p: {key} off "
            f"{ms['off']:.3f} ms, MTT {ms['mtt']:.3f} ms, MTT + LFNST "
            f"{ms['mtt_lfnst']:.3f} ms (in turns); bounds "
            + ", ".join(f"{name} {b[0]:.4f} ms ({b[1]})"
                        for name, b in bd.items())
            + f"; BT leaves and LFNST TUs {counts}")


def phase_kernels_mtt_lfnst(stats):
    """K1/K2 with MTT, with LFNST, with both, and in the SDH and DQ
    instances with them (the quality preset's MTT + SDH; MTT + LFNST
    under DQ) against the plain scans at 416x240; then K1 and K2 at
    config 2's 1080p shapes without the flags, with MTT and with MTT +
    LFNST, in turns."""
    from x266_tpu_torch.config import preset_cfg2

    w, h = 416, 240
    for tag, cfg, kind in (
            ("mtt I 416x240", preset_cfg2(w, h).replace(mtt=True), "text"),
            ("lfnst I 416x240", preset_cfg2(w, h).replace(lfnst=True),
             "mixed"),
            ("mtt-lfnst I 416x240", cfg2ml(w, h), "text"),
            ("mtt-sdh I 416x240", cfg2q(w, h), "text"),
            ("mtt-lfnst-dq I 416x240", cfg2ml(w, h).replace(dep_quant=True),
             "mixed")):
        compare_mtt_kernels(tag, cfg, stats, kind, seed=13)
    time_mtt_flags(stats)


def run_main_mtt(tag, cfg, ref_name, stats, card):
    """run_main on frames 0-3 of 'mixed' at 1080p under cfg's MTT (and
    LFNST), then the BT leaves and LFNST TUs of those frames' Pass-A
    maps."""
    run_main(tag, cfg, "mixed", ref_name, ("K1", "K2"), stats, card,
             tools=True, batch_frames=4)
    counts = mtt_counts(cfg, _inputs(cfg, 4, 0, "mixed")[2])
    check_mtt_counts(f"[{tag}]", cfg, counts)
    log(f"[{tag}] BT leaves and LFNST TUs of frames 0-3: {counts}")
    stats["K1"].setdefault("tools", {})[tag] = {"mtt_lfnst_tus": counts}


def cfg2c():
    """Config 2 (1080p, its segments) with CCLM."""
    return main_cfg().replace(cclm=True)


def _cclm_inputs(cfg, n, seed, kind):
    """Padded planes and Pass-A maps of n synthetic frames whose chroma
    is made from the luma (luma_chroma), on the card."""
    from x266_tpu_torch import tables
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import fused
    from x266_tpu_torch.utils.clips import luma_chroma

    tab = tables.from_reference(cfg, "cuda")
    frames = luma_chroma(synthetic_clip(cfg.width, cfg.height, n, kind,
                                        seed=seed))
    src = fused._unpack_padded(cfg, *_upload(frames))
    return tab, src, fused.make_pass_a(cfg, tab)(src[0])


def cclm_counts(size_map, mts_out) -> dict:
    """The CUs of each size whose chroma takes CCLM and those that take
    DM, from K1's mts map out (bit 3) at the CUs' origins."""
    sm, mm = size_map.cpu().numpy(), mts_out.cpu().numpy()
    uy, ux = np.mgrid[0:sm.shape[1], 0:sm.shape[2]]
    u = sm // 8
    origin = ((ux % u) == 0) & ((uy % u) == 0)
    cc = (mm >> 3) & 1
    out = {}
    for s in (8, 16, 32):
        at = origin & (sm == s)
        out[f"cclm{s}"] = int((at & (cc == 1)).sum())
        out[f"dm{s}"] = int((at & (cc == 0)).sum())
    return out


def check_cclm_counts(tag, counts):
    """Both choices must occur."""
    if not (sum(v for k, v in counts.items() if k.startswith("cclm"))
            and sum(v for k, v in counts.items() if k.startswith("dm"))):
        raise AssertionError(f"{tag}: CCLM or DM was never chosen: {counts}")


def cclm_bounds(cfg, tab, src, maps, got, dec):
    """The bounds of one CCLM encode launch (planes, maps, levels, recon,
    the mts map out and the tables once; recon_ops with the CCLM model
    on every CU) and of its decode (the model where bit 3 of K1's map is
    set)."""
    hm = [m.cpu().numpy() for m in maps]
    out = got[6].cpu().numpy()
    tabs = (tab.k_taps, tab.k_smooth, tab.k_tx, tab.k_shift, tab.k_mip,
            *((tab.k_lfnst,) if cfg.lfnst else ()))
    be = bound(nbytes(*src, *maps, *got, *tabs, tab.rate),
               recon_ops(hm[0], True, None, hm[1], hm[2] | (out & 8), cfg))
    bd = bound(nbytes(maps[0], maps[1], got[6], *got[3:6], *dec[:3], *tabs),
               recon_ops(hm[0], False, None, hm[1], out, cfg))
    return be, bd


def compare_cclm_kernels(tag, cfg, stats, kind, seed):
    """K1 and K2's CCLM instances on one picture whose chroma is made
    from the luma (the port's Pass-A maps), on the card: K2 on K1's
    levels and mts map out gives K1's recon (under LFNST, whose index
    that map does not keep, as the reference's, only the plain decode's);
    the CUs taking each choice are counted (one never taken fails); the
    plain scans of the same inputs run on the CPU in a worker process,
    whose check (bit for bit, K1's map included, before the kernels
    line) also records their times."""
    tab, src, maps = _cclm_inputs(cfg, 1, seed, kind)
    enc_in = (*src, *maps)
    got = _run_quant(cfg, tab, "I", True, *enc_in)
    dec_in = (*got[3:6], maps[0], maps[1], got[6])
    dec = _run_quant(cfg, tab, "I", False, *dec_in)
    names = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr",
             "mts_out"]
    if not cfg.lfnst:
        _require_equal("K2", tag + " (its own encode's recon)", names[:3],
                       dec[:3], got[:3])
    counts = cclm_counts(maps[0], got[6])
    check_cclm_counts(f"[kernels-cclm] {tag}", counts)
    k_ms = event_ms(_run_quant, cfg, tab, "I", True, *enc_in)
    kd_ms = event_ms(_run_quant, cfg, tab, "I", False, *dec_in)
    be, bd = cclm_bounds(cfg, tab, src, maps, got, dec)
    hm = [m.cpu().numpy() for m in maps]
    walk = tu_walk(hm[0], cfg.width, cfg.height)
    entry = {}
    for key, ms, b in (("K1", k_ms, be), ("K2", kd_ms, bd)):
        entry[key] = stats[key].setdefault("tools", {}).setdefault(tag, {})
        entry[key].update({"ms": ms, "bound_ms": b[0], "bound_by": b[1],
                           "shape": f"{cfg.width}x{cfg.height}",
                           "cclm_cus": counts, **per_chain(walk, ms)})
    got_h = [g.cpu() for g in got]
    dec_h = [d.cpu() for d in dec]

    def check(outs, ms):
        _require_equal("K1", tag, names, got_h, [torch.from_numpy(r)
                                                 for r in outs[0]])
        _require_equal("K2", tag, names, dec_h, [torch.from_numpy(r)
                                                 for r in outs[1]])
        entry["K1"]["plain_ms_cpu"], entry["K2"]["plain_ms_cpu"] = ms
        log(f"[kernels-cclm] {tag}: K1 (with its mts map) and K2 equal the "
            f"plain scans (on the cpu in a worker: {ms[0]:.0f} / "
            f"{ms[1]:.0f} ms); max_abs_err 0")

    on_cpu("kernels-cclm", check, _plain_quant_cpu, cfg, "I",
           [t.cpu().numpy() for t in enc_in],
           [t.cpu().numpy() for t in dec_in])
    log(f"[kernels-cclm] {tag}: K1 {k_ms:.3f} ms (bound {be[0]:.4f} ms, "
        f"{be[1]}), K2 {kd_ms:.3f} ms (bound {bd[0]:.4f} ms, {bd[1]}); "
        f"CUs by choice {counts}; the plain scans run on the cpu; "
        f"{chain_text(walk, K1=k_ms, K2=kd_ms)}")


def time_cclm_flags(stats, n=4):
    """K1 on config 2's 1080p batch of n frames whose chroma is made from
    the luma, and K2 on its frame 0, without and with CCLM, on the same
    Pass-A maps (Pass A does not read the flag), timed in turns (off,
    CCLM, CCLM, off), each beside its bound."""
    cfgs = {"off": main_cfg(), "cclm": cfg2c()}
    tab, src, maps = _cclm_inputs(cfgs["off"], n, 0, "mixed")
    a1 = [m[:1].contiguous() for m in maps]
    runs, bounds, counts = {}, {}, {}
    for name, c in cfgs.items():
        got = _run_quant(c, tab, "I", True, *src, *maps)
        lev1 = [g[:1].contiguous() for g in got[3:6]]
        if c.cclm:
            dec_in = (*lev1, a1[0], a1[1], got[6][:1].contiguous())
            be, _ = cclm_bounds(c, tab, src, maps, got, got)
            dec = _run_quant(c, tab, "I", False, *dec_in)
            _, bd = cclm_bounds(c, tab, [t[:1] for t in src], a1,
                                [g[:1] for g in got], dec)
            counts = cclm_counts(maps[0], got[6])
        else:
            dec_in = (*lev1, *a1)
            dec = _run_quant(c, tab, "I", False, *dec_in)
            be = quant_bounds(c, tab, "I", src, maps, got, dec, maps)[0]
            bd = quant_bounds(c, tab, "I", [t[:1] for t in src], a1,
                              [g[:1] for g in got], dec, a1)[1]
        runs[name] = (c, (*src, *maps), dec_in)
        bounds[name] = (be, bd)
    check_cclm_counts("[kernels-cclm] config2 1080p", counts)
    times = {key: {name: [] for name in cfgs} for key in ("K1", "K2")}
    for name in ("off", "cclm", "cclm", "off"):
        c, enc_in, dec_in = runs[name]
        times["K1"][name].append(event_ms(_run_quant, c, tab, "I", True,
                                          *enc_in))
        times["K2"][name].append(event_ms(_run_quant, c, tab, "I", False,
                                          *dec_in))
    for i, key in enumerate(("K1", "K2")):
        ms = {name: float(np.mean(v)) for name, v in times[key].items()}
        bd = {name: bounds[name][i] for name in cfgs}
        stats[key].setdefault("tools", {})["config2 1080p cclm"] = {
            **{f"ms_{name}": v for name, v in ms.items()},
            "bound_ms": {name: b[0] for name, b in bd.items()},
            "bound_by": {name: b[1] for name, b in bd.items()},
            "cclm_cus": counts,
            "shape": f"1920x1080x{n if key == 'K1' else 1}"}
        log(f"[kernels-cclm] config2 1080p: {key} off {ms['off']:.3f} ms, "
            f"CCLM {ms['cclm']:.3f} ms (in turns); bounds "
            + ", ".join(f"{name} {b[0]:.4f} ms ({b[1]})"
                        for name, b in bd.items())
            + f"; CUs by choice {counts}")


def phase_kernels_cclm(stats):
    """K1/K2's CCLM instances against the plain scans at 416x240: CCLM
    alone; with MTS, transform skip, PDPC, MIP and substitution; with
    LFNST and DQ; with SDH beside transform skip; lossless; then K1 and
    K2 at config 2's 1080p shapes without and with CCLM, in turns."""
    from x266_tpu_torch.config import CodecConfig, Profile, preset_cfg2

    w, h = 416, 240
    for tag, cfg, kind in (
            ("cclm I 416x240", preset_cfg2(w, h).replace(cclm=True),
             "mixed"),
            ("cclm-tools I 416x240", preset_cfg2(w, h).replace(
                cclm=True, pdpc=True, mip=True, transform_skip=True),
             "text"),
            ("cclm-lfnst-dq I 416x240", preset_cfg2(w, h).replace(
                cclm=True, lfnst=True, dep_quant=True), "mixed"),
            ("cclm-sdh I 416x240", preset_cfg2(w, h).replace(
                cclm=True, sign_data_hiding=True, transform_skip=True),
             "text"),
            ("cclm-lossless I 416x240", CodecConfig(
                width=w, height=h, qp=32, profile=Profile.VVC,
                lossless=True, rdoq=False, cclm=True), "mixed")):
        compare_cclm_kernels(tag, cfg, stats, kind, seed=13)
    time_cclm_flags(stats)


def run_main_cclm(stats, card):
    """run_main on frames 0-3 of 'mixed' with chroma made from the luma
    under config 2 + CCLM, against data/cfg2c_1080p_ref.json; then the
    CUs of each size taking each choice on those frames (K1 on their
    Pass-A maps)."""
    tag = "main-cclm"
    cfg = cfg2c()
    run_main(tag, cfg, "mixed", "cfg2c_1080p_ref.json", ("K1", "K2"), stats,
             card, tools=True, batch_frames=4, lc=True)
    from x266_tpu_torch.engine import recon_cuda

    tab, src, maps = _cclm_inputs(cfg, 4, 0, "mixed")
    counts = cclm_counts(maps[0], recon_cuda.recon_intra(
        cfg, tab, True, *src, *maps)[6])
    check_cclm_counts(f"[{tag}]", counts)
    log(f"[{tag}] CUs by chroma choice in frames 0-3: {counts}")
    stats["K1"].setdefault("tools", {})[tag] = {"cclm_cus": counts}


def cfg2cu64():
    """Config 2 (1080p, its segments) with 64x64 CUs."""
    return main_cfg().replace(max_cu_size=64)


def _cu64_inputs(cfg, n, seed, kind):
    """Padded planes and Pass-A maps of n frames on the card: kind
    "blocks", smooth directional blocks (utils.clips.smooth_blocks over
    'mixed', on which 64 CUs win) with chroma made from the luma; else
    the synthetic clip of that kind."""
    from x266_tpu_torch import tables
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import fused
    from x266_tpu_torch.utils.clips import luma_chroma, smooth_blocks

    tab = tables.from_reference(cfg, "cuda")
    frames = synthetic_clip(cfg.width, cfg.height, n,
                            "mixed" if kind == "blocks" else kind, seed=seed)
    if kind == "blocks":
        frames = luma_chroma(smooth_blocks(frames, seed))
    src = fused._unpack_padded(cfg, *_upload(frames))
    return tab, src, fused.make_pass_a(cfg, tab)(src[0])


def cu_counts(size_map) -> dict:
    """The CUs of each size (64 included) at their origins."""
    sm = size_map.cpu().numpy()
    uy, ux = np.mgrid[0:sm.shape[1], 0:sm.shape[2]]
    u = sm // 8
    origin = ((ux % u) == 0) & ((uy % u) == 0)
    return {f"cu{s}": int((origin & (sm == s)).sum())
            for s in (8, 16, 32, 64)}


def cu64_bounds(cfg, tab, src, maps, got, dec, one):
    """The bounds of a CU-64 encode launch and of the decode of its first
    `one` frames (cclm_bounds under CCLM, else quant_bounds)."""
    part = [m[:one] for m in maps]
    if cfg.cclm:
        return (cclm_bounds(cfg, tab, src, maps, got, got)[0],
                cclm_bounds(cfg, tab, [t[:one] for t in src], part,
                            [g[:one] for g in got], dec)[1])
    return (quant_bounds(cfg, tab, "I", src, maps, got, dec, maps)[0],
            quant_bounds(cfg, tab, "I", [t[:one] for t in src], part,
                         [g[:one] for g in got], dec, part)[1])


def compare_cu64_kernels(tag, cfg, stats, seed):
    """K1 and K2's CU-64 instances on one picture of smooth directional
    blocks (the port's Pass-A maps), on the card: K2 on K1's levels (and
    under CCLM its mts map out) gives K1's recon (under LFNST only the
    plain decode's: the map keeps no LFNST index); the CUs of each size
    are counted (no 64 CU fails); the plain scans of the same inputs run
    on the CPU in a worker process, whose check (bit for bit, before the
    kernels line) also records their times."""
    tab, src, maps = _cu64_inputs(cfg, 1, seed, "blocks")
    enc_in = (*src, *maps)
    got = _run_quant(cfg, tab, "I", True, *enc_in)
    dec_in = (*got[3:6], maps[0], maps[1], got[6] if cfg.cclm else maps[2])
    dec = _run_quant(cfg, tab, "I", False, *dec_in)
    names = ["reconY", "reconCb", "reconCr", "coefY", "coefCb", "coefCr",
             "mts_out"]
    if not cfg.lfnst:
        _require_equal("K2", tag + " (its own encode's recon)", names[:3],
                       dec[:3], got[:3])
    counts = cu_counts(maps[0])
    if not counts["cu64"]:
        raise AssertionError(f"[kernels-cu64] {tag}: no 64 CU: {counts}")
    k_ms = event_ms(_run_quant, cfg, tab, "I", True, *enc_in)
    kd_ms = event_ms(_run_quant, cfg, tab, "I", False, *dec_in)
    be, bd = cu64_bounds(cfg, tab, src, maps, got, dec, 1)
    walk = tu_walk(maps[0].cpu().numpy(), cfg.width, cfg.height)
    entry = {}
    for key, ms, b in (("K1", k_ms, be), ("K2", kd_ms, bd)):
        entry[key] = stats[key].setdefault("tools", {}).setdefault(tag, {})
        entry[key].update({"ms": ms, "bound_ms": b[0], "bound_by": b[1],
                           "shape": f"{cfg.width}x{cfg.height}",
                           "cus": counts, **per_chain(walk, ms)})
    got_h = [g.cpu() for g in got]
    dec_h = [d.cpu() for d in dec]

    def check(outs, ms):
        _require_equal("K1", tag, names, got_h, [torch.from_numpy(r)
                                                 for r in outs[0]])
        _require_equal("K2", tag, names, dec_h, [torch.from_numpy(r)
                                                 for r in outs[1]])
        entry["K1"]["plain_ms_cpu"], entry["K2"]["plain_ms_cpu"] = ms
        log(f"[kernels-cu64] {tag}: K1 and K2 equal the plain scans (on "
            f"the cpu in a worker: {ms[0]:.0f} / {ms[1]:.0f} ms); "
            f"max_abs_err 0")

    on_cpu("kernels-cu64", check, _plain_quant_cpu, cfg, "I",
           [t.cpu().numpy() for t in enc_in],
           [t.cpu().numpy() for t in dec_in])
    log(f"[kernels-cu64] {tag}: K1 {k_ms:.3f} ms (bound {be[0]:.4f} ms, "
        f"{be[1]}), K2 {kd_ms:.3f} ms (bound {bd[0]:.4f} ms, {bd[1]}); "
        f"CUs by size {counts}; the plain scans run on the cpu; "
        f"{chain_text(walk, K1=k_ms, K2=kd_ms)}")


def time_cu64(stats, n=4):
    """K1 on config 2's 1080p batch of n frames of 'mixed' and K2 on its
    frame 0, at CU 32, at CU 64 and at CU 64 with LFNST and with CCLM
    (each on its own Pass-A maps), timed in turns (forth and back), each
    beside its bound; at CU 64 K1's frame 0 recon is held to
    data/cfg2cu64_1080p_ref.json's (config 2 has no loop filter), and
    everywhere K2 on frame 0's levels and maps (under CCLM K1's mts map
    out) to K1's recon."""
    from x266_tpu_torch.core.hashing import frame_md5
    from x266_tpu_torch.core.yuv import Frame

    cfgs = {"cu32": main_cfg(), "cu64": cfg2cu64(),
            "cu64-lfnst": cfg2cu64().replace(lfnst=True),
            "cu64-cclm": cfg2cu64().replace(cclm=True)}
    runs, bounds, counts, walks = {}, {}, {}, {}
    for name, c in cfgs.items():
        tab, src, maps = _cu64_inputs(c, n, 0, "mixed")
        got = _run_quant(c, tab, "I", True, *src, *maps)
        one = [t[:1].contiguous() for t in (
            *got[3:6], maps[0], maps[1], got[6] if c.cclm else maps[2])]
        dec = _run_quant(c, tab, "I", False, *one)
        _require_equal("K2", f"config2 1080p {name}",
                       ("reconY", "reconCb", "reconCr"), dec[:3],
                       [g[:1] for g in got[:3]])
        runs[name] = (c, tab, (*src, *maps), one)
        bounds[name] = cu64_bounds(c, tab, src, maps, got, dec, 1)
        counts[name] = cu_counts(maps[0])
        walks[name] = tu_walk(maps[0].cpu().numpy(), c.width, c.height)
        if name == "cu64":
            with open(os.path.join(DATA, "cfg2cu64_1080p_ref.json")) as f:
                want = json.load(f)["frames"][0]["recon_md5"]
            rec = Frame(*(g[0].cpu().numpy() for g in got[:3]))
            if frame_md5(rec) != want or not counts[name]["cu64"]:
                raise AssertionError(
                    "[kernels-cu64] config2 1080p: K1's frame 0 differs "
                    f"from the reference's recon, or no 64 CU: "
                    f"{counts[name]}")
    times = {key: {name: [] for name in cfgs} for key in ("K1", "K2")}
    for name in (*cfgs, *reversed(cfgs)):
        c, tab, enc_in, dec_in = runs[name]
        times["K1"][name].append(event_ms(_run_quant, c, tab, "I", True,
                                          *enc_in))
        times["K2"][name].append(event_ms(_run_quant, c, tab, "I", False,
                                          *dec_in))
    for i, key in enumerate(("K1", "K2")):
        ms = {name: float(np.mean(v)) for name, v in times[key].items()}
        bd = {name: bounds[name][i] for name in cfgs}
        stats[key].setdefault("tools", {})["config2 1080p cu64"] = {
            **{f"ms_{name}": v for name, v in ms.items()},
            "bound_ms": {name: b[0] for name, b in bd.items()},
            "bound_by": {name: b[1] for name, b in bd.items()},
            "cus": counts,
            "tus_by_size_map": {name: w["tus_by_size_map"]
                                for name, w in walks.items()},
            "shape": f"1920x1080x{n if key == 'K1' else 1}"}
        log(f"[kernels-cu64] config2 1080p: {key} "
            + ", ".join(f"{name} {v:.3f} ms" for name, v in ms.items())
            + " (in turns); bounds "
            + ", ".join(f"{name} {b[0]:.4f} ms ({b[1]})"
                        for name, b in bd.items())
            + f"; CUs by size {counts}")
    tus = {k: w["tus_by_size_map"]["Y"] for k, w in walks.items()}
    log("[kernels-cu64] config2 1080p: K1's frame 0 at CU 64 equals the "
        "reference's recon, K2 K1's recon; luma TUs by size of the batch "
        f"{tus}")


def phase_kernels_cu64(stats):
    """K1/K2's CU-64 instances against the plain scans at 416x240: CU 64
    alone, with CCLM, with LFNST; then K1 and K2 at config 2's 1080p
    shapes at CU 32, CU 64, CU 64 + LFNST and CU 64 + CCLM, in turns."""
    from x266_tpu_torch.config import preset_cfg2

    base = preset_cfg2(416, 240).replace(max_cu_size=64)
    for tag, cfg in (("cu64 I 416x240", base),
                     ("cu64-cclm I 416x240", base.replace(cclm=True)),
                     ("cu64-lfnst I 416x240", base.replace(lfnst=True))):
        compare_cu64_kernels(tag, cfg, stats, seed=13)
    time_cu64(stats)


def run_main_cu64(stats, card):
    """run_main on frames 0-3 of 'mixed' under config 2 + CU 64, against
    data/cfg2cu64_1080p_ref.json; then the CUs of each size on those
    frames (their Pass-A maps; no 64 CU fails)."""
    tag = "main-cu64"
    cfg = cfg2cu64()
    run_main(tag, cfg, "mixed", "cfg2cu64_1080p_ref.json", ("K1", "K2"),
             stats, card, tools=True, batch_frames=4)
    counts = cu_counts(_cu64_inputs(cfg, 4, 0, "mixed")[2][0])
    if not counts["cu64"]:
        raise AssertionError(f"[{tag}] no 64 CU in frames 0-3: {counts}")
    log(f"[{tag}] CUs by size in frames 0-3: {counts}")
    stats["K1"].setdefault("tools", {})[tag] = {"cus": counts}


def phase_cli(stats, card):
    """The command line on the card, as a user runs it: ``python3 -m
    x266_tpu_torch.cli encode`` of a 416x240 raw clip with CCLM (chroma
    made from the luma; low-delay, IDR then P pictures, deblock and SAO)
    and ``decode`` of its stream, each a subprocess; the stream equals
    data/cli416x240_ref.json's (the JAX package's CLI on the same file
    and flags), the decoded MD5 lines equal the reference's, and they
    are the MD5s of the recon of Encoder() on the CLI's configuration,
    whose stream is the CLI's."""
    import tempfile

    from x266_tpu_torch.api import Encoder
    from x266_tpu_torch.cli.main import encode_config, parser
    from x266_tpu_torch.core.hashing import frame_md5
    from x266_tpu_torch.core.yuv import synthetic_clip, write_yuv420
    from x266_tpu_torch.utils.clips import luma_chroma

    with open(os.path.join(DATA, "cli416x240_ref.json")) as f:
        ref = json.load(f)
    frames = luma_chroma(synthetic_clip(416, 240, 4, "mixed", seed=7))
    clip = "luma_chroma(synthetic_clip(416, 240, 4, 'mixed', seed=7))"
    if ref["clip"] != clip:
        raise AssertionError(f"[cli] the reference's clip is {ref['clip']}")
    with tempfile.TemporaryDirectory() as tmp:
        yuv, bit = os.path.join(tmp, "in.yuv"), os.path.join(tmp, "out.266t")
        write_yuv420(yuv, frames)
        cli = [sys.executable, "-m", "x266_tpu_torch.cli"]
        outs = {}
        for name, argv in (
                ("encode", ["encode", "-i", yuv, "-o", bit, *ref["flags"],
                            "--device", "cuda"]),
                ("decode", ["decode", "-i", bit, "-o",
                            os.path.join(tmp, "dec.yuv")])):
            t0 = time.perf_counter()
            proc = subprocess.run(cli + argv, cwd=ROOT, capture_output=True,
                                  text=True, timeout=300)
            ms = (time.perf_counter() - t0) * 1e3
            if proc.returncode != 0:
                raise AssertionError(f"[cli] {name} exited {proc.returncode}:"
                                     f" {proc.stderr[-2000:]}")
            outs[name] = proc.stdout.splitlines()
            log(f"[cli] {name}: {ms:.0f} ms as a process; "
                + " | ".join(outs[name]))
        with open(bit, "rb") as f:
            stream = f.read()
    md5 = hashlib.md5(stream).hexdigest()
    if md5 != ref["stream_md5"]:
        raise AssertionError(f"[cli] stream md5 {md5} != the reference's "
                             f"{ref['stream_md5']}")
    lines = [ln for ln in outs["decode"] if ln.startswith("POC")]
    if lines != ref["decode_lines"]:
        raise AssertionError(f"[cli] decode printed {lines}, the reference "
                             f"{ref['decode_lines']}")
    cfg = encode_config(parser().parse_args(["encode", "-i", "x", "-o", "y",
                                             *ref["flags"]]), 416, 240)
    res = Encoder(cfg).encode(frames)
    rec = [f"POC {i:4d}  md5 {frame_md5(r)}" for i, r in
           enumerate(res.recon)]
    if res.bitstream != stream or rec != lines:
        raise AssertionError("[cli] Encoder() on the CLI's configuration "
                             "gives another stream or recon")
    log(f"[cli] stream {len(stream)} bytes, md5 {md5} == the JAX CLI's; the "
        f"decoded MD5s equal the reference's and the encoder's recon on "
        f"{card}")


def _encoder_planes(w, h):
    """The (orig, recon, lam) luma and chroma planes the encoder's ALF
    estimators get for the IDR of config 4's clip at w x h (its post-SAO
    recon and the source)."""
    from x266_tpu_torch.api import Encoder
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.kernels import alf as kalf

    got = {}
    est = {"luma": kalf.estimate_alf, "chroma": kalf.estimate_alf_chroma}

    def grab(plane):
        def f(orig, recon, lam, *a):
            got.setdefault(plane, (orig.clone(), recon.clone(), lam))
            return est[plane](orig, recon, lam, *a)
        return f

    kalf.estimate_alf, kalf.estimate_alf_chroma = grab("luma"), grab("chroma")
    try:
        Encoder(cfg4(w, h)).encode(synthetic_clip(w, h, 1, "mixed"))
    finally:
        kalf.estimate_alf, kalf.estimate_alf_chroma = (est["luma"],
                                                       est["chroma"])
    return got


def _alf_data(w, h, seed):
    """Per data set and plane, (orig, recon, lam) int32 on the card:
    "noise", a picture's source and a recon of +-255 noise around it
    (features near +-510, errors near +-255: few chains exact); "encoder",
    the planes the encoder's estimators get (nearly every chain exact);
    "crossing", the encoder's planes on the top 45 % of the rows and below
    the source against a recon of 0s and 255s, so that chains (and the
    CTB decision's windows) cross 2^24 partway."""
    from x266_tpu_torch.core.yuv import synthetic_frame

    f = synthetic_frame(w, h, 0, "mixed", seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    enc = _encoder_planes(w, h)
    data = {"noise": {}, "encoder": {}, "crossing": {}}
    for plane, src in (("luma", f.y), ("chroma", f.cb)):
        o = torch.from_numpy(src).cuda().int()
        noise = torch.randint(-255, 256, o.shape, generator=gen,
                              device="cuda", dtype=torch.int32)
        data["noise"][plane] = (o, (o + noise).clamp(0, 255), 100.0)
        eo, er, lam = (x.int() if torch.is_tensor(x) else float(x)
                       for x in enc[plane])
        data["encoder"][plane] = (eo, er, lam)
        low = torch.arange(o.shape[0], device="cuda")[:, None] >= int(
            o.shape[0] * 0.45)
        extreme = torch.where(torch.rand(o.shape, generator=gen,
                                         device="cuda") < 0.5, 0, 255)
        data["crossing"][plane] = (
            torch.where(low, o, eo),
            torch.where(low, extreme, er).to(torch.int32), lam)
    return data


ALF_SHARES = {"exact": 0, "ordered": 0}


def alf_nl_check(tag, what, got):
    """The check of a chroma-sized normal-equations kernel result (got:
    nonlinear chroma or CC-ALF) against the plain version's from a
    worker."""
    got = [g.cpu() for g in got]

    def check(want, ms):
        _require_equal("ALF", tag, ("coef", "gram", "rhs"), got,
                       [torch.from_numpy(x) for x in want])
        log(f"[kernels-alf] {tag} {what}: ALF == plain (on the cpu, in a "
            f"worker process, plain {ms:.0f} ms)")
    return check


@functools.cache
def add_cycles() -> float:
    """The cycles of a dependent float32 add on the card, for the ordered
    chains' dependent-add floors: a chain of 4,096 adds on one thread
    (tools/add_latency.cu, clock64 around it), measured once."""
    import ctypes

    from x266_tpu_torch import _build

    def declare(lib):
        p = ctypes.c_void_p
        lib.x266_add_latency.argtypes = [ctypes.c_int, p, p, p, p]
        lib.x266_add_latency.restype = ctypes.c_int
        return lib

    lib = _build.Library([os.path.join(ROOT, "tools", "add_latency.cu")],
                         (), "tools-", declare).build()
    n = 4096
    ab = torch.tensor([1.0, 0.5], device="cuda")
    out = torch.empty(1, device="cuda")
    cycles = torch.empty(1, dtype=torch.int64, device="cuda")
    for _ in range(2):              # the first call loads the module
        err = lib.x266_add_latency(n, ab.data_ptr(), out.data_ptr(),
                                   cycles.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"add_latency launch failed ({err})")
    return int(cycles) / n


@functools.cache
def sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm, MHz)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def add_floor(adds: int) -> dict:
    """A chain of dependent adds at add_cycles() each: cycles and ms at
    the card's highest SM clock."""
    cycles = adds * add_cycles()
    return {"adds": adds, "cycles_per_add": add_cycles(), "cycles": cycles,
            "ms": cycles / (sm_clock_mhz() * 1e3)}


def gate_adds(cy: int, cx: int) -> int:
    """The dependent adds of CC-ALF's gate on a cy x cx CTB grid
    (alf.gain_total): a lane's rows, the fold in halves, the rows after
    the lanes."""
    lanes = 4 if cy == 4 else 8 if cy >= 8 else 0
    if not lanes:
        return cy * cx
    r0 = cy - cy % lanes
    return r0 // lanes * cx + lanes.bit_length() - 1 + (cy - r0) * cx


def class_chain_lengths(filts, orig, cls) -> dict:
    """The class SSE's lane chains (alf.class_sse_plain's order) whose
    total passes 2^24, which the kernel walks: their count, the longest's
    blocks (the walk's dependent adds) and how many of them are float32
    adds past its exact prefix."""
    from x266_tpu_torch.kernels import alf as kalf

    d = kalf.block_sse(filts, orig).reshape(filts.shape[0], -1).long()
    n = d.shape[1]
    lanes = 16 if n < kalf.CLASS_SSE_FUSED else 8
    key = (cls.reshape(-1).long() * lanes
           + torch.arange(n, device=d.device) % lanes)
    order = torch.argsort(key, stable=True)
    k = key[order]
    groups = kalf.NUM_CLASSES * lanes
    count = torch.bincount(k, minlength=groups)
    start = torch.cumsum(count, 0) - count
    out = {"ordered_chains": 0, "longest_blocks": 0, "longest_float_adds": 0}
    for lv in range(d.shape[0]):
        v = d[lv][order]
        run = torch.cumsum(v, 0)
        run = run - (run - v)[start[k]]           # the chain's own prefix
        exact = torch.bincount(k, weights=(run <= 2 ** 24).double(),
                               minlength=groups).long()
        total = torch.zeros(groups, dtype=torch.long,
                            device=d.device).index_add_(0, k, v)
        ordered = total > 2 ** 24
        out["ordered_chains"] += int(ordered.sum())
        if ordered.any():
            i = int(torch.where(ordered, count, -1).argmax())
            if int(count[i]) > out["longest_blocks"]:
                out["longest_blocks"] = int(count[i])
                out["longest_float_adds"] = int(count[i] - exact[i])
    return out


def nl_levels(o, r, check=None):
    """The nonlinear luma estimator's four filtered levels of r (uint8, as
    kernels/alf.py estimate_alf_nonlinear writes them), its class map and
    transposes: (levels, cls, tr).  check(v, outputs, cls, tr), if given,
    gets each clip value's normal-equation kernel outputs (coef, gram,
    rhs, stats)."""
    from x266_tpu_torch.kernels import alf as kalf
    from x266_tpu_torch.kernels import alf_cuda

    h, w = o.shape
    cls, tr = kalf.classify_full(r)
    on64 = torch.ones((-(-h // 64), -(-w // 64)), dtype=torch.int32,
                      device="cuda")
    levels = kalf.clip_levels()
    filts = torch.empty((len(levels), h, w), dtype=torch.uint8,
                        device="cuda")
    for lvl, v in enumerate(levels):
        out = alf_cuda.normal_solve(r, o, cls, True, clip=v, transpose=tr,
                                    with_stats=True)
        if check is not None:
            check(v, out, cls, tr)
        filts[lvl] = kalf.level_plane(r, cls, tr, out[0], lvl, on64)
    return filts, cls, tr


def cc_filtered(r, rc, oc):
    """CC-ALF's filtered chroma plane rc (all CTBs on) from the luma r, as
    the estimator forms it before its flags and gate."""
    from x266_tpu_torch.kernels import alf as kalf
    from x266_tpu_torch.kernels import alf_cuda

    coef = alf_cuda.cc_normal_solve(r, rc, oc)[0]
    on32 = torch.ones((-(-rc.shape[0] // 32), -(-rc.shape[1] // 32)),
                      dtype=torch.int32, device="cuda")
    return kalf.apply_ccalf(rc, r, coef, on32)


def compare_alf_nl_kernels(w, h, data, stats):
    """The ALF kernels' nonlinear and CC-ALF paths against their plain
    versions on the card, bit for bit, on the data sets of _alf_data: the
    luma normal equations of the clipped features aligned by the
    transposes and the chroma ones of the clipped 5x5 diamond at each of
    the 4 clip levels, CC-ALF's 7x7 equations and n = 7 solve (both
    planes' plain versions on the CPU in a worker), the per-class SSE of
    the uint8 luma planes those levels filter (ALFCLS, against the plain
    version on the same levels in int32) and CC-ALF's flags and gate.
    The shares of chains summed exactly and in order are printed, and the
    class SSE's ordered lane chains; the gate's times at 1080p and 4K,
    the other times at 4K, the encoder's luma going into the kernels
    line with the noise planes' class SSE."""
    from x266_tpu_torch.kernels import alf as kalf
    from x266_tpu_torch.kernels import alf_cuda

    levels = kalf.clip_levels()
    for kind, planes in data.items():
        tag = f"{w}x{h} {kind}"
        o, r, lam = planes["luma"]
        oc, rc, _ = planes["chroma"]
        st_luma = [0, 0]

        def check(v, out, cls, tr):
            *got, st = out
            want = kalf.normal_solve_plain(r, o, cls, True, v, tr)
            _require_equal("ALF", f"{tag} luma clip {v}",
                           ("coef", "gram", "rhs"), got, want)
            st_luma[0] += int(st[0])
            st_luma[1] += int(st[1])

        filts, cls, tr = nl_levels(o, r, check)
        ex, od = st_luma
        sse, cst = alf_cuda.class_sse(filts, o, cls, with_stats=True)
        want_sse, pc_ms = timed(kalf.class_sse_plain, filts.int(), o, cls)
        _require_equal("ALFCLS", tag, ("class sse",), [sse], [want_sse])
        chains = class_chain_lengths(filts, o, cls)
        for v in levels:
            *got, st = alf_cuda.normal_solve(rc, oc, None, True, clip=v,
                                             with_stats=True)
            ex, od = ex + int(st[0]), od + int(st[1])
            on_cpu("kernels-alf", alf_nl_check(tag, f"chroma clip {v}", got),
                   _plain_alf_cpu, rc.cpu().numpy(), oc.cpu().numpy(), v)
        *got, st = alf_cuda.cc_normal_solve(r, rc, oc, True, with_stats=True)
        ex, od = ex + int(st[0]), od + int(st[1])
        on_cpu("kernels-alf", alf_nl_check(tag, "cc-alf", got),
               _plain_alf_cpu, rc.cpu().numpy(), oc.cpu().numpy(), None,
               r.cpu().numpy())
        ALF_SHARES["exact"] += ex
        ALF_SHARES["ordered"] += od
        cfilt = cc_filtered(r, rc, oc)
        flags, worth = alf_cuda.ccalf_gate(cfilt, rc, oc, lam)
        want_f, want_w = kalf._ccalf_gate(cfilt, rc, oc, lam)
        _require_equal("ALFSSE", f"{tag} cc-alf gate", ("flags", "worth"),
                       [flags, worth], [want_f, want_w])
        _record(stats, "ALFCLS", 0)
        log(f"[kernels-alf] {tag}: nonlinear luma (4 levels) and chroma (4 "
            f"levels), CC-ALF == plain; chains exact {ex}, ordered {od}; "
            f"ALFCLS == plain (lane chains exact {int(cst[0])}, with an "
            f"ordered tail {int(cst[1])}; the longest ordered chain "
            f"{chains['longest_blocks']} blocks, {chains['longest_float_adds']}"
            f" of them float adds; classes at level 1-3: "
            f"{int((sse.argmin(0) > 0).sum())}); CC-ALF flags == plain "
            f"({int(flags.sum())} of {flags.numel()} on), gate "
            f"{bool(worth)}")
        if w < 1920 or kind == "crossing":
            continue
        # CC-ALF's gate (ccalf_gate, run by the CTB kernel's last block):
        # the CTB call with the gate less the same call without it; the
        # function reads each CTB's two SSEs and flag and writes one word,
        # a subtraction, a select and an add a CTB
        g_ms = event_ms(alf_cuda.ccalf_gate, cfilt, rc, oc, lam, reps=10)
        f_ms = event_ms(alf_cuda.ctb_flags, cfilt, rc, oc, 32, lam, reps=10)
        n_ctb = flags.numel()
        bg = bound(n_ctb * (2 * 4 + 4) + 4, 3.0 * n_ctb)
        fg = add_floor(gate_adds(*flags.shape))
        stats["ALFSSE"].setdefault("ccalf_gate", {})[f"{kind} {h}p"] = {
            "ms": g_ms - f_ms, "with_ctb_kernel_ms": g_ms,
            "ctb_kernel_ms": f_ms, "bound_ms": bg[0], "bound_by": bg[1],
            "dependent_add_floor": fg, "ctbs": n_ctb}
        log(f"[kernels-alf] {tag}: CC-ALF gate {g_ms - f_ms:.4f} ms (the CTB "
            f"call with it {g_ms:.4f} ms, without {f_ms:.4f} ms; {n_ctb} "
            f"CTBs; bound {bg[0]:.6f} ms, {bg[1]}; dependent-add floor "
            f"{fg['adds']} adds, {fg['cycles']:.0f} cycles at "
            f"{fg['cycles_per_add']:.2f} an add, {fg['ms']:.6f} ms)")
        n = r.numel()
        ks_ms = event_ms(alf_cuda.class_sse, filts, o, cls, reps=10)
        # four filtered planes, the source and the class map read once (a
        # byte a sample and a class), the (4, 25) sums written; per sample
        # and level a subtraction, a square and an add
        bs = bound(samples(filts, o, cls) + nbytes(sse),
                   3.0 * n * len(levels))
        fs = add_floor(chains["longest_blocks"])
        log(f"[kernels-alf] {tag}: ALFCLS {ks_ms:.4f} ms (plain {pc_ms:.0f} "
            f"ms on the cuda; bound {bs[0]:.4f} ms, {bs[1]}; "
            f"{chains['ordered_chains']} ordered lane chains, the longest "
            f"{chains['longest_blocks']} blocks: dependent-add floor "
            f"{fs['cycles']:.0f} cycles at {fs['cycles_per_add']:.2f} an add, "
            f"{fs['ms']:.6f} ms)")
        if w < 3840:
            continue
        if kind == "noise":
            _record(stats, "ALFCLS", 0, noise_ms=ks_ms, noise_chains=chains,
                    noise_dependent_add_floor=fs)
        else:
            _record(stats, "ALFCLS", 0, ms=ks_ms, plain_ms=pc_ms,
                    bound_ms=bs[0], bound_by=bs[1], chains=chains,
                    dependent_add_floor=fs, shape=f"{w}x{h} luma, 4 uint8 "
                    "levels, the encoder's planes")
        k_ms = event_ms(alf_cuda.normal_solve, r, o, cls, False, 8, False,
                        levels[1], tr, reps=10)
        b = bound(samples(r, o, cls, tr), 2.0 * n * (12 * 12 + 12))
        kc_ms = event_ms(alf_cuda.normal_solve, rc, oc, None, False, 8, False,
                         levels[1], reps=10)
        bc = bound(samples(rc, oc), 2.0 * rc.numel() * (6 * 6 + 6))
        kx_ms = event_ms(alf_cuda.cc_normal_solve, r, rc, oc, reps=10)
        bx = bound(samples(r, rc, oc), 2.0 * rc.numel() * (7 * 7 + 7))
        log(f"[kernels-alf] {tag}: ALF kernel, luma clip {levels[1]} "
            f"aligned {k_ms:.4f} ms (bound {b[0]:.4f} ms, {b[1]}); chroma "
            f"clip {levels[1]} {kc_ms:.4f} ms (bound {bc[0]:.4f} ms, "
            f"{bc[1]}); CC-ALF {kx_ms:.4f} ms (bound {bx[0]:.4f} ms, "
            f"{bx[1]})")
        if kind == "encoder":
            stats["ALF"]["at_4k_nl"] = {
                "luma_clip32_aligned_ms": k_ms, "luma_bound_ms": b[0],
                "chroma_clip32_ms": kc_ms, "chroma_bound_ms": bc[0],
                "ccalf_ms": kx_ms, "ccalf_bound_ms": bx[0]}


def compare_alf_kernel(w, h, seed, stats, data=None):
    """The ALF kernels against their plain versions on the card, luma and
    chroma, on the three data sets of _alf_data; bit-exact or raise.  The
    normal equations' plain version runs on the card for luma and on the
    CPU for chroma (its plane-long lane chains are a Python loop; in a
    worker process while the later phases run); the CTB decision's on
    the card.  The shares of chains summed exactly and
    in order are printed; at 4K the times on the noise and the encoder's
    planes, the encoder's luma ones going into the kernels line."""
    from x266_tpu_torch.kernels import alf as kalf
    from x266_tpu_torch.kernels import alf_cuda

    for kind, planes in (data or _alf_data(w, h, seed)).items():
        for plane, (o, r, lam) in planes.items():
            luma = plane == "luma"
            cls = kalf.classify(r) if luma else None
            *got, st = alf_cuda.normal_solve(r, o, cls, with_sums=True,
                                             with_stats=True)
            tag = f"{w}x{h} {kind} {plane}"
            if luma:
                want, pc_ms = timed(kalf.normal_solve_plain, r, o, cls, True)
                _require_equal("ALF", tag, ("coef", "gram", "rhs"), got,
                               want)
                held = "ALF == plain (on the cuda)"
            else:
                on_cpu("kernels-alf", alf_chroma_check(tag, got),
                       _plain_alf_cpu, r.cpu().numpy(), o.cpu().numpy())
                held = "ALF: plain on the cpu in a worker process"
            ex, od, tex, tod = st.tolist()
            ALF_SHARES["exact"] += ex
            ALF_SHARES["ordered"] += od
            line = (f"[kernels-alf] {tag}: {held}; "
                    f"chains exact {ex / max(ex + od, 1):.4f}, ordered "
                    f"{od / max(ex + od, 1):.4f} of {ex + od}; totals over "
                    f"blocks exact {tex}, ordered {tod}")
            coef = got[0]
            if luma:
                all_on = torch.ones((-(-h // 64), -(-w // 64)),
                                    dtype=torch.int32, device="cuda")
                filt = kalf.apply_alf(r, cls, coef, all_on)
                ctb = 64
            else:
                all_on = torch.ones((-(-r.shape[0] // 32),
                                     -(-r.shape[1] // 32)),
                                    dtype=torch.int32, device="cuda")
                filt = kalf.apply_alf_chroma(r, coef[0], all_on)
                ctb = 32
            flags, sst = alf_cuda.ctb_flags(filt, r, o, ctb, lam,
                                            with_stats=True)
            want_f, pf_ms = timed(kalf._ctb_flags, filt, r, o, ctb, lam)
            _require_equal("ALFSSE", tag, ("flags",), [flags], [want_f])
            sse = alf_cuda.ctb_sse(r, o, ctb)
            _require_equal("ALFSSE", tag, ("sse",), [sse],
                           [kalf.ctb_sse_plain(r, o, ctb)])
            we, wo = sst.tolist()
            line += (f"; ALFSSE flags == plain ({int(flags.sum())} of "
                     f"{flags.numel()} on), windows exact {we}, ordered {wo}")
            log(line)
            _record(stats, "ALF", 0)
            _record(stats, "ALFSSE", 0)
            if (w, h) != (3840, 2160) or kind == "crossing":
                continue
            k_ms = event_ms(alf_cuda.normal_solve, r, o, cls, reps=10)
            n = r.numel()
            t = kalf.DIAMOND.shape[0] if luma else \
                kalf.CHROMA_DIAMOND.shape[0]
            nc = coef.shape[0]
            # recon, source and class map read once (a byte a sample and a
            # class), the outputs written once; a multiply and an add per
            # product, and the solves
            b = bound(samples(r, o, *([] if cls is None else [cls]))
                      + nbytes(*got),
                      2.0 * n * (t * t + t) + nc * 2 * t ** 3)
            ks_ms = event_ms(alf_cuda.ctb_flags, filt, r, o, ctb, lam,
                             reps=10)
            # three planes read, the flags written (a byte a sample and a
            # flag); per sample and plane a subtraction, a square and an add
            bs = bound(samples(filt, r, o, flags), 6.0 * n)
            plain = (f"plain {pc_ms:.0f} ms on the cuda" if luma else
                     "plain: in its check on the cpu")
            log(f"[kernels-alf] {tag}: ALF kernel {k_ms:.4f} ms ({plain}); "
                f"bound {b[0]:.4f} ms "
                f"({b[1]}); ALFSSE kernel (order "
                f"{alf_cuda.sse_mode(ctb, o.shape[1])}) {ks_ms:.4f} ms "
                f"(plain {pf_ms:.0f} ms); bound {bs[0]:.4f} ms ({bs[1]})")
            if luma and kind == "encoder":
                _record(stats, "ALF", 0, ms=k_ms, plain_ms=pc_ms,
                        bound_ms=b[0], bound_by=b[1],
                        shape=f"{w}x{h} luma, the encoder's planes")
                _record(stats, "ALFSSE", 0, ms=ks_ms, plain_ms=pf_ms,
                        bound_ms=bs[0], bound_by=bs[1],
                        shape=f"{w}x{h} luma, the encoder's planes")


def alf_chroma_check(tag, got):
    """The check of the chroma normal equations (got) against the plain
    version's outputs from a worker."""
    got = [g.cpu() for g in got]

    def check(want, ms):
        _require_equal("ALF", tag, ("coef", "gram", "rhs"), got,
                       [torch.from_numpy(x) for x in want])
        log(f"[kernels-alf] {tag}: ALF == plain (on the cpu, in a worker "
            f"process, plain {ms:.0f} ms)")
    return check


def phase_kernels_alf(stats):
    for w, h in ((416, 240), (1920, 1080), (3840, 2160)):
        data = _alf_data(w, h, 31)
        compare_alf_kernel(w, h, 31, stats, data)
        compare_alf_nl_kernels(w, h, data, stats)
    log(f"[kernels-alf] chains summed exactly {ALF_SHARES['exact']}, in "
        f"order {ALF_SHARES['ordered']} over all data sets")
    if not (ALF_SHARES["exact"] and ALF_SHARES["ordered"]):
        raise AssertionError("[kernels-alf] the exact or the ordered path "
                             "was never taken")


def phase_golden():
    """ai_hevc, ai_hevc_lossless, gpb_rpl_wp and ra_alf (random access
    with nonlinear ALF and CC-ALF) decode to their manifest MD5s and
    re-encode from their sources (tools/make_fixtures.py) to the
    fixtures' bytes."""
    from x266_tpu_torch.api import Decoder, Encoder
    from x266_tpu_torch.config import CodecConfig
    from x266_tpu_torch.core.hashing import frame_md5
    from x266_tpu_torch.core.yuv import synthetic_clip

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name, cfg, n, kind in (
            ("ai_hevc", CodecConfig(width=96, height=64, qp=32, rdoq=True),
             1, "mixed"),
            ("ai_hevc_lossless", lossless_cfg(96, 64), 1, "mixed"),
            ("gpb_rpl_wp", CodecConfig(
                width=96, height=64, qp=32, rdoq=True, intra_period=16,
                multi_ref=True, rpl=True, weighted_pred=True), 4, "motion"),
            ("ra_alf", CodecConfig(
                width=96, height=64, qp=32, rdoq=True, intra_period=8,
                gop_size=4, deblock=True, sao=True, alf=True,
                alf_chroma=True, alf_nonlinear=True, ccalf=True, rpl=True),
             5, "mixed")):
        want = manifest[name]["md5"]
        with open(os.path.join(FIXTURES, f"{name}.266t"), "rb") as f:
            stream = f.read()
        _, dec = Decoder().decode(stream)
        got = [frame_md5(d) for d in dec]
        log(f"[golden] {name} decode md5 {got} manifest {want}")
        if got != want:
            raise AssertionError(f"{name} decode MD5 differs from the "
                                 "manifest")
        res = Encoder(cfg, with_recon=False).encode(
            synthetic_clip(96, 64, n, kind, seed=77))
        same = res.bitstream == stream
        log(f"[golden] {name} re-encode: {len(res.bitstream)} bytes, "
            f"byte-identical {same}")
        if not same:
            raise AssertionError(f"{name} re-encode differs from the "
                                 "fixture")


def phase_golden_filters():
    """The fixtures with loop filters decode to their manifest MD5s."""
    from x266_tpu_torch.api import Decoder
    from x266_tpu_torch.core.hashing import frame_md5

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name in ("lowdelay_p_filters", "ra_alf"):
        with open(os.path.join(FIXTURES, f"{name}.266t"), "rb") as f:
            stream = f.read()
        _, dec = Decoder().decode(stream)
        got = [frame_md5(d) for d in dec]
        ok = got == manifest[name]["md5"]
        log(f"[golden-filters] {name}: {len(got)} pictures, decode md5 "
            f"{'==' if ok else '!='} manifest")
        if not ok:
            raise AssertionError(f"{name} decode MD5s differ from the "
                                 "manifest")


def run_ra_ref(tag, name, file, cfg, kind, stats=None, kernels=(),
               card=None, need=(), seed=0, frames=None):
    """17 frames of the clip (seed) under cfg through Encoder
    and Decoder, held against the recorded JAX reference data/file: the
    whole stream, each slice NAL (coding order) and recon byte-identical,
    PSNR-Y and the float32 SSE equal (where the file records the SSE);
    the JAX stream decodes to JAX's MD5s; lossless decodes to its input.
    kernels: each must have launched in this encode and decode, and its
    count goes to stats[k]["launches_tools"][tag];
    card: one warm encode's frame rate is printed too; need: (picture
    type, tool) pairs whose count of CUs (ToolCuTally) must not be 0;
    frames: the clip, when it is not the plain synthetic one.  Returns
    the encode's result and the launches of the run."""
    import base64

    from x266_tpu_torch.api import Decoder, Encoder
    from x266_tpu_torch.core.hashing import frame_md5
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import inter

    w, h = cfg.width, cfg.height
    if frames is None:
        frames = synthetic_clip(w, h, 17, kind, seed=seed)
    enc, dec = Encoder(cfg), Decoder()
    inter.F10_BLOCKS.clear()
    _reset_launches()
    with ToolCuTally(cfg) as cus:
        res, t_enc = timed(enc.encode, frames)
    (_, decoded), t_dec = timed(dec.decode, res.bitstream)
    launches = _launches()
    md5 = hashlib.md5(res.bitstream).hexdigest()
    rec = [frame_md5(r) for r in res.recon]
    if [frame_md5(d) for d in decoded] != rec:
        raise AssertionError(f"[{tag}] {name}: decoded pictures differ "
                             "from the encoder's recon")
    if cfg.lossless:
        if rec != [frame_md5(f) for f in frames]:
            raise AssertionError(f"[{tag}] {name}: lossless pictures "
                                 "decode to other samples than the input")
        log(f"[{tag}] {name} lossless: every decoded picture equals the "
            "input")
    log(f"[{tag}] {name}: encode {t_enc / 1e3:.2f} s, decode "
        f"{t_dec / 1e3:.2f} s; stream md5 {md5}; bits {res.frame_bits}; "
        f"{f10_line()}; tool CUs of the P and B pictures {cus}")
    for pic, key in need:
        if not cus[pic].get(key):
            raise AssertionError(f"[{tag}] {name}: no {key} CU on the {pic} "
                                 "pictures")
    with open(os.path.join(DATA, file)) as f:
        ref = json.load(f)
    _, jdec = dec.decode(base64.b64decode(ref["stream_b64"]))
    if [frame_md5(d) for d in jdec] != [
            r["decode_md5"] for r in ref["frames"]]:
        raise AssertionError(f"[{tag}] {file}: the JAX stream does not "
                             "decode to JAX's MD5s")
    psnr = res.psnr_y(w, h)
    sse = [[float(v) for v in e] for e in res.sse]
    same = (md5 == ref["stream_md5"]
            and _slice_md5s(res.bitstream) == ref["nal_md5_coding_order"]
            and rec == [r["recon_md5"] for r in ref["frames"]])
    equal = all(p == r["psnr_y"] and e == r.get("sse", e)
                for p, e, r in zip(psnr, sse, ref["frames"]))
    dbits = [100.0 * (b - r["bits"]) / r["bits"]
             for b, r in zip(res.frame_bits, ref["frames"])]
    log(f"[{tag}] {name} vs {file} ({ref['source']}): byte-identical "
        f"{same}; PSNR-Y and SSE equal {equal} (SSE "
        f"{'recorded' if 'sse' in ref['frames'][0] else 'not recorded'}); "
        f"per frame bits % {[round(d, 3) for d in dbits]}; the JAX stream "
        "decodes to JAX's md5s")
    if not (same and equal):
        raise AssertionError(f"[{tag}] {name} differs from {file}")
    for k in kernels:
        if launches[k] < 1:
            raise AssertionError(f"[{tag}] {k} was not launched")
        stats[k].setdefault("launches_tools", {})[tag] = launches[k]
    if kernels:
        log(f"[{tag}] launches {launches}")
    if card is not None:
        _, t_warm = timed(enc.encode, frames)
        log(f"[{tag}] warm encode of 17 {w}x{h} frames: "
            f"{t_warm / 1e3:.3f} s = {17 / (t_warm / 1e3):.3f} fps on "
            f"{card}")
    return res, launches


class ToolCuTally:
    """Within the block, count the CUs of the encoder's P and B pictures
    that take the intra tools' branches (inter_tool_counts), from each
    picture's maps as the entropy coder gets them."""

    def __init__(self, cfg):
        self.cfg, self.counts = cfg, {"P": {}, "B": {}}

    def __enter__(self):
        from x266_tpu_torch.engine import picture

        self.orig = picture.tile_entropy

        def counted(td):
            if td.inter_maps is not None:
                pic = "B" if len(td.inter_maps) == 5 else "P"
                maps = [torch.from_numpy(np.ascontiguousarray(m))[None]
                        for m in (td.size_map, td.mode_map,
                                  td.inter_maps[0], td.mts_map)]
                for k, v in inter_tool_counts(self.cfg, maps[:3],
                                              maps[3]).items():
                    self.counts[pic][k] = self.counts[pic].get(k, 0) + v
            return self.orig(td)

        picture.tile_entropy = counted
        return self.counts

    def __exit__(self, *exc):
        from x266_tpu_torch.engine import picture

        picture.tile_entropy = self.orig


def phase_main_ra_ref(stats):
    """Config 4 at 416x240 (with and without ALF) and at 1080p (without),
    and lossless random access at 416x240, against the recorded JAX
    references."""
    noalf = dict(alf=False, alf_chroma=False)
    for name, file, cfg in (
            ("cfg4noalf", "cfg4noalf_416x240_ref.json",
             cfg4(416, 240).replace(**noalf)),
            ("cfg4noalf 1080p", "cfg4noalf_1080p_ref.json",
             cfg4(1920, 1080).replace(**noalf)),
            ("cfg4", "cfg4_416x240_ref.json", cfg4(416, 240))):
        run_ra_ref("main-ra-ref", name, file, cfg, "mixed")
    # lossless B candidates and K3-B's lossless branch on the card
    run_ra_ref("main-ra-ref", "lossless_ra", "lossless_ra_416x240_ref.json",
               lossless_ra_cfg(), "mixed", stats,
               ("K1", "K2", "K3", "K3d", "K3B", "K3Bd", "K4", "K5"),
               need=(("B", "lossless_inter"),))


def phase_main_cfg5(stats):
    """Config 5's single-device form (low-delay P, intra period 16,
    deblock and SAO, one entropy segment per CTU row with WPP context
    inheritance) at 112x80 (two CTU rows, so the second segment inherits
    the first's contexts and the filters cross a CTU-row edge), 17 frames
    of 'motion' (I, 15 P, I), against data/cfg5_112x80_ref.json: the clip
    of tests/test_torch_pipeline.py test_cfg5_clip_matches_recorded_jax,
    on the card."""
    from x266_tpu_torch.config import preset_cfg5

    run_ra_ref("main-cfg5", "cfg5", "cfg5_112x80_ref.json",
               preset_cfg5(112, 80), "motion", stats,
               ("K1", "K2", "K3", "K3d", "K4", "K5", "SSE"), seed=3)


def fade(frames, g0=1.0, g1=0.5):
    """A linear luma gain ramp over the clip, from g0 on its first frame
    to g1 on its last; chroma is kept (tools/make_torch_refs.py fade)."""
    from x266_tpu_torch.core.yuv import Frame

    out = []
    n = len(frames)
    for i, f in enumerate(frames):
        g = g0 + (g1 - g0) * i / max(n - 1, 1)
        y = np.clip(f.y.astype(np.float64) * g, 0, 255)
        out.append(Frame(y.astype(np.uint8), f.cb, f.cr))
    return out


GPB_WP_CONFIG = ("preset_cfg3(1920, 1080).replace(multi_ref=True, rpl=True, "
                 "weighted_pred=True)")
GPB_WP_CLIP = "fade(synthetic_clip(1920, 1080, 5, 'motion'), g0=1.0, g1=0.5)"
GPB_KERNELS = ("K1", "K2", "K3", "K3d", "K3B", "K3Bd", "K4", "K5", "SSE")


def phase_main_gpb(stats, card):
    """Config 3 at 1080p with GPB, signalled reference lists and weighted
    prediction, frames 0-4 of 'motion' under a luma fade, through
    Encoder and Decoder on the card, against data/gpb_wp_1080p_ref.json:
    the whole stream, each slice NAL, recon, PSNR-Y and float32 SSE
    equal; the decoded pictures equal the recon; a P and a B slice
    header carry weights other than identity; the B pictures hold L1
    and bi CUs; each kernel of the path launched (launches_gpb); the
    reweight's ms per list and one warm encode's frame rate."""
    from x266_tpu_torch.api import Decoder, Encoder
    from x266_tpu_torch.config import preset_cfg3
    from x266_tpu_torch.core.hashing import frame_md5
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import fused

    tag = "main-gpb"
    with open(os.path.join(DATA, "gpb_wp_1080p_ref.json")) as f:
        ref = json.load(f)
    if (ref["config"], ref["clip"]) != (GPB_WP_CONFIG, GPB_WP_CLIP):
        raise AssertionError(f"[{tag}] gpb_wp_1080p_ref.json records "
                             f"{ref['config']} on {ref['clip']}")
    cfg = preset_cfg3(1920, 1080).replace(multi_ref=True, rpl=True,
                                          weighted_pred=True)
    w, h, n = cfg.width, cfg.height, 5
    frames = fade(synthetic_clip(w, h, n, "motion"))
    t0 = time.perf_counter()
    enc, dec = Encoder(cfg, with_recon=True), Decoder()
    log(f"[{tag}] encoder/decoder set-up {time.perf_counter() - t0:.1f} s")
    _reset_launches()
    with ToolCuTally(cfg) as cus:
        res, t_enc = timed(enc.encode, frames)
    (_, decoded), t_dec = timed(dec.decode, res.bitstream)
    launches = _launches()
    log(f"[{tag}] first encode {t_enc / 1e3:.2f} s, decode "
        f"{t_dec / 1e3:.2f} s, launches {launches}")
    rec = [frame_md5(r) for r in res.recon]
    if [frame_md5(d) for d in decoded] != rec:
        raise AssertionError(f"[{tag}] decoded pictures differ from the "
                             "encoder's recon")
    md5 = hashlib.md5(res.bitstream).hexdigest()
    psnr = res.psnr_y(w, h)
    sse = [[float(v) for v in e] for e in res.sse]
    fr = ref["frames"]
    same = (md5 == ref["stream_md5"]
            and _slice_md5s(res.bitstream) == ref["nal_md5_coding_order"]
            and rec == [r["recon_md5"] for r in fr])
    equal = all(p == r["psnr_y"] and e == r["sse"]
                for p, e, r in zip(psnr, sse, fr))
    log(f"[{tag}] vs gpb_wp_1080p_ref.json ({ref['source']}): stream md5 "
        f"{md5}, byte-identical {same}; PSNR-Y {psnr} and SSE equal "
        f"{equal}; bits {res.frame_bits}")
    if not (same and equal):
        raise AssertionError(f"[{tag}] differs from gpb_wp_1080p_ref.json")
    hdrs = _slice_headers(cfg, res.bitstream)
    wps = [[sh.poc, sh.slice_type.name, sh.wp,
            None if sh.rpl is None else [sh.poc - d[0] for d in sh.rpl]]
           for sh in hdrs]
    log(f"[{tag}] slice (POC, type, weights, reference POCs): {wps}")
    for kind in ("P", "B"):
        if not any(k == kind and wp is not None
                   and any(wp[i:i + 4] != list(fused.IDENTITY_WP)
                           for i in range(0, len(wp), 4))
                   for _, k, wp, _ in wps):
            raise AssertionError(f"[{tag}] no {kind} slice carries "
                                 "weights other than identity")
    log(f"[{tag}] CUs of the B pictures: L1 {cus['B']['l1']}, bi "
        f"{cus['B']['bi']}")
    if not (cus["B"]["l1"] and cus["B"]["bi"]):
        raise AssertionError(f"[{tag}] the B pictures hold no L1 or no bi "
                             "CU")
    for k in GPB_KERNELS:
        if launches[k] < 1:
            raise AssertionError(f"[{tag}] {k} was not launched")
        stats[k]["launches_gpb"] = launches[k]
    if not launches["K3B"] == launches["K3Bd"] == 3 or launches["SSE"] != n:
        raise AssertionError(f"[{tag}] K3B / K3Bd launched {launches['K3B']}"
                             f" / {launches['K3Bd']} times for 3 B pictures,"
                             f" SSE {launches['SSE']} for {n} steps")
    # the reweight of one list's reference (three pyramids) at 1080p
    pyrs = fused.build_pyramids_device(
        *(torch.from_numpy(getattr(decoded[1], p)).cuda()
          for p in ("y", "cb", "cr")))
    wp = hdrs[2].wp[:4]
    ms = event_ms(fused.apply_wp, cfg, pyrs, wp)
    moved = 2 * nbytes(*pyrs)
    log(f"[{tag}] reweight of one list ({wp}; pyramids "
        f"{[tuple(p.shape) for p in pyrs]}, {nbytes(*pyrs) / 1e6:.1f} MB): "
        f"{ms:.4f} ms a list, CUDA events; bound {moved / PEAK_BYTES * 1e3:.4f}"
        f" ms (bytes: each read and written once) on {card}")
    _, t_warm = timed(enc.encode, frames)
    log(f"[{tag}] warm encode of {n} {w}x{h} frames: {t_warm / 1e3:.3f} s "
        f"= {n / (t_warm / 1e3):.3f} fps on {card}")


RA_NL_CONFIG = ("preset_cfg4(1920, 1080).replace(alf_nonlinear=True, "
                "ccalf=True)")
RA_NL_CLIP = "luma_chroma(synthetic_clip(1920, 1080, 17, 'motion'))"
RA_NL_KERNELS = ("K1", "K2", "K3", "K3d", "K3B", "K3Bd", "K4", "K5", "ALF",
                 "ALFSSE", "ALFCLS", "SSE")


def _slice_headers(cfg, stream: bytes):
    from x266_tpu_torch.core.headers import parse_slice_header
    from x266_tpu_torch.core.nal import NalType, split_nals

    return [parse_slice_header(
        rbsp, cfg.alf, cfg.ctus_y * cfg.ctus_x, cfg.alf_chroma,
        cfg.alf_nonlinear, cfg.ccalf, has_wp=cfg.weighted_pred,
        has_rpl=cfg.rpl)[0]
        for t, rbsp in split_nals(stream) if t in (NalType.IDR,
                                                   NalType.TRAIL)]


def phase_main_ra_nl(stats, card):
    """Config 4 at 1080p with nonlinear ALF and CC-ALF, 17 frames of
    'motion' with chroma made from the luma, through Encoder and Decoder
    on the card, against data/ra_nl_1080p_ref.json (run_ra_ref: stream,
    slice NALs, recon, PSNR-Y and SSE equal; decoded pictures equal the
    recon); per slice the luma classes whose clip index is not 0, the
    chroma planes whose level is not 0 and the CTBs with CC-ALF on, none
    of whose totals may be 0; each kernel's launches (launches_tools
    ["main-ra-nl"]) and
    one warm encode's frame rate; the loop filters of one picture make no
    host sync."""
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.utils.clips import luma_chroma

    tag = "main-ra-nl"
    with open(os.path.join(DATA, "ra_nl_1080p_ref.json")) as f:
        ref = json.load(f)
    if (ref["config"], ref["clip"]) != (RA_NL_CONFIG, RA_NL_CLIP):
        raise AssertionError(f"[{tag}] ra_nl_1080p_ref.json records "
                             f"{ref['config']} on {ref['clip']}")
    cfg = cfg4(1920, 1080).replace(alf_nonlinear=True, ccalf=True)
    frames = luma_chroma(synthetic_clip(1920, 1080, 17, "motion"))
    res, launches = run_ra_ref(tag, "ra_nl", "ra_nl_1080p_ref.json", cfg,
                               "motion", stats, RA_NL_KERNELS, card,
                               frames=frames)
    counts = [[sh.poc, sum(c != 0 for c in sh.alf_clips),
               sum(c != 0 for c in sh.alf_cclips), sum(sh.ccalf_flags)]
              for sh in _slice_headers(cfg, res.bitstream)]
    tot = [sum(c[k] for c in counts) for k in (1, 2, 3)]
    log(f"[{tag}] per slice (POC, luma classes with a clip index > 0, "
        f"chroma planes with a clip level > 0, CTBs with CC-ALF on): "
        f"{counts}; totals {tot}")
    if counts != ref["nl_counts"] or not all(tot):
        raise AssertionError(f"[{tag}] nonlinear / CC-ALF counts {tot} "
                             f"(the reference's {ref['nl_counts']})")
    stats["ALFCLS"]["launches"] = launches["ALFCLS"]
    if launches["ALFCLS"] != 17:
        raise AssertionError(f"[{tag}] ALFCLS launched {launches['ALFCLS']}"
                             " times for 17 pictures")
    # the loop filters of one picture, nonlinear estimators and CC-ALF
    # included, queue their work without a host sync
    from x266_tpu_torch.engine import fused

    rec, src = ([torch.from_numpy(getattr(f, p)).cuda()
                 for p in ("y", "cb", "cr")] for f in (res.recon[1],
                                                      frames[1]))
    sizes = torch.full((cfg.height // 8, cfg.width // 8), 8,
                       dtype=torch.int32, device="cuda")
    n_sync, _ = count_syncs(fused.loop_filters, cfg, *rec, sizes, src)
    log(f"[{tag}] host syncs in the loop filters of one picture: {n_sync}")
    if n_sync:
        raise AssertionError(f"[{tag}] the loop filters make {n_sync} host "
                             "syncs")


RC_CONFIG = "preset_cfg3(1920, 1080)"
RC_CLIP = "synthetic_clip(1920, 1080, 8, 'motion')"
RC_KERNELS = ("K1", "K3", "K3d", "K2", "K4", "K5", "SSE")


def phase_main_rc(stats, card):
    """Config 3 at 1080p under make_lambda_controller at half of
    data/cfg3_1080p_ref.json's bits per frame (30 fps), 8 frames of
    'motion', through Encoder and Decoder on the card, against
    data/rc_1080p_ref.json: the stream, slice NALs, each picture's QP,
    recon, PSNR-Y and SSE equal; at least two QPs; the decoded pictures
    equal the recon; each kernel's launches (launches_rc) and one warm
    encode's frame rate (a fresh controller, the steps kept)."""
    from x266_tpu_torch.api import Decoder, Encoder
    from x266_tpu_torch.core.hashing import frame_md5
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.utils import ratecontrol

    tag = "main-rc"
    with open(os.path.join(DATA, "rc_1080p_ref.json")) as f:
        ref = json.load(f)
    with open(os.path.join(DATA, "cfg3_1080p_ref.json")) as f:
        kbps = 0.5 * float(np.mean([r["bits"] for r in
                                    json.load(f)["frames"]])) * 30.0 / 1000.0
    c = ref["controller"]
    if ((ref["config"], ref["clip"]) != (RC_CONFIG, RC_CLIP)
            or c != {"kind": "lambda", "bitrate_kbps": kbps, "fps": 30.0,
                     "n_frames": 8}):
        raise AssertionError(f"[{tag}] rc_1080p_ref.json records "
                             f"{ref['config']} on {ref['clip']} under {c}")
    cfg = cfg3()
    w, h, n = cfg.width, cfg.height, 8
    frames = synthetic_clip(w, h, n, "motion")

    def controller():
        return ratecontrol.make_lambda_controller(cfg, kbps, 30.0,
                                                  n_frames=n)

    enc, dec = Encoder(cfg, rate_control=controller()), Decoder()
    _reset_launches()
    res, t_enc = timed(enc.encode, frames)
    (_, decoded), t_dec = timed(dec.decode, res.bitstream)
    launches = _launches()
    qps = [sh.qp for sh in _slice_headers(cfg, res.bitstream)]
    rec = [frame_md5(r) for r in res.recon]
    if [frame_md5(d) for d in decoded] != rec:
        raise AssertionError(f"[{tag}] decoded pictures differ from the "
                             "encoder's recon")
    md5 = hashlib.md5(res.bitstream).hexdigest()
    psnr = res.psnr_y(w, h)
    sse = [[float(v) for v in e] for e in res.sse]
    fr = ref["frames"]
    same = (md5 == ref["stream_md5"] and qps == ref["qp"]
            and _slice_md5s(res.bitstream) == ref["nal_md5_coding_order"]
            and rec == [r["recon_md5"] for r in fr])
    equal = all(p == r["psnr_y"] and e == r["sse"]
                for p, e, r in zip(psnr, sse, fr))
    log(f"[{tag}] encode {t_enc / 1e3:.2f} s, decode {t_dec / 1e3:.2f} s; "
        f"target {kbps:.3f} kbps at 30 fps ({kbps * 1000 / 30:.0f} bits a "
        f"frame); QP per picture {qps} (ref {ref['qp']}); bits "
        f"{res.frame_bits}; vs rc_1080p_ref.json ({ref['source']}): stream "
        f"md5 {md5}, byte-identical {same}, PSNR-Y and SSE equal {equal}; "
        f"launches {launches}")
    if not (same and equal) or len(set(qps)) < 2:
        raise AssertionError(f"[{tag}] differs from rc_1080p_ref.json, or "
                             f"fewer than two QPs: {qps}")
    for k in RC_KERNELS:
        if launches[k] < 1:
            raise AssertionError(f"[{tag}] {k} was not launched")
        stats[k]["launches_rc"] = launches[k]
    enc.rate_control = controller()
    _, t_warm = timed(enc.encode, frames)
    log(f"[{tag}] warm encode of {n} {w}x{h} frames: {t_warm / 1e3:.3f} s "
        f"= {n / (t_warm / 1e3):.3f} fps on {card}")


def run_main_ra(stats, card):
    """Config 4 at 3840x2160, 17 frames, through Encoder and Decoder on
    the card: decoded pictures equal the encoder's recon, K3B and K3Bd
    launched once per B picture."""
    from x266_tpu_torch.api import Decoder, Encoder
    from x266_tpu_torch.core.hashing import frame_md5
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.engine import inter

    cfg = cfg4()
    w, h, n = cfg.width, cfg.height, 17
    frames = synthetic_clip(w, h, n, "mixed")
    (enc, dec), t_set = timed(lambda: (Encoder(cfg), Decoder()))
    log(f"[main-ra] encoder/decoder set-up {t_set / 1e3:.1f} s")
    _reset_launches()
    inter.F10_BLOCKS.clear()
    res, t_enc = timed(enc.encode, frames)
    (_, decoded), t_dec = timed(dec.decode, res.bitstream)
    launches = _launches()
    for k in KERNELS:
        stats[k]["launches_cfg4"] = launches[k]
    log(f"[main-ra] first encode {t_enc / 1e3:.2f} s, decode "
        f"{t_dec / 1e3:.2f} s, launches {launches}; {f10_line()}")
    if [frame_md5(r) for r in res.recon] != [frame_md5(d) for d in decoded]:
        raise AssertionError("[main-ra] decoded pictures differ from the "
                             "encoder's recon")
    if len(decoded) != n or not all(f.y.shape == (h, w) for f in decoded):
        raise AssertionError("[main-ra] decoded picture count or shape")
    psnrs = res.psnr_y(w, h)
    if not all(np.isfinite(psnrs)) or min(psnrs) < 25.0:
        raise AssertionError(f"[main-ra] PSNR-Y {psnrs}")
    log(f"[main-ra] bits/frame {res.frame_bits} (stream "
        f"{res.total_bits / n:.0f} bits/frame, as bench.py counts); PSNR-Y "
        f"{[round(p, 4) for p in psnrs]} (mean {np.mean(psnrs):.4f} dB)")
    check_4k_reference(res, psnrs)
    for k, want in (("K3B", 15), ("K3Bd", 15), ("ALF", 3 * n),
                    ("ALFSSE", 3 * n), ("SSE", n)):
        if launches[k] != want:
            raise AssertionError(f"[main-ra] {k} launched {launches[k]} "
                                 f"times, not {want}")
        stats[k]["launches"] = launches[k]
    for k in ("K1", "K2", "K3", "K3d", "K4", "K5"):
        if launches[k] < 1:
            raise AssertionError(f"[main-ra] {k} was not launched")
    _, t_warm = timed(enc.encode, frames)
    log(f"[main-ra] warm encode of {n} {w}x{h} frames: {t_warm / 1e3:.3f} "
        f"s = {n / (t_warm / 1e3):.3f} fps on {card}")


def check_4k_reference(res, psnrs):
    """[main-ra]'s stream against the JAX reference recorded for it,
    data/cfg4_4k_ref.json: every slice NAL in coding order, the stream,
    each recon, PSNR-Y and float32 SSE equal; where only the pictures a
    cut recording reached exist (cfg4_4k_ref.partial.json), their slice
    NALs."""
    from x266_tpu_torch.core.hashing import frame_md5

    nal = _slice_md5s(res.bitstream)
    path = os.path.join(DATA, "cfg4_4k_ref.json")
    if os.path.exists(path):
        with open(path) as f:
            ref = json.load(f)
        fr = ref["frames"]
        same = (nal == ref["nal_md5_coding_order"]
                and hashlib.md5(res.bitstream).hexdigest()
                == ref["stream_md5"]
                and [frame_md5(r) for r in res.recon]
                == [r["recon_md5"] for r in fr])
        equal = all(p == r["psnr_y"] and [float(v) for v in e] == r["sse"]
                    for p, e, r in zip(psnrs, res.sse, fr))
        log(f"[main-ra] vs cfg4_4k_ref.json ({ref['source']}, "
            f"{ref['seconds']:.0f} s on its CPU): {len(nal)} slice NALs, "
            f"stream and recon byte-identical {same}; PSNR-Y and SSE equal "
            f"{equal}")
        if not (same and equal):
            raise AssertionError("[main-ra] the 4K stream differs from "
                                 "data/cfg4_4k_ref.json")
        return
    with open(path.replace(".json", ".partial.json")) as f:
        done = json.load(f)["slice_nals_coding_order"]
    same = nal[:len(done)] == [d["nal_md5"] for d in done]
    log(f"[main-ra] vs cfg4_4k_ref.partial.json: the {len(done)} slice "
        f"NALs the recording reached byte-identical {same}")
    if not same:
        raise AssertionError("[main-ra] the 4K stream differs from the "
                             "recorded pictures")


def f10_line() -> str:
    """The B Pass-A blocks of the run whose error sums pass 2^24, where
    the port's sums depend on following XLA's order (ROADMAP queue 3,
    F10)."""
    from x266_tpu_torch.engine import inter

    n = inter.f10_blocks()
    return (f"F10: B Pass-A blocks with an error sum >= 2^24 {n[8]} (8x8), "
            f"{n[16]} (16x16), {n[32]} (32x32)")


def count_syncs(fn, *args):
    """The host syncs of one call of fn after a warm-up call (torch's
    CUDA sync debug mode, 'warn'): (count, fn's result)."""
    import warnings

    fn(*args)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught), out


def check_filters(cfg, tab, tag, planes, p0, p1, got, maps):
    """On one B picture: the loop filters (deblock, SAO, ALF estimate and
    apply) and the whole B encode step queue their work without a host
    sync, and the ALF kernel's normal equations and coefficients of the
    picture equal the plain version's bit for bit."""
    from x266_tpu_torch.engine import fused
    from x266_tpu_torch.kernels import alf as kalf

    y, o = got[0][0].int(), planes[0][0].int()
    cls = kalf.classify(y)
    kern = kalf.normal_solve(y, o, cls, with_sums=True)
    plain = kalf.normal_solve_plain(y, o, cls, with_sums=True)
    same = all(torch.equal(a, b) for a, b in zip(kern, plain))
    log(f"[kernels-b] {tag}: ALF normal equations and coefficients of the "
        f"picture, kernel == plain version bit for bit: {same}")
    if not same:
        raise AssertionError(f"[kernels-b] {tag}: the ALF kernel differs "
                             "from its plain version")

    n_filt, _ = count_syncs(
        fused.loop_filters, cfg, *(g[0] for g in got[:3]), maps[0][0],
        [p[0] for p in planes], (maps[2][0], got[6][0].int(),
                                 got[7][0].int(), got[3][0].int()))
    n_step, _ = count_syncs(fused.make_encode_step_b(cfg, tab, False),
                            *planes, *p0, *p1)
    log(f"[kernels-b] {tag}: host syncs in the loop filters {n_filt}, in "
        f"one whole B encode step {n_step}")
    if n_filt or n_step:
        raise AssertionError(f"[kernels-b] {tag}: host syncs in the loop "
                             f"filters {n_filt}, in the B step {n_step}")


def _slice_md5s(stream: bytes):
    from x266_tpu_torch.core.nal import NalType, split_nals, write_nal

    return [hashlib.md5(write_nal(t, rbsp)).hexdigest()
            for t, rbsp in split_nals(stream)
            if t in (NalType.IDR, NalType.TRAIL)]


def _reset_launches():
    from x266_tpu_torch.engine import recon_cuda
    from x266_tpu_torch.kernels import alf_cuda, me_cuda, sse_cuda

    for mod in (recon_cuda, me_cuda, alf_cuda, sse_cuda):
        mod.reset_launches()


def _launches():
    from x266_tpu_torch.engine import recon_cuda
    from x266_tpu_torch.kernels import alf_cuda, me_cuda, sse_cuda

    return {**recon_cuda.LAUNCHES, **me_cuda.LAUNCHES, **alf_cuda.LAUNCHES,
            **sse_cuda.LAUNCHES}


def run_main(tag, cfg, kind, ref_name, kernels, stats, card,
             tools=False, sse_steps=None, lc=False, **enc_kw):
    """Frames 0-3 of the clip through Encoder() and Decoder() (on the
    card by default), held against the JAX reference file: each slice
    NAL and recon byte-identical, the PSNR-Y equal (and the float32 SSE,
    where the file records it; F4); lossless: the decoded pictures equal
    the input; the launch counts of the run; one warm encode's frame
    rate.  tools: the launches go to stats[k]["launches_tools"][tag],
    not to the kernel's main-path count; sse_steps: the encode's steps,
    each of which must launch kernel SSE once; lc: the clip's chroma is
    made from its luma (utils.clips.luma_chroma)."""
    from x266_tpu_torch.api import Decoder, Encoder
    from x266_tpu_torch.core.hashing import frame_md5
    from x266_tpu_torch.core.yuv import synthetic_clip
    from x266_tpu_torch.utils.clips import luma_chroma

    with open(os.path.join(DATA, ref_name)) as f:
        ref = json.load(f)["frames"]
    w, h, n = cfg.width, cfg.height, 4
    frames = synthetic_clip(w, h, n, kind)
    if lc:
        frames = luma_chroma(frames)
    t0 = time.perf_counter()
    enc = Encoder(cfg, with_recon=True, **enc_kw)
    dec = Decoder()
    log(f"[{tag}] encoder/decoder set-up {time.perf_counter() - t0:.1f} s")

    _reset_launches()
    t0 = time.perf_counter()
    res = enc.encode(frames)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, decoded = dec.decode(res.bitstream)
    t_dec = time.perf_counter() - t0
    launches = _launches()
    log(f"[{tag}] first encode {t_enc:.2f} s, decode {t_dec:.2f} s, "
        f"launches {launches}")

    rec_md5 = [frame_md5(r) for r in res.recon]
    dec_md5 = [frame_md5(d) for d in decoded]
    if rec_md5 != dec_md5:
        raise AssertionError(f"{tag}: decoded pictures differ from the "
                             "encoder's recon")
    if not all(f.y.shape == (h, w) for f in decoded):
        raise AssertionError(f"{tag}: decoded picture shape")
    if cfg.lossless:
        for i, (d, fr) in enumerate(zip(decoded, frames)):
            if not all(np.array_equal(getattr(d, p), getattr(fr, p))
                       for p in ("y", "cb", "cr")):
                raise AssertionError(f"{tag}: lossless frame {i} decodes "
                                     "to other samples than its input")
        log(f"[{tag}] lossless: every decoded plane equals the input")
    psnrs = res.psnr_y(w, h)
    nal_md5 = _slice_md5s(res.bitstream)
    for i, r in enumerate(ref):
        ident = nal_md5[i] == r["nal_md5"]
        sse = [float(v) for v in res.sse[i]]
        log(f"[{tag}] frame {i}: {res.frame_bits[i]} bits (ref {r['bits']}),"
            f" PSNR-Y {psnrs[i]!r} dB (ref {r['psnr_y']!r}), SSE {sse} "
            f"(ref {r.get('sse', 'not recorded')}), nal md5 "
            f"{nal_md5[i]} byte-identical {ident}, recon md5 "
            f"{'==' if rec_md5[i] == r['recon_md5'] else '!='} ref")
        if not ident or rec_md5[i] != r["recon_md5"]:
            raise AssertionError(f"{tag}: frame {i} differs from the "
                                 "reference's bytes or recon")
        if psnrs[i] != r["psnr_y"] or sse != r.get("sse", sse):
            raise AssertionError(f"{tag}: frame {i} PSNR-Y or SSE differs "
                                 "from the reference's float32 sum")
    if sse_steps is not None and launches["SSE"] != sse_steps:
        raise AssertionError(f"{tag}: SSE launched {launches['SSE']} times, "
                             f"not once in each of {sse_steps} steps")
    for k in kernels:
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the main path")
        if tools:
            stats[k].setdefault("launches_tools", {})[tag] = launches[k]
        else:
            stats[k]["launches"] = launches[k]

    t0 = time.perf_counter()
    enc.encode(frames)
    t_warm = time.perf_counter() - t0
    log(f"[{tag}] warm encode of {n} {w}x{h} frames: {t_warm:.3f} s = "
        f"{n / t_warm:.3f} fps on {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    stats = {k: {**dict.fromkeys(REQUIRED_KEYS), "max_abs_err": 0,
                 "launches": 0} for k in KERNELS}
    t_start = time.perf_counter()
    phase_environment()
    card = card_line()

    def run(name, fn, *args, **kw):
        t0 = time.perf_counter()
        fn(*args, **kw)
        log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")

    run("build", phase_build)
    run("kernels", phase_kernels, stats)
    run("kernels-sse", phase_kernels_sse, stats)
    run("kernels-p", phase_kernels_p, stats)
    run("kernels-me-4k", phase_kernels_me_4k, stats)
    run("golden", phase_golden)
    run("main", run_main, "main", main_cfg(), "mixed", "cfg2_1080p_ref.json",
        ("K1", "K2", "SSE"), stats, card, sse_steps=1, batch_frames=4)
    run("main-p", run_main, "main-p", cfg3(), "motion", "cfg3_1080p_ref.json",
        ("K3", "K3d", "K4", "K5"), stats, card)
    run("kernels-tools", phase_kernels_tools, stats)
    run("main-tools", run_main, "main-tools", cfg2t(), "text",
        "cfg2t_1080p_ref.json", ("K1", "K2"), stats, card, tools=True,
        batch_frames=4)
    run("main-lossless", run_main, "main-lossless", lossless_cfg(), "mixed",
        "lossless_1080p_ref.json", ("K1", "K2"), stats, card, tools=True,
        batch_frames=4)
    run("kernels-b", phase_kernels_b, stats)
    run("kernels-alf", phase_kernels_alf, stats)
    run("golden-filters", phase_golden_filters)
    run("kernels-inter-tools", phase_kernels_inter_tools, stats)
    run("main-p-lossless", run_main, "main-p-lossless", lossless_p_cfg(),
        "motion", "lossless_p_1080p_ref.json",
        ("K1", "K2", "K3", "K3d", "K4", "K5"), stats, card, tools=True)
    run("main-ra-tools", run_ra_ref, "main-ra-tools", "tools_ra",
        "tools_ra_1080p_ref.json", tools_ra_cfg(), "motion", stats,
        ("K1", "K2", "K3", "K3d", "K3B", "K3Bd", "K4", "K5", "ALF",
         "ALFSSE", "SSE"), card, need=(("B", "mip"), ("B", "pdpc")))
    run("main-ra-ref", phase_main_ra_ref, stats)
    run("main-cfg5", phase_main_cfg5, stats)
    run("main-gpb", phase_main_gpb, stats, card)
    run("main-ra-nl", phase_main_ra_nl, stats, card)
    run("main-rc", phase_main_rc, stats, card)
    run("kernels-sdh-dq", phase_kernels_sdh_dq, stats)
    run("main-sdh", run_main, "main-sdh", cfg2s(), "text",
        "cfg2s_1080p_ref.json", ("K1", "K2"), stats, card, tools=True,
        batch_frames=4)
    run("main-dq", run_main, "main-dq", main_cfg().replace(dep_quant=True),
        "mixed", "cfg2dq_1080p_ref.json", ("K1", "K2"), stats, card,
        tools=True, batch_frames=4)
    run("main-p-dq", run_main, "main-p-dq", cfg3dq(), "motion",
        "cfg3dq_1080p_ref.json", ("K1", "K2", "K3", "K3d", "K4", "K5"),
        stats, card, tools=True)
    run("main-ra-sdh-dq", phase_main_ra_sdh_dq, stats)
    run("kernels-mtt-lfnst", phase_kernels_mtt_lfnst, stats)
    run("main-mtt", run_main_mtt, "main-mtt", cfg2q(),
        "cfg2q_1080p_ref.json", stats, card)
    run("main-mtt-lfnst", run_main_mtt, "main-mtt-lfnst", cfg2ml(),
        "cfg2ml_1080p_ref.json", stats, card)
    run("kernels-cclm", phase_kernels_cclm, stats)
    run("main-cclm", run_main_cclm, stats, card)
    run("kernels-cu64", phase_kernels_cu64, stats)
    run("main-cu64", run_main_cu64, stats, card)
    run("cli", phase_cli, stats, card)
    run("main-ra", run_main_ra, stats, card)
    run("cpu-checks", finish_cpu_checks)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.0f} s")
    log(json.dumps({"kernels": [
        {"name": f"{k} {KERNELS[k][0]}", "route": "cuda",
         "source": KERNELS[k][1], "replaces": KERNELS[k][2],
         **{key: stats[k].get(key) for key in REQUIRED_KEYS},
         **{key: stats[k][key] for key in (
             "shape", "tus_by_size_map", "ms_per_chain_ctu",
             "us_per_chain_luma_tu", "launches_cfg4", "launches_gpb",
             "launches_rc", "at_4k", "at_4k_nl", "ccalf_gate",
             "launches_tools", "tools", "chains", "dependent_add_floor",
             "noise_ms", "noise_chains", "noise_dependent_add_floor")
            if key in stats[k]}}
        for k in KERNELS]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_cpu_workers()
    sys.exit(code)
