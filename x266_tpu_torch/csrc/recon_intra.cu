// Reconstruction scan: kernels K1 (intra encode), K2 (intra decode), K3-P
// (P-picture encode and decode) and K3-B (B-picture encode and decode).
//
// Replaces the Pallas TPU kernel x266_tpu/engine/recon_pallas.py:
// _build_pallas (inter=False; pl.pallas_call at :943), which is the
// normative Pass B of one picture: CTUs in raster order, 8x8 units in
// z-order; per TU the reference vector (with closed-form substitution),
// the intra prediction, forward MTS transform, deadzone or RDOQ
// quantization (encode), dequantization, inverse transform, clip and
// write-back; chroma TUs at half size follow each luma TU.  The plain
// PyTorch version is engine/recon.py (make_recon_pass_raw); the two must
// agree bit for bit.
//
// What bounds it on the H100: the serial dependency chain.  Every TU
// reads the reconstruction of the TUs before it, so a CTU row is one chain
// of dependent steps of a few hundred integer MACs each; neither bytes (a
// 1080p frame moves ~10 MB) nor operations come near the card's limits.
// The design shortens the chain and each step's latency.
//
// Between CTUs, a CTU-row wavefront.  The grid is frames x CTU rows, one
// thread block per row.  A block takes its row from an atomic ticket (so
// rows start in order whatever order the hardware runs blocks in, and a
// block only ever waits on a row that started before it); before CTU cx's
// window load, thread 0 waits (acquire) until the row above has published
// progress >= min(cx + 2, CTUs per row); after the CTU's stores every
// thread fences, the block meets at a barrier and thread 0 publishes
// progress cx + 1 (release).  So CTU (cx, cy) runs after (cx + 1, cy - 1),
// the order d = cx + 2*cy that engine/recon_wave.py proves bit-identical
// to the raster order; the longest chain is ctus_x + 2*(ctus_y - 1) CTUs
// (126 at 3840x2160 against 2,040 in raster order).  The ticket and the
// progress counters are an int32 buffer the launcher zeroes on the stream;
// the launcher also zeroes the final-MV planes and refuses a grid that
// does not fit the card's resident blocks.  It stays exact: the window
// load's `coded` predicate depends on positions only, so samples of CTUs
// not yet coded read as mid-gray whatever memory holds; the window store
// writes only the CTU itself; the MV derivation reads only inside the CTU
// row.  No CTU of a diagonal touches another's window: (cx +- 2, cy -+ 1)
// lie outside x0 - 1 .. x0 + 95; nor CCLM's luma row two above the CTU
// (x0 .. x0 + 63, CTU (cx, cy - 1)'s) or column two to its left (y0 ..
// y0 + 63, CTU (cx - 1, cy)'s), both finished before the wait ends.  Rows
// above are read through the L2 (__ldcg), after the acquire.
//
// Inside a CTU, the TU pipeline.  On the chain a TU's latency counts, not
// its work (X266_RECON_PHASES splits it by phase; with every step a
// barrier of all 256 threads and a one-thread substitution scan, that scan
// was 30-50 % of a TU).  The design:
// - Off the chain.  Before the row wait the block stages in shared memory
//   what does not depend on the reconstruction: the CTU's maps and its CU
//   list in z-order (warp 1); encode: the source samples; decode: the
//   levels and, per unit and plane, whether any is non-zero; each CU's
//   substitution sources (warps 2-7; below); K3: every CU's final MV,
//   derived in z-order by one thread of warp 1 from the maps, the left
//   CTU's last unit column and the CTU's earlier MVs -- all that
//   derive_mv / above_mv read.  After the wait each inter CU's MC
//   prediction (a bi CU's two blocks averaged) is staged beside the window
//   load, all loads issued before their stores.  The transform matrices
//   (int8, |c| <= 90, with a transposed copy so that lanes walk
//   consecutive bytes), the smoothing taps, the prediction shifts and the
//   rate of levels 0-255 are staged once per launch.  A TU's angular taps
//   are loaded into registers as it starts, in flight while its reference
//   vector is built.
// - Substitution as a warp scan, off the chain: a warp ballots the
//   availability of a CU's <= 129 reference entries (<= 5 words in the
//   scan order) and gives each unavailable entry the last available one
//   before it in that order (__clz on the masked words), a leading gap
//   the first available one, an empty vector mid-gray -- the serial
//   scan's integers by construction -- as a source index per entry; on
//   the chain each entry reads its source's sample from the window.
// - Plane-parallel warp groups.  The luma chain and the two chroma chains
//   share no data (chroma uses the luma position only in the
//   position-only decoded_before): warps 0-3 walk the CTU's luma TUs,
//   warps 4-5 its Cb TUs and warps 6-7 its Cr TUs at once, each group on
//   its own named barrier (bar.sync 1 + plane, its thread count); the
//   groups meet only at barrier 0: the staging, the window load and store
//   and the row-progress publish.
// - Fewer steps per TU.  A TU of at most 64 samples (luma 8x8, chroma 4x4
//   and 8x8) is warp 0's of its group alone, with __syncwarp between
//   steps; a larger one is the group's.  Each warp builds the reference
//   vector itself, so no barrier follows it.  The TU's size and thread
//   count are template parameters (tu<kEncode, S, G>), so its index
//   arithmetic folds and its loops unroll.  A thread owns samples i = t +
//   G k, which lie in one column, so it loads the matrix entry of a
//   column step once for all its samples, and it keeps its prediction in
//   registers from the prediction to the write-back.  Dequantization is
//   fused into the quantizer (encode) and into the inverse vertical
//   transform's level reads (decode); a TU whose levels are all zero
//   writes clip(prediction) with no inverse transform (exact: each step
//   maps 0 to 0); transform skip and lossless are per sample, with no
//   barrier.
//
// The intra tools of _build_pallas (recon_pallas.py :248, :391-393,
// :503-534, :603-644, :688-689) are runtime fields of Params, like qp and
// lambda (the branches are uniform per TU):
// - lossless: no transform or quantizer; encode writes level = source -
//   prediction and recon = source, decode clip(prediction + level);
// - ts (transform skip, luma TUs whose mts map value is 5): coefficients
//   = residual << (7 - log2 s) in place of the forward transform, and
//   (dequantized + 2^(tsh-1)) >> tsh in place of the inverse; RDOQ and
//   the quantizer are unchanged;
// - pdpc (luma): after the prediction shift, planar / DC / pure H / pure V
//   blend with the raw (substituted) references, a side gated off at the
//   picture's left or top edge;
// - MIP (modes >= n_std, luma): the 16 boundary group sums of the raw
//   references (top 2s then left 2s, s/4 samples each) times the mode's
//   16 int8 weights per sample, shifted by log2 s + 4: the same integers
//   as the reference's dense row, so bit-exact by construction.  A chroma
//   TU of a MIP CU predicts planar.
//
// Sign-data hiding and dependent quantization (x266_tpu/kernels/quant.py
// sdh_adjust, dq_quantize_trellis, dq_dequantize; the reference runs them
// on its XLA scan, not in the Pallas kernel) work over a TU in scan order,
// so they are a template parameter of the kernel (kQSdh, kQDq), whose
// instances csrc/recon_quant.cu compiles; the element-wise instances
// (kQPlain) quantize a coefficient a thread (quant_level, the same level
// and cost code).  Both stage the TU's coefficients in shared memory, and
// on the chain a TU's latency counts, so both spread the TU over its
// threads.  SDH: 16 lanes a 4x4 group, a
// lane a coefficient; ballots give the group's ends and parity, a 16-lane
// min the parity move.  DQ: the 4-state trellis's (4, 4) (min,+) matrices
// are combined in the tree of jax.lax.associative_scan (every prefix and
// suffix entry a float32 sum of the operands the reference sums), going
// up as matrices and coming down as the two rows the trellis reads (the
// prefix's row 0 and the suffix's row minima): each thread prices its run
// of positions once and walks its subtree in registers, each warp its
// levels between __syncwarp, and one group barrier joins the warps (see
// dq_trellis).  The state-dependent dequantized values come from the
// trellis's states where the levels' parities follow them, else (and in
// the decode) from the levels' parities by a warp scan of 4-state maps.
// DQ's scratch is dynamic shared memory after Shared.
//
// MTT binary splits and LFNST (x266_tpu/engine/recon.py:117-161, 393-499;
// the reference runs them on its XLA scan only) are a template parameter
// of K1 and K2 (kMl), taken when either flag is on; the other instances
// compile without them.  MTT: a 16 or 32 leaf whose mts map bits 4-5 say
// BT-H (1) or BT-V (2) codes as two rectangular CUs of one mode, each two
// square TUs of half the leaf's side, so the TU list takes the leaf's four
// TUs (mode from the rectangular CU's origin; transform choice, LFNST,
// levels and shifts from the TU's own units) in coding order: z-order,
// but a BT-V leaf's left CU first (its entries 1 and 2 swap).  Without
// substitution the window's mid-gray gives that order's availability;
// with it ref_sources compares inside a BT-V leaf by the leaf's order.
// LFNST (bits 6-7, luma TUs on the DCT-II pair; kernels/lfnst.py): the
// low 4x4's 16 owners stage it in vector order (transposed past the
// diagonal) and each computes one entry of the 16x16 integer product
// (the kernels in shared memory as int8, with their transposes), after
// the forward horizontal pass and, inverse, after dequantization; K2
// dequantizes such a TU into shared memory first.
//
// CCLM (x266_tpu/engine/recon.py:43-87, 332-391; the reference runs it on
// its XLA scan only) is a template parameter of K1 and K2 (kCc), taken by
// intra launches with cfg.cclm; the other instances compile without it, in
// csrc/recon_cclm.cu.  A CU's chroma TUs predict by the chroma mode (DM)
// or by the linear model from the CU's reconstructed luma: the 2x2 means
// of the luma, and alpha, beta from four boundary pairs (the 2x2 luma
// mean two rows above or two columns left, the chroma sample one above or
// one left, at 1/4 and 3/4 of the side), alpha's division floored; above
// or left of the picture the luma reads mid-gray (the reference's
// dynamic_slice counts the start -1 from the plane's end: its padding).
// The luma two rows above the CTU and two columns left of it join the
// window (Shared::cc_row, cc_col).  The chroma groups now depend on the
// luma group: one mbarrier per CU of the CTU (Shared::cc_bar), on which
// the luma group's thread 0 arrives once the CU's luma is in the window
// (after the TU's closing barrier) and which the chroma TU's threads wait
// on before reading it; the slots past the CTU's CUs get their arrival
// after the walk, so each completes one phase per CTU and the wait's
// parity is the CTU's.  K1 decides per CU by the joint SSE of both chroma
// planes against the source (CCLM where strictly below DM's): each chroma
// group sums its plane's two SSEs by warp reductions, the groups exchange
// them in shared memory (double-buffered by the CU's parity) across named
// barrier 4 (warp 0 of each group, a TU of <= 64 samples) or 5 (both
// groups), and Cb's thread 0 writes (mts & 7) | choice << 3 over the CU's
// units of the mts map out, which the launcher first copies from the map
// in.  K2 reads the choice from bit 3 and waits on the luma only for a CU
// that takes the model.
//
// Integer math is int32 multiply-accumulate (|residual x matrix| sums stay
// below 2^31).  RDOQ compares float32 costs e*e*err_scale + lam*rate with
// explicitly rounded __fmul_rn/__fadd_rn (and the library is built with
// -fmad=false), so no FMA contraction changes which level wins.  qp and
// lambda are runtime arguments.
//
// K3-P replaces the same Pallas kernel with inter=True, b_mode=False
// (make_recon_inter_pallas_raw, recon_pallas.py:1075-1152).  Its plain
// version is engine/inter.py (make_recon_inter_raw).  A P picture's CU is
// intra (K1's TU pipeline), inter (MC from the previous picture's
// 16-plane pyramids at the CU's MV, then the residual) or skip (MC at a
// derived MV, zero levels).  The skip MV comes from the unit MV state:
// the left unit's MV if its CU is a coded-MV inter CU, else the above
// unit's while inside the CTU row's 8 unit rows, else (0, 0); skip CUs'
// own MVs are never predictors (one hop).  Under merge candidates the
// encoder takes the above rule when the mvx map holds 1 and the decoder
// the MV the entropy walker resolved.  MC reads the pyramid plane
// (mvy&3)*4 + (mvx&3) at x + REF_PAD + (mvx>>2); chroma uses mv >> 1 on
// the chroma pyramids.  Each CU's final MV covers its units in the
// final-MV output planes.  P pictures depend on each other, so a launch
// holds one frame.
//
// K3-B replaces the same Pallas kernel with b_mode=True (recon_pallas.py
// :280-291, 587-592, 758-770, 858-868); its plain version is
// make_recon_inter_raw(..., b_mode=True).  It is K3-P's instantiation with
// a second reference: the L1 pyramids and the mvx1/mvy1 maps.  Kind
// PRED_L1 takes the L1 pyramid at the primary MV; a PRED_BI CU predicts
// (p0 + p1 + 1) >> 1 of L0 at the primary MV and L1 at mv1 (chroma
// mv >> 1).  L1 and bi CUs are coded-MV CUs for the skip derivation, and
// the MV state holds their primary MV.  One launch holds one picture.
//
// The launch goes through cudaLaunchKernel rather than <<<...>>>, so this
// file is plain C++ apart from CUDA's built-ins: tests/test_torch_kernel_host.py
// compiles it with g++ against a host stand-in of the runtime
// (tests/cuda_host/cuda_runtime.h, which has the named barriers) and holds
// it against the plain scan.

#include <cstdint>
#include <cuda_runtime.h>

#include "x266_device.cuh"

// csrc/recon_quant.cu, csrc/recon_cclm.cu, csrc/recon_cu64.cu and
// csrc/recon_cu64_cclm.cu compile this file again for the SDH / DQ
// instances, the CCLM ones and the CU-64 ones without and with CCLM; the
// entry points and the test kernel are this file's own.
#if defined(X266_RECON_CU64_CCLM_PART) && !defined(X266_RECON_CU64_PART)
#define X266_RECON_CU64_PART
#endif
#if !defined(X266_RECON_QUANT_PART) && !defined(X266_RECON_CCLM_PART) && \
    !defined(X266_RECON_CU64_PART)
#define X266_RECON_MAIN_PART
#endif

namespace {

constexpr int kThreads = 256;     // luma group 128, Cb 64, Cr 64
constexpr int kCtu = 64;
constexpr int kMaxSpins = 1 << 24;   // row wait cap, ~10 s at 64 ns a spin
constexpr int kMaxR = 4 * 32 + 1; // reference vector of a 32x32 TU
constexpr int kMaxModes = 128;    // shift table entries per size
constexpr int kRateShared = 256;  // rate table entries kept in shared memory
constexpr int kRefPad = 80;       // kernels/interp.py REF_PAD
constexpr int kIntra = 0, kSkip = 2, kL1 = 3, kBi = 4;  // inter.PRED_*
constexpr unsigned kFull = 0xffffffffu;

// specmodel.quant QUANT_SCALES / DEQUANT_SCALES
__constant__ int kQuantScale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
__constant__ int kDequantScale[6] = {40, 45, 51, 57, 64, 72};

// The phase split (X266_RECON_PHASES, set only by tools/profile_recon.py,
// never by the main path's build): the first thread of each plane's
// group stamps clock64() at the end of each phase of a TU and adds the
// cycles since its last stamp to g_recon_phases, by plane and TU size,
// with the count of TUs of each; thread 0 does the same for the
// block-level phases (staging, row wait, window load and MC staging, the
// CUs' TUs, window store, the whole block).
// A TU's row has its quantizer's own steps in the block-level slots 0-3:
// DQ's pricing and thread subtree, the warp and group levels up, the
// down walk, the thread's own walk and levels; SDH's levels and ballots,
// its moves.  The counts' row has, in slots 12-14, the
// DQ TUs of each plane whose dequantization fell back to dq_dequant.
enum Phase {
  kPhWait, kPhLoad, kPhMv, kPhStore, kPhRef, kPhSubst, kPhExt, kPhPred,
  kPhFwd, kPhQuant, kPhDeq, kPhInvV, kPhInvH, kPhCu, kPhBlock, kPhases = 16,
  kPhDqOwnUp = 0, kPhDqUp = 1, kPhDqDown = 2, kPhDqOwnDown = 3,
  kPhSdhLevels = 0, kPhSdhMoves = 1
};
#ifdef X266_RECON_PHASES
constexpr int kPhaseSlots = 14 * kPhases;   // 3 planes x 4 sizes, block, counts
__device__ unsigned long long g_recon_phases[kPhaseSlots];
struct PhaseClock {
  long long t;
  int base;                       // slot of phase 0, -1: not this thread
};
__device__ __forceinline__ void phase_start(PhaseClock& c, int base) {
  c.base = base;
  c.t = clock64();
}
__device__ __forceinline__ void phase_mark(PhaseClock& c, int ph) {
  if (c.base < 0) return;
  const long long now = clock64();
  atomicAdd(&g_recon_phases[c.base + ph], (unsigned long long)(now - c.t));
  c.t = now;
}
#define X266_PH_START(c, base, on) \
  PhaseClock c;                    \
  phase_start(c, (on) ? (base) : -1)
#define X266_PH(c, ph) phase_mark(c, ph)
#define X266_PH_COUNT(slot, on) \
  if (on) atomicAdd(&g_recon_phases[13 * kPhases + (slot)], 1ull)
#define X266_PH_PARAM , PhaseClock& pc
#define X266_PH_PASS , pc
#else
#define X266_PH_START(c, base, on) ((void)0)
#define X266_PH(c, ph) ((void)0)
#define X266_PH_COUNT(slot, on) ((void)0)
#define X266_PH_PARAM
#define X266_PH_PASS
#endif

struct Params {
  int frames, width, height;      // luma picture size
  int pitch_y, pitch_c;           // padded source plane widths (encode)
  int plane_y, plane_c;           // padded source plane sizes (encode)
  int qp, rdoq, mts, subst, n_modes;
  int n_std;                      // analytic modes (taps); MIP above
  int lossless, ts, pdpc;         // intra tools, see the header
  int dq;                         // dependent quantization (its instance)
  int mtt, lfnst;                 // MTT binary splits, LFNST (K1/K2)
  int cclm, sdh;                  // CCLM (K1/K2), sign-data hiding (encode)
  float lam;
  const uint8_t* src[3];          // encode: padded planes (F, Hp, Wp)
  const int16_t* coef_in[3];      // decode: levels (F, H, W)
  const int32_t *size_map, *mode_map, *mts_map;   // (F, H/8, W/8)
  uint8_t* rec[3];                // (F, H, W) / (F, H/2, W/2)
  int16_t* coef_out[3];           // encode: levels
  const int32_t *taps, *smooth, *tx, *shift;
  const int32_t* mip;             // (MIP_K, s*s, 16) for s = 8, 16, 32
  const int32_t* lfnst_tab;       // (8, 16, 16) LFNST kernels (lfnst)
  const float* rate;              // (32768,) rate surrogate
  int32_t* mts_out;               // K1 under CCLM: the mts map out
  // K3-P and K3-B only (frames == 1)
  int merge;                      // merge candidates on
  const int32_t *pred_map, *mvx_map, *mvy_map;   // (H/8, W/8)
  const uint8_t* pyr[6];          // (16, Hp, Wp) L0 Y, Cb, Cr; L1 (K3-B)
  int pyr_h[2], pyr_w[2];         // luma, chroma pyramid plane sizes
  int16_t* mv_out[2];             // final MVs (H/8, W/8)
  const int32_t* mv1_map[2];      // K3-B: a bi CU's L1 MV (H/8, W/8)
  int* sync;                      // row ticket, then progress per row
};

// Offsets of size s in the flat tables (sizes 4, 8, 16, 32 in order; the
// CU-64 instances' tables append the 64 size to the taps, smoothing taps,
// shifts and, as a fourth block after the three types, the 64-point
// DCT-II: tables.kernel_tables).
constexpr int kTxPerType = 16 + 64 + 256 + 1024;
constexpr int kSmooth = (17 + 33 + 65 + 129) * 3;
constexpr int kTx64 = 64 * 64, kSmooth64 = 257 * 3;

__device__ __forceinline__ int size_index(int s) {
  return s == 4 ? 0 : s == 8 ? 1 : s == 16 ? 2 : s == 32 ? 3 : 4;
}

__device__ __forceinline__ int tx_offset(int s) {
  return s == 4 ? 0 : s == 8 ? 16 : s == 16 ? 80 : s == 32 ? 336
                                                           : 3 * kTxPerType;
}

__device__ __forceinline__ int smooth_offset(int s) {
  return s == 4 ? 0 : s == 8 ? 17 * 3 : s == 16 ? (17 + 33) * 3
                    : s == 32 ? (17 + 33 + 65) * 3 : kSmooth;
}

__device__ __forceinline__ int taps_offset(int s, int n_modes) {
  int o = 0;
  for (int t = 4; t < s; t *= 2) o += n_modes * t * t * 4;
  return o;
}

// tables.MIP_SIZES 8, 16, 32; MIP_K = 8 matrices of (s*s, 16) each.
constexpr int kMipK = 8;
__device__ __forceinline__ int mip_offset(int s) {
  return s == 8 ? 0 : s == 16 ? kMipK * 64 * 16 : kMipK * (64 + 256) * 16;
}

// One warp's reference scratch for TUs of up to R - 1 / 4 samples a side:
// [substituted refs, smoothed refs] and the MIP group sums.
template <int R>
struct RefsT {
  int ext[2 * R];
  int grp[16];
};

// A TU of the CTU being coded, in coding order (staged before the row
// wait): a CU's, or under MTT one of a BT leaf's four.
struct alignas(16) Cu {
  uint8_t ux, uy;                 // unit within the CTU
  uint8_t s;                      // luma side
  uint8_t kind;                   // inter.PRED_* (kIntra in K1/K2)
  uint8_t tv, th, ts;             // luma transform types; transform skip
  uint8_t nz;                     // decode: bit p, plane p has a level != 0
  int16_t mode;
  uint8_t mode_c;                 // chroma's mode (< 67)
  uint8_t lf;                     // LFNST: 0 off, else kLfOn | kernel << 1 |
                                  // transpose
  int16_t shift_y, shift_c;       // prediction shifts, luma and chroma
};
constexpr int kLfOn = 0x80;

// Staged samples of the CTU: luma at 0 (64 a row), Cb at 4096 and Cr at
// 5120 (32 a row).
constexpr int kStage = 64 * 64 + 2 * 32 * 32;

// A substitution source index: uint8_t up to a 32-TU's 129 entries (255
// mid-gray), uint16_t for a 64-TU's 257 (65535 mid-gray).
template <bool kWide> struct SrcIndex { using T = uint8_t; };
template <> struct SrcIndex<true> { using T = uint16_t; };

// The sizes of an instance's shared memory: kC64, the CU-64 instances', for
// a 64x64 luma TU and its 32x32 chroma TUs; the others' for TUs of up to
// 32 (luma) and 16 (chroma).  A TU of side s at the CTU's far corner reads
// references up to 2s - 1 past it: the windows reach origin + 127 (luma)
// and + 63 (chroma), + 95 and + 47 without CU 64.
template <bool kC64>
struct Layout {
  static constexpr bool kCu64 = kC64;
  static constexpr int kTuY = kC64 ? 64 : 32, kTuC = kTuY / 2;
  static constexpr int kWinY = 1 + kCtu + kTuY;   // CTU origin -1 .. +127 / +95
  static constexpr int kWinC = 1 + kCtu / 2 + kTuC;
  static constexpr int kPitchY = kC64 ? 132 : 100;   // row pitches (words)
  static constexpr int kPitchC = kC64 ? 68 : 52;
  static constexpr int kRefY = 4 * kTuY + 1, kRefC = 4 * kTuC + 1;
  static constexpr int kTx = 3 * kTxPerType + (kC64 ? kTx64 : 0);
  static constexpr int kSmoothN = kSmooth + (kC64 ? kSmooth64 : 0);
  static constexpr int kSizes = kC64 ? 5 : 4;     // luma TU sizes of the shifts
  static constexpr int kSrcWords = (kRefY + 31) / 32;   // substitution ballots
  using Src = typename SrcIndex<kC64>::T;
  using Refs = RefsT<kRefY>;
};

template <bool kC64>
struct SharedT : Layout<kC64> {
  using L = Layout<kC64>;
  // the windows: the CTU, the row above and the column to the left
  alignas(16) uint8_t win_y[L::kWinY * L::kPitchY];
  alignas(16) uint8_t win_c[2][L::kWinC * L::kPitchC];
  // tables, once per launch: the transform matrices [k][n], transposed
  int8_t tx[2][L::kTx];
  int smooth[L::kSmoothN];
  int shift[L::kSizes * kMaxModes];
  float rate[kRateShared];        // RDOQ's rate of levels 0-255
  int8_t lfnst[2][8 * 256];       // LFNST kernels [k][i][j], transposed
  // the CTU's staged inputs
  union alignas(16) {
    uint8_t src[kStage];          // encode: source samples
    int16_t lev[kStage];          // decode: levels
  } in;
  uint8_t mcp[kStage];            // K3: MC prediction
  // the CTU's units (raster) and CUs; unit columns 1-8 of ukind / umv are
  // the CTU's, column 0 the left CTU's last (the MV state it leaves)
  int16_t size[64], mode[64], mts[64];
  int16_t mvx[64], mvy[64], mv1x[64], mv1y[64];
  int16_t ukind[8][9];            // pred_map at the unit
  int16_t umv[2][8][9];           // final MV of the unit's CU
  int8_t cu_kind[64];             // the kind of the unit's CU (MC staging)
  int16_t cu_mv1[2][64];          // the mv1 of the unit's CU (bi)
  int unz[64];                    // decode: bit p, plane p non-zero
  // each CU's substitution sources (subst_sources), by its first unit
  typename L::Src rsrc_y[64][L::kRefY];
  typename L::Src rsrc_c[64][L::kRefC];
  Cu cus[64];
  int n_cus;
  // per group: the TU's coefficients; per warp: its reference vector
  alignas(16) int a_y[L::kTuY * L::kTuY];
  alignas(16) int b_y[L::kTuY * L::kTuY];
  alignas(16) int a_c[2][L::kTuC * L::kTuC];
  alignas(16) int b_c[2][L::kTuC * L::kTuC];
  int lf_vec[3][16];              // per group: an LFNST input vector
  typename L::Refs refs[8];
  // CCLM (its instances): the luma two rows above the CTU (x0 .. x0 + 63)
  // and two columns to its left (y0 .. y0 + 63), one mbarrier per CU (the
  // CU's luma is in the window), and K1's SSE exchange [CU parity][Cb,
  // Cr][warp of the group][CCLM, DM]
  uint8_t cc_row[kCtu], cc_col[kCtu];
  alignas(8) uint64_t cc_bar[64];
  int cc_sse[2][2][2][2];
};
using Shared = SharedT<false>;
static_assert(sizeof(SharedT<true>) <= 232448,
              "a CU-64 instance's block fits the H100's 227 KB of shared "
              "memory");

// The quantizer of a recon kernel instance (a template parameter, so the
// instances without SDH or DQ compile to the code they had before them):
// element-wise (deadzone or RDOQ), sign-data hiding (encode only) or
// dependent quantization.
constexpr int kQPlain = 0, kQSdh = 1, kQDq = 2;

__host__ __device__ constexpr int ilog2(int x) {
  return x > 1 ? 1 + ilog2(x / 2) : 0;
}

// Dependent quantization's schedule for a side-S TU on G threads: T
// threads own R = n / T consecutive positions each in coding order (T =
// G, or 16 for a 4x4 TU), a node of tree level h = log2 R; the Wn warps
// own TW threads each, a node of level hw = h + log2 TW, the warp's top;
// the levels above hw (none on one warp) join the warps.  Its scratch, in
// float4 (16-byte) units after Shared in dynamic shared memory (DQ
// instances only): the node matrices of levels h..hw (row a of node m at
// a * kTab + m); the threads' matrices of levels 1..h-1 (row a of a
// thread's k-th at (k * 4 + a) * T + t); each node's prefix row 0 and
// suffix row minima of levels h..hw-1 (at m and kVec + m); per warp the
// matrices above hw and the rows of levels hw..L.
template <int S, int G>
struct DqShape {
  static constexpr int n = S * S, L = ilog2(n);
  static constexpr int T = n >= G ? G : n, R = n / T, h = ilog2(R);
  static constexpr int Wn = T >= 32 ? T / 32 : 1, TW = T / Wn;
  static constexpr int hw = h + ilog2(TW);
  // nodes of levels a..b-1 (a tree of n leaves)
  __host__ __device__ static constexpr int nodes(int a, int b) {
    return a >= b ? 0 : ((2 * n) >> a) - ((2 * n) >> b);
  }
  static constexpr int kTab = nodes(h, hw + 1), kVec = nodes(h, hw);
  static constexpr int kLoc = R >= 4 ? R - 2 : 0;   // a thread's
  static constexpr int kCross = Wn - 1, kTopRows = 2 * Wn - 1;
  static constexpr int kTop = 4 * kCross + 2 * kTopRows;   // a warp's
  static constexpr int kUnits = 4 * kTab + 4 * kLoc * T + 2 * kVec +
                                Wn * kTop;
};
template <int S, int G>
__host__ __device__ constexpr int dq_floats() {
  return 4 * DqShape<S, G>::kUnits;
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
// each plane group's scratch: luma TUs 8 (a warp), 16 and 32 (128
// threads); chroma 4, 8 (a warp) and 16 (64 threads); then each group's
// warp totals of the state scan (4 words a group)
constexpr int kDqLuma = cmax(cmax(dq_floats<8, 32>(), dq_floats<16, 128>()),
                             dq_floats<32, 128>());
constexpr int kDqChroma = cmax(cmax(dq_floats<4, 32>(), dq_floats<8, 32>()),
                               dq_floats<16, 64>());
constexpr int kDqTot = kDqLuma + 2 * kDqChroma;
constexpr size_t kDqBytes = sizeof(float) * kDqTot + sizeof(uint32_t) * 12;
static_assert(kDqLuma % 4 == 0 && kDqChroma % 4 == 0, "float4 units");
static_assert(sizeof(Shared) + kDqBytes <= 232448,
              "a DQ instance's block fits the H100's 227 KB of shared memory");

__device__ __forceinline__ int rshift_round(int x, int sh) {
  return (x + (1 << (sh - 1))) >> sh;
}

__device__ __forceinline__ int mini(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// z-order index of unit (ux, uy) within a CTU, and its inverse.
__device__ __forceinline__ int z_index(int ux, int uy) {
  int z = 0;
  for (int b = 0; b < 3; ++b) {
    z |= ((ux >> b) & 1) << (2 * b);
    z |= ((uy >> b) & 1) << (2 * b + 1);
  }
  return z;
}

__device__ __forceinline__ void z_unit(int z, int& ux, int& uy) {
  ux = (z & 1) | (((z >> 2) & 1) << 1) | (((z >> 4) & 1) << 2);
  uy = ((z >> 1) & 1) | (((z >> 3) & 1) << 1) | (((z >> 5) & 1) << 2);
}

// engine.availability.decoded_before on luma coordinates (kCtu = 64).
__device__ __forceinline__ bool decoded_before(int px, int py, int bx,
                                               int by, int w, int h) {
  if (px < 0 || py < 0 || px >= w || py >= h) return false;
  const int cp = ((py >> 6) << 20) + (px >> 6);
  const int cb = ((by >> 6) << 20) + (bx >> 6);
  if (cp != cb) return cp < cb;
  return z_index((px & 63) >> 3, (py & 63) >> 3) <
         z_index((bx & 63) >> 3, (by & 63) >> 3);
}

// One plane's view: the shared window and where it sits.
struct View {
  uint8_t* win;
  int wdim;            // window side
  int pitch;           // window row pitch, a multiple of 4
  int ox, oy;          // plane coords of window element (0, 0)
  int pw, ph;          // plane size
  int scale;           // 1 luma, 2 chroma
  int plane;           // 0 Y, 1 Cb, 2 Cr
};

__device__ __forceinline__ uint8_t& at(const View& v, int x, int y) {
  return v.win[(y - v.oy) * v.pitch + (x - v.ox)];
}

// A plane's group of warps: its named barrier (1 + plane), its thread
// count and the calling thread's index in it.
struct Group {
  int bar, size, lt;
};

#ifdef X266_MUTATE_GROUP_BARRIER
// tests only: the group on barrier X266_MUTATE_GROUP_BARRIER skips its
// named barriers, which the host tests must catch
#define X266_GROUP_BARRIER_ON(id) ((id) != X266_MUTATE_GROUP_BARRIER)
#else
#define X266_GROUP_BARRIER_ON(id) true
#endif

// The barrier of a TU's threads: warp 0 of the group for a small TU,
// else the group's named barrier; group_any also ORs pred over them.
__device__ __forceinline__ void group_sync(const Group& g, bool small) {
  if (small) __syncwarp();
  else if (X266_GROUP_BARRIER_ON(g.bar)) x266_bar_sync(g.bar, g.size);
}

__device__ __forceinline__ bool group_any(const Group& g, bool small,
                                          bool pred) {
  if (small) return __any_sync(kFull, pred);
  if (!X266_GROUP_BARRIER_ON(g.bar)) return pred;
  return x266_bar_red_or(g.bar, g.size, pred) != 0;
}

// Scan position k of a reference vector of side s -> its index in
// [corner, top 2s, left 2s]: left bottom->top, corner, top left->right.
__device__ __forceinline__ int scan_index(int k, int s) {
  return k < 2 * s ? 4 * s - k : (k == 2 * s ? 0 : k - 2 * s);
}

// The position of entry i of the reference vector [corner, top 2s, left
// 2s] of the TU at (x, y), side s.
__device__ __forceinline__ void ref_pos(int i, int x, int y, int s, int& px,
                                        int& py) {
  if (i == 0) { px = x - 1; py = y - 1; }
  else if (i <= 2 * s) { px = x + i - 1; py = y - 1; }
  else { px = x - 1; py = y + i - 1 - 2 * s; }
}

// Substitution as a warp scan: m[w] bit l is the availability of scan
// position 32 w + l (left bottom->top, corner, top left->right), kW words
// (5 up to a 32-TU's 129 entries, 9 for a 64-TU's 257).  Writes, for each
// entry i of [corner, top 2s, left 2s], the entry whose sample it takes:
// itself when available; else the last available one before it in the scan
// (__clz on the masked word, or the last word before it with one), for a
// leading gap the first available one; the index type's largest value
// (mid-gray) for an empty vector.  The serial scan's integers by
// construction.
template <int kW, typename Src>
__device__ void subst_sources(int s, const unsigned (&m)[kW], Src* src) {
  const int lane = threadIdx.x & 31;
  const int r_len = 4 * s + 1;
  int before[kW], last = -1, first = -1;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    before[w] = last;
    if (m[w]) last = 32 * w + 31 - __clz((int)m[w]);
  }
#pragma unroll
  for (int w = kW - 1; w >= 0; --w)
    if (m[w]) first = 32 * w + __ffs((int)m[w]) - 1;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int k = lane + 32 * w;
    if (k >= r_len) continue;
    int from = k;
    if (!((m[w] >> lane) & 1)) {
      const unsigned below = m[w] & ((1u << lane) - 1);
      from = below ? 32 * w + 31 - __clz((int)below) : before[w];
      if (from < 0) from = first;
    }
    src[scan_index(k, s)] = from < 0 ? (Src)~0u : (Src)scan_index(from, s);
  }
}

// A BT-V MTT leaf of side lf at plane coords (lx, ly) (lf 0: none),
// whose t-blocks (t = lf / 2) code left half first, top to bottom.
struct BtvLeaf {
  int lx, ly, lf;
};

// One warp: the substitution sources of the TU at plane coords (x, y),
// side s, on a plane of scale 1 (luma) or 2 (chroma), from
// decoded_before's availability of each entry; inside a BT-V leaf the
// leaf's order decides (engine.availability.ref_masks with btv_leaf).
template <int kW, typename Src>
__device__ void ref_sources(const Params& p, int x, int y, int s, int scale,
                            const BtvLeaf& leaf, Src* src) {
  const int lane = threadIdx.x & 31;
  unsigned m[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int k = lane + 32 * w;
    bool avail = false;
    if (k < 4 * s + 1) {
      int px, py;
      ref_pos(scan_index(k, s), x, y, s, px, py);
      avail = decoded_before(px * scale, py * scale, x * scale, y * scale,
                             p.width, p.height);
      const int lx = leaf.lx, ly = leaf.ly, lf = leaf.lf;
      if (lf && px >= lx && px < lx + lf && py >= ly && py < ly + lf &&
          px >= 0 && py >= 0) {
        const int t = lf >> 1;
        avail = 2 * ((px - lx) / t) + (py - ly) / t <
                2 * ((x - lx) / t) + (y - ly) / t;
      }
    }
    m[w] = __ballot_sync(kFull, avail);
  }
  subst_sources(s, m, src);
}

// The reference vector of the TU at plane coords (x, y), side S, built by
// the calling warp into r.ext: [corner, top 2S, left 2S] from the window
// (entry i reads entry src[i]'s sample, mid-gray for the index type's
// largest value, when src is given: substitution), the smoothed copy from
// 4S + 1, MIP's 16 group sums into r.grp; returns the DC sum (mode 1).
template <int S, typename Sh, typename R, typename Src>
__device__ int build_refs(const Sh& sh, const View& v, R& r, int x, int y,
                          int mode, bool mip,
                          const Src* src X266_PH_PARAM) {
  constexpr int r_len = 4 * S + 1;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w * 32 < r_len; ++w) {
    const int i = lane + 32 * w;
    if (i >= r_len) continue;
    const int j = src ? src[i] : i;
    int val = 128, px, py;
    if (j != (Src)~0u) {
      ref_pos(j, x, y, S, px, py);
      val = at(v, px, py);
    }
    r.ext[i] = val;
  }
  __syncwarp();
  X266_PH(pc, kPhRef);
  // [raw, smoothed] extension; the DC sum; MIP's group sums
  const int* smt = sh.smooth + smooth_offset(S);
#pragma unroll
  for (int w = 0; w * 32 < r_len; ++w) {
    const int i = lane + 32 * w;
    if (i >= r_len) continue;
    int acc = 0;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int e = smt[i * 3 + t];
      acc += (e & 255) * r.ext[e >> 8];
    }
    r.ext[r_len + i] = (acc + 2) >> 2;
  }
  int dc = 0;
  if (mode == 1) {
    if constexpr (S <= 32) {
      if (lane < S) dc = r.ext[1 + lane] + r.ext[1 + 2 * S + lane];
    } else {
#pragma unroll
      for (int j = lane; j < S; j += 32)
        dc += r.ext[1 + j] + r.ext[1 + 2 * S + j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dc += __shfl_xor_sync(kFull, dc, o);
  }
  if (mip && lane < 16) {
    // group lane: S/4 raw references of [top 2S, left 2S]
    int acc = 0;
#pragma unroll
    for (int j = 0; j < S / 4; ++j) acc += r.ext[1 + lane * (S / 4) + j];
    r.grp[lane] = acc;
  }
  __syncwarp();
  X266_PH(pc, kPhExt);
  return dc;
}

// The TU's sample map on G threads for side S: thread lt owns samples
// (row0 + k * kStep, col), k < kK, with col = lt mod S and row0 = lt / S,
// all in one column, so a pass over the TU's columns loads each matrix
// entry once for all of them.
template <int S, int G>
struct Map {
  static constexpr int kK = S * S >= G ? S * S / G : 1;
  static constexpr int kStep = G / S;
  static constexpr int kLog2 = ilog2(S);
};

// A column pass, out[k] = sum_j W(row_k, j) * in[j][col], W(r, j) =
// t[r * S + j] (forward vertical) or t[j * S + r] (inverse vertical,
// kTrans); in from `in` (int, pitch S) or, kLev, the dequantized staged
// levels lev (pitch sp); j < kJ (a 64-TU's inverse: its rows from 32 on
// are zero).  A 64-TU's j loop (32 samples a thread) is unrolled four
// steps at a time, which keeps the CU-64 instances' code and nvcc's time
// down.
template <int S, int K, int kStep, bool kTrans, bool kLev>
__device__ __forceinline__ void column_step(int j, int row0, int col,
                                            const int8_t* t, const int* in,
                                            const int16_t* lev, int sp,
                                            int dscale, int ishift,
                                            int (&out)[K]) {
  const int v =
      kLev ? clampi((lev[j * sp + col] * dscale + (1 << (ishift - 1))) >>
                        ishift, -32768, 32767)
           : in[j * S + col];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = row0 + k * kStep;
    out[k] += t[kTrans ? j * S + r : r * S + j] * v;
  }
}

template <int S, int K, int kStep, bool kTrans, bool kLev, int kJ = S>
__device__ __forceinline__ void column_pass(int row0, int col,
                                            const int8_t* t, const int* in,
                                            const int16_t* lev, int sp,
                                            int dscale, int ishift,
                                            int (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0;
  if constexpr (S <= 32) {
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      column_step<S, K, kStep, kTrans, kLev>(j, row0, col, t, in, lev, sp,
                                             dscale, ishift, out);
  } else {
#pragma unroll 4
    for (int j = 0; j < kJ; ++j)
      column_step<S, K, kStep, kTrans, kLev>(j, row0, col, t, in, lev, sp,
                                             dscale, ishift, out);
  }
}

// A row pass, out[k] = sum_j in[row_k][j] * t[j * S + col], the row's
// entries four at a time in 16-byte loads; j < kJ (a 64-TU's inverse: its
// columns from 32 on are zero), a 64-TU's loop unrolled two loads at a
// time.
template <int S, int K, int kStep>
__device__ __forceinline__ void row_step(int j, int row0, int col,
                                         const int8_t* t, const int* in,
                                         int (&out)[K]) {
  const int t0 = t[j * S + col], t1 = t[(j + 1) * S + col];
  const int t2 = t[(j + 2) * S + col], t3 = t[(j + 3) * S + col];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int4 v = *reinterpret_cast<const int4*>(
        in + (row0 + k * kStep) * S + j);
    out[k] += v.x * t0 + v.y * t1 + v.z * t2 + v.w * t3;
  }
}

template <int S, int K, int kStep, int kJ = S>
__device__ __forceinline__ void row_pass(int row0, int col, const int8_t* t,
                                         const int* in, int (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0;
  if constexpr (S <= 32) {
#pragma unroll
    for (int j = 0; j < kJ; j += 4)
      row_step<S, K, kStep>(j, row0, col, t, in, out);
  } else {
#pragma unroll 2
    for (int j = 0; j < kJ; j += 4)
      row_step<S, K, kStep>(j, row0, col, t, in, out);
  }
}

// ---- the TU-wide quantizers: sign-data hiding and dependent quantization
// (x266_tpu/kernels/quant.py:102-450; plain versions in kernels/quant.py)

// tu_scan (cabac/syntax.py): scan index i of a TU of side S is position
// kScan4[i & 15] of the 4x4 group at kScanCg[i >> 4] (diagonal orders,
// x | y << 4), the groups of a side-S TU at offset S/4 - 1 + ...  In
// global memory, read through the read-only cache: a warp's lanes read
// different entries, which the constant cache would serve one address at
// a time.
__device__ const uint8_t kScan4[16] = {0, 16, 1, 32, 17, 2, 48, 33,
                                       18, 3, 49, 34, 19, 50, 35, 51};
__device__ const uint8_t kScanCg[1 + 4 + 16 + 64] = {
    0,                                                      // 1x1
    0, 16, 1, 17,                                           // 2x2
    0, 16, 1, 32, 17, 2, 48, 33, 18, 3, 49, 34, 19, 50, 35, 51,   // 4x4
    0, 16, 1, 32, 17, 2, 48, 33, 18, 3, 64, 49, 34, 19, 4, 80,    // 8x8
    65, 50, 35, 20, 5, 96, 81, 66, 51, 36, 21, 6, 112, 97, 82, 67,
    52, 37, 22, 7, 113, 98, 83, 68, 53, 38, 23, 114, 99, 84, 69, 54,
    39, 115, 100, 85, 70, 55, 116, 101, 86, 71, 117, 102, 87, 118, 103,
    119};

// The raster index (y * S + x) of scan index i.
template <int S>
__device__ __forceinline__ int scan_raster(int i) {
  constexpr int base = S == 4 ? 0 : S == 8 ? 1 : S == 16 ? 5 : 21;
  const int g = __ldg(kScanCg + base + (i >> 4));
  const int e = __ldg(kScan4 + (i & 15));
  return ((g >> 4) * 4 + (e >> 4)) * S + (g & 15) * 4 + (e & 15);
}

// A TU's quantizer constants, read from Params once and passed by value
// (in registers): its QP's and size's scales and shifts, RDOQ, lambda,
// and the rate table (levels 0-255 in shared memory).
struct QuantArgs {
  int qbits, qscale, dscale, ishift, rdoq;
  float err_scale, lam;
  const float* rate_sh;
  const float* rate;
};

template <typename Sh>
__device__ __forceinline__ QuantArgs quant_args(const Params& p,
                                                const Sh& sh, int tsh) {
  return QuantArgs{14 + p.qp / 6 + tsh, kQuantScale[p.qp % 6],
                   kDequantScale[p.qp % 6] << (p.qp / 6), 6 - tsh, p.rdoq,
                   ldexpf(1.0f, -2 * tsh), p.lam, sh.rate, p.rate};
}

// RDOQ's rate of level l (0 <= l <= 32767): one generic load from the
// shared or the global table, no branch (so the compiler interleaves a
// thread's positions).
__device__ __forceinline__ float rate_q(const QuantArgs& q, int l) {
  return *(l < kRateShared ? q.rate_sh + l : q.rate + l);
}

// RDOQ's cost of level l (>= 0) whose dequantized value misses the
// coefficient by e: e*e*err_scale + lam*rate.
__device__ __forceinline__ float rd_cost(const QuantArgs& q, int e, int l) {
  const float x = (float)e;
  return __fadd_rn(__fmul_rn(__fmul_rn(x, x), q.err_scale),
                   __fmul_rn(q.lam, rate_q(q, l)));
}

// The level of |coefficient| aa: RDOQ (the level of {0, l_dn, l_up} of
// least rd_cost) or the deadzone one.
__device__ __forceinline__ int quant_level(const QuantArgs& q, int aa) {
  if (q.rdoq) {
    const int lup = clampi((aa * q.qscale + (1 << (q.qbits - 1))) >> q.qbits,
                           0, 32767);
    const int ldn = lup > 0 ? lup - 1 : 0;
    auto cost = [&](int l) {
      const int d = clampi((l * q.dscale + (1 << (q.ishift - 1))) >> q.ishift,
                           -32768, 32767);
      return rd_cost(q, aa - d, l);
    };
    const float c0 = cost(0), cd = cost(ldn), cu = cost(lup);
    const int lbest = cu <= cd ? lup : ldn;
    return fminf(cu, cd) <= c0 ? lbest : 0;
  }
  const int add = 171 << (q.qbits - 9);
  return clampi((aa * q.qscale + add) >> q.qbits, 0, 32767);
}

constexpr int kSdhSpan = 4;
constexpr float kSdhBig = 3.4e38f;

// Sign-data hiding on a side-S TU on its G threads (lt), 16 lanes a 4x4
// group (scan order): each half of a warp takes a group, lane e its scan
// position e, so the group's threads take G / 16 groups at a time (a
// thread's groups, its passes, step by step together).  Each lane
// quantizes its coefficient (quant_level, from `coef`: raster, pitch S);
// the half's ballots give the group's first and last significant
// positions, the parity of its absolute sum (that of its odd levels'
// count) and the first one's sign.  Where those two are >= 4 apart and
// the sign disagrees with the parity, each lane prices its position's two
// moves (kSdhBig outside [first, last], for a move that zeroes an end or
// changes nothing; the -1 move on ties) and a 16-lane min of (delta,
// position) takes the first least one, as a scan from position 0 that
// keeps a strictly lesser delta (position 0 when every delta is kSdhBig).
// The levels into `lev` (raster, pitch S).
template <int S, int G>
__device__ __forceinline__ void sdh_tu(const QuantArgs q, int lt,
                                       const int* coef,
                                       int* lev X266_PH_PARAM) {
  constexpr int kGroups = S * S / 16, kAtOnce = G / 16;
  const int e = lt & 15, half = lt & 16;
  auto rdcost = [&](int l, int cc) {
    const int d = clampi((l * q.dscale + (1 << (q.ishift - 1))) >> q.ishift,
                         -32768, 32767);
    return rd_cost(q, d - cc, l < 0 ? -l : l);
  };
  // the thread's kP groups (passes), each step for all of them at once
  constexpr int kP = (kGroups + kAtOnce - 1) / kAtOnce;
  int r[kP], c[kP], v[kP], first[kP], last[kP];
  bool on[kP], hide[kP];
  bool any = false;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int cg = i * kAtOnce + (lt >> 4);
    on[i] = cg < kGroups;             // a 4x4 TU: lanes 16-31 have none
    r[i] = on[i] ? scan_raster<S>(cg * 16 + e) : 0;
    c[i] = on[i] ? coef[r[i]] : 0;
    const int m = quant_level(q, c[i] < 0 ? -c[i] : c[i]);
    v[i] = c[i] < 0 ? -m : (c[i] > 0 ? m : 0);
  }
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const unsigned nz = (__ballot_sync(kFull, v[i] != 0) >> half) & 0xffffu;
    const unsigned odd = (__ballot_sync(kFull, v[i] & 1) >> half) & 0xffffu;
    const unsigned neg = (__ballot_sync(kFull, v[i] < 0) >> half) & 0xffffu;
    first[i] = nz ? __ffs((int)nz) - 1 : -1;
    last[i] = nz ? 31 - __clz((int)nz) : -1;
    hide[i] = first[i] >= 0 && last[i] - first[i] >= kSdhSpan &&
              ((neg >> first[i]) & 1) != (unsigned)(__popc(odd) & 1);
    any = any || hide[i];
  }
  X266_PH(pc, kPhSdhLevels);
  if (__any_sync(kFull, any)) {
    float best[kP];
    int pos[kP], nvb[kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const float e0 = rdcost(v[i], c[i]);
      float dl[2];
      int nv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        nv[u] = clampi(v[i] + (u ? 1 : -1), -32767, 32767);
        const bool ok = e >= first[i] && e <= last[i] &&
                        !(nv[u] == 0 && (e == first[i] || e == last[i])) &&
                        nv[u] != v[i];
        dl[u] = ok ? __fsub_rn(rdcost(nv[u], c[i]), e0) : kSdhBig;
      }
      const int u = dl[1] < dl[0];
      best[i] = dl[u];
      pos[i] = e;
      nvb[i] = nv[u];
    }
#pragma unroll
    for (int d = 8; d >= 1; d >>= 1) {
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const float ob = __shfl_xor_sync(kFull, best[i], d);
        const int op = __shfl_xor_sync(kFull, pos[i], d);
        if (ob < best[i] || (ob == best[i] && op < pos[i])) {
          best[i] = ob;
          pos[i] = op;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kP; ++i)
      if (hide[i] && pos[i] == e) v[i] = nvb[i];
  }
#pragma unroll
  for (int i = 0; i < kP; ++i)
    if (on[i]) lev[r[i]] = v[i];
  X266_PH(pc, kPhSdhMoves);
}

// DQ: next state = (map >> 2 * state) & 3 for a level of parity 0 or 1
// (DQ_TRANS = [[0, 2], [2, 0], [1, 3], [3, 1]]), maps of four 2-bit
// images; kDqId the identity.
constexpr uint32_t kDqP0 = 0xD8u, kDqP1 = 0x72u, kDqId = 0xE4u;
constexpr float kDqBig = 3.0e38f;

__device__ __forceinline__ int dq_next(int s, int parity) {
  return ((parity ? kDqP1 : kDqP0) >> (2 * s)) & 3;
}

// The map of a then b.
__device__ __forceinline__ uint32_t dq_compose(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    r |= ((b >> (2 * ((a >> (2 * s)) & 3))) & 3) << (2 * s);
  return r;
}

// One position of the trellis: for quantizer q (states 0/1: 0, 2/3: 1)
// and parity p, the best level k[q][p] and its cost c[q][p] of the
// candidates {0, k_dn, k_up} (kDqBig where no candidate has the parity).
struct DqPos {
  float c[2][2];
  int k[2][2];
};

__device__ __forceinline__ DqPos dq_pos(const QuantArgs& q, int a) {
  DqPos r;
  const int u = (a * q.qscale + (1 << (q.qbits - 2))) >> (q.qbits - 1);
  // level 0's cost is both quantizers' (its dequantized value is 0)
  const float c0 = rd_cost(q, a, 0);
#pragma unroll
  for (int q1 = 0; q1 < 2; ++q1) {
    const int kup = clampi((u + q1 + 1) >> 1, 0, 32767);
    const int kdn = kup > 0 ? kup - 1 : 0;
    auto cost = [&](int k) {
      const int d = ((2 * k - (k > 0 ? q1 : 0)) * q.dscale +
                     (1 << q.ishift)) >> (q.ishift + 1);
      return rd_cost(q, a - d, k);
    };
    const float cu = cost(kup), cd = cost(kdn);
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const float cu_p = (kup & 1) == par ? cu : kDqBig;
      const float cd_p = (kdn & 1) == par ? cd : kDqBig;
      int kb = cu_p <= cd_p ? kup : kdn;
      float cb = fminf(cu_p, cd_p);
      if (par == 0) {
        if (c0 <= cb) kb = 0;
        cb = fminf(c0, cb);
      }
      r.c[q1][par] = cb;
      r.k[q1][par] = kb;
    }
  }
  return r;
}

// Entry i of v.
__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The position's (4, 4) (min,+) transition matrix as four rows, from its
// costs c[2 q + p] (DqPos.c[q][p]): M[s][next(s, p)] = c[s >= 2][p],
// kDqBig elsewhere.
__device__ __forceinline__ void dq_leaf(const float (&c)[4],
                                        float4 (&m)[4]) {
  float e[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) e[i] = kDqBig;
#pragma unroll
  for (int st = 0; st < 4; ++st)
#pragma unroll
    for (int par = 0; par < 2; ++par)
      e[st * 4 + dq_next(st, par)] = fminf(kDqBig, c[(st >= 2) * 2 + par]);
#pragma unroll
  for (int a = 0; a < 4; ++a)
    m[a] = float4{e[4 * a], e[4 * a + 1], e[4 * a + 2], e[4 * a + 3]};
}

// The product of two positions' matrices (dq_leaf's of the costs ca,
// cb) entry by entry from their structure: entry (i, c) has one path i ->
// x -> c through both, so its four sums are a + b on that path, A's other
// successor's a' + kDqBig, kDqBig + B's other predecessor's b', and
// kDqBig + kDqBig (inf, which the minimum never takes): the dense
// product's value from 24 of its 64 sums (a' + kDqBig and kDqBig + b'
// are four each).
__device__ __forceinline__ void dq_leaf_pair(const float (&ca)[4],
                                             const float (&cb)[4],
                                             float4 (&o)[4]) {
  float a[4], b[4], fa[4], fb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = fminf(kDqBig, ca[k]);
    b[k] = fminf(kDqBig, cb[k]);
    fa[k] = __fadd_rn(a[k], kDqBig);
    fb[k] = __fadd_rn(kDqBig, b[k]);
  }
  float e[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int px = 0, pb = 0, y = 0, py = 0;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int x = dq_next(i, p);
        if (dq_next(x, 0) == c || dq_next(x, 1) == c) {
          px = p;
          pb = dq_next(x, 0) == c ? 0 : 1;
        }
      }
      const int x = dq_next(i, px);
#pragma unroll
      for (int st = 0; st < 4; ++st)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (st != x && dq_next(st, p) == c) {
            y = st;
            py = p;
          }
      const int qi = i >= 2, qx = x >= 2, qy = y >= 2;
      e[i * 4 + c] = fminf(fminf(__fadd_rn(a[2 * qi + px], b[2 * qx + pb]),
                                 fa[2 * qi + 1 - px]),
                           fb[2 * qy + py]);
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = float4{e[4 * i], e[4 * i + 1], e[4 * i + 2], e[4 * i + 3]};
}

// (min,+) products on rows (rounding is monotonic, so the minima are
// exact in any order; each sum is the same two operands as the
// reference's): entry c of a row vector times a matrix, min_x v[x] +
// m[x][c]; entry a of a matrix times a vector of row minima, min_x
// m[a][x] + v[x] (= min_x min_c (A[a][x] + B[x][c])).
__device__ __forceinline__ float mp_vm(const float4& v, const float4 (&m)[4],
                                       int c) {
  float r = __fadd_rn(v.x, f4(m[0], c));
  r = fminf(r, __fadd_rn(v.y, f4(m[1], c)));
  r = fminf(r, __fadd_rn(v.z, f4(m[2], c)));
  return fminf(r, __fadd_rn(v.w, f4(m[3], c)));
}

__device__ __forceinline__ float mp_mv(const float4 (&m)[4], const float4& v,
                                       int a) {
  float r = __fadd_rn(m[a].x, v.x);
  r = fminf(r, __fadd_rn(m[a].y, v.y));
  r = fminf(r, __fadd_rn(m[a].z, v.z));
  return fminf(r, __fadd_rn(m[a].w, v.w));
}

__device__ __forceinline__ float4 mp_row(const float4& v,
                                         const float4 (&m)[4]) {
  return float4{mp_vm(v, m, 0), mp_vm(v, m, 1), mp_vm(v, m, 2),
                mp_vm(v, m, 3)};
}

__device__ __forceinline__ float4 mp_col(const float4 (&m)[4],
                                         const float4& v) {
  return float4{mp_mv(m, v, 0), mp_mv(m, v, 1), mp_mv(m, v, 2),
                mp_mv(m, v, 3)};
}

#ifdef X266_MUTATE_DQ_TIE
// tests only: argmin4 takes the last least index, which the host tests
// must catch
#define X266_DQ_LESS(x, m) ((x) <= (m))
#else
#define X266_DQ_LESS(x, m) ((x) < (m))
#endif

// The first index of the least v[b] + t[b] (tail false: of v[b]).
__device__ __forceinline__ int argmin4(const float4& v, const float4& t,
                                       bool tail) {
  int best = 0;
  float m = tail ? __fadd_rn(v.x, t.x) : v.x;
#pragma unroll
  for (int b = 1; b < 4; ++b) {
    const float x = tail ? __fadd_rn(f4(v, b), f4(t, b)) : f4(v, b);
    if (X266_DQ_LESS(x, m)) {
      m = x;
      best = b;
    }
  }
  return best;
}

#ifdef X266_MUTATE_DQ_WARP_SYNC
// tests only: the DQ trellis skips its warps' __syncwarp, which the host
// tests must catch
#define X266_DQ_SYNCWARP() ((void)0)
#else
#define X266_DQ_SYNCWARP() __syncwarp()
#endif

// Dependent quantization of a side-S TU on its G threads (lt): the exact
// 4-state trellis of quant.py's dq_quantize_trellis over the coefficients
// `coef` (raster, pitch S) in coding order (the reverse scan), the levels
// into `lev` (raster).  The (min,+) products follow the tree of
// jax.lax.associative_scan: level 1 pairs positions, level l + 1 pairs
// level l's nodes; a node's prefix row 0 is, for the first node of a
// level, its own row 0, for an odd node its parent's, for an even one its
// parent's left neighbour's times the node; its suffix row minima, for
// the last node, its own, for an even node its parent's, for an odd one
// the node times its right neighbour's parent's.  So the first node of
// any subtree has its root's suffix and the last its root's prefix, and a
// subtree needs from outside only its root's rows and its neighbours'.
// The schedule (DqShape):
// - a thread prices its R positions once (DqPos, in registers) and
//   multiplies its subtree up to level h in registers (its leaf pairs by
//   dq_leaf_pair);
// - each warp multiplies its levels h+1 .. hw, a lane a row, between
//   __syncwarp (the nodes in the scratch table);
// - one barrier of the group; then each warp multiplies the levels above
//   hw and walks them down into its own copy of their rows, then its
//   levels hw-1 .. h, a lane a node, a neighbour warp's top rows for a
//   parent outside its run;
// - a thread walks its subtree down in registers and reads each of its
//   positions' state after it (argmin of the prefix row 0 + the next
//   position's suffix row minima, first on ties), the state before it,
//   and so its quantizer, parity and level.
// Every entry is the reference's float32 sum of the same two operands.
// Each position's coefficient in `coef` is replaced by its level's
// dequantized value under the trellis's state before it: dq_dequantize's
// value wherever the emitted levels' parities walk the trellis's states,
// which the thread returns (true: each of its levels' parities leads
// from the state before it to the state after it; a zero coefficient
// emits level 0 whatever level its step took).  `scratch`: the group's DQ
// scratch.  Ends before the caller's barrier.
template <int S, int G>
__device__ X266_NOINLINE bool dq_trellis(const QuantArgs q, const Group& g,
                                         bool small, int lt, int* coef,
                                         int* lev,
                                         float* scratch X266_PH_PARAM) {
  using D = DqShape<S, G>;
  constexpr int n = D::n, L = D::L, T = D::T, R = D::R, h = D::h;
  constexpr int Wn = D::Wn, TW = D::TW, hw = D::hw;
  constexpr int kTab = D::kTab, kVec = D::kVec, kX = D::kCross;
  float4* tab = reinterpret_cast<float4*>(scratch);
  float4* loc = tab + 4 * kTab;
  float4* vec = loc + 4 * D::kLoc * T;
  const int t = lt, w = lt >> 5, lane = lt & 31;
  float4* top = vec + 2 * kVec + w * D::kTop;    // this warp's
  const bool own = t < T;                        // holds positions
  // the vectors that make a first node's prefix row 0 its own row 0
  // (mp_row(kRow0, m) = m[0]) and a last node's suffix row minima its own
  // (mp_col(m, kMins)): x + 0 = x and inf + x = inf for every entry here
  const float4 kRow0{0.0f, INFINITY, INFINITY, INFINITY};
  const float4 kMins{0.0f, 0.0f, 0.0f, 0.0f};
  auto pos = [&](int j) { return scan_raster<S>(n - 1 - j); };
  // row a of node b of level l: the table (h..hw), this warp's copy above
  auto node = [&](int l, int b, int a) -> float4& {
    return l <= hw ? tab[a * kTab + D::nodes(h, l) + b]
                   : top[a * kX + D::nodes(hw + 1, l) + b];
  };
  // prefix row 0 and suffix row minima of node b of level l: vec (h ..
  // hw-1), this warp's copy (hw .. L)
  auto pre = [&](int l, int b) -> float4& {
    return l < hw ? vec[D::nodes(h, l) + b]
                  : top[4 * kX + D::nodes(hw, l) + b];
  };
  auto suf = [&](int l, int b) -> float4& {
    return l < hw ? vec[kVec + D::nodes(h, l) + b]
                  : top[4 * kX + D::kTopRows + D::nodes(hw, l) + b];
  };

  // up: the thread's positions and subtree
  float cst[R][4];
  uint32_t kk[R][2];         // levels k[q][0] | k[q][1] << 16
  if (own) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = coef[pos(t * R + j)];
      const DqPos d = dq_pos(q, c < 0 ? -c : c);
#pragma unroll
      for (int q1 = 0; q1 < 2; ++q1) {
        cst[j][2 * q1] = d.c[q1][0];
        cst[j][2 * q1 + 1] = d.c[q1][1];
        kk[j][q1] = (uint32_t)d.k[q1][0] | (uint32_t)d.k[q1][1] << 16;
      }
    }
    if constexpr (h == 0) {
      float4 m[4];
      dq_leaf(cst[0], m);
#pragma unroll
      for (int a = 0; a < 4; ++a) node(0, t, a) = m[a];
    } else {
      float4 m[R / 2][4];
#pragma unroll
      for (int l = 1; l <= h; ++l) {
#pragma unroll
        for (int i = 0; i < (R >> l); ++i) {
          float4 o[4];
          if (l == 1) {
            dq_leaf_pair(cst[2 * i], cst[2 * i + 1], o);
          } else {
#pragma unroll
            for (int a = 0; a < 4; ++a)
              o[a] = mp_row(m[2 * i][a], m[2 * i + 1]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            m[i][a] = o[a];
            if (l == h) node(h, t, a) = o[a];
            else loc[((R - (R >> (l - 1)) + i) * 4 + a) * T + t] = o[a];
          }
        }
      }
    }
  }
  X266_PH(pc, kPhDqOwnUp);
  // up: the warp's levels h+1 .. hw
#pragma unroll
  for (int l = h + 1; l <= hw; ++l) {
    X266_DQ_SYNCWARP();
    constexpr int kPer = TW * R;                  // the warp's positions
    const int cw = kPer >> l;
    for (int r = lane; r < 4 * cw; r += 32) {
      const int b = w * cw + (r >> 2), a = r & 3;
      float4 y[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) y[x] = node(l - 1, 2 * b + 1, x);
      node(l, b, a) = mp_row(node(l - 1, 2 * b, a), y);
    }
  }
  group_sync(g, small);      // every warp's top node in the table
  // up: the levels above hw, each warp its own copy
#pragma unroll
  for (int l = hw + 1; l <= L; ++l) {
    if (lane < 4 * (n >> l)) {
      const int b = lane >> 2, a = lane & 3;
      float4 y[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) y[x] = node(l - 1, 2 * b + 1, x);
      node(l, b, a) = mp_row(node(l - 1, 2 * b, a), y);
    }
    X266_DQ_SYNCWARP();
  }
  X266_PH(pc, kPhDqUp);
  // down: the rows of levels L .. hw (this warp's copy), then of the
  // warp's levels hw-1 .. h; a lane a node, its prefix row 0 and suffix
  // row minima
#pragma unroll
  for (int l = L; l >= h; --l) {
    const int nl = n >> l;
    const int cw = l >= hw ? nl : (TW * R) >> l;  // the nodes walked
    const int b0 = l >= hw ? 0 : w * cw;          // the first of them
    if (lane < cw) {
      const int b = b0 + lane;
      float4 m[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) m[x] = node(l, b, x);
      // the parent level's rows (prefix (b - 1) / 2, suffix (b + 1) / 2);
      // below hw, outside the warp's run, the neighbour warp's top's
      const int kp = (b - 1) >> 1, ks = (b + 1) >> 1;
      const bool in_p = l + 1 >= hw || kp >= b0 / 2;
      const bool in_s = l + 1 >= hw || ks < (b0 + cw) / 2;
      const float4 up_p = b == 0 ? kRow0 : in_p ? pre(l + 1, kp)
                                                : pre(hw, w - 1);
      const float4 up_s = b == nl - 1 ? kMins : in_s ? suf(l + 1, ks)
                                                     : suf(hw, w + 1);
      pre(l, b) = (b & 1) ? up_p : mp_row(up_p, m);
      suf(l, b) = (b & 1) || b == nl - 1 ? mp_col(m, up_s) : up_s;
    }
    X266_DQ_SYNCWARP();
  }
  X266_PH(pc, kPhDqDown);
  if (!own) return true;
  // down: the thread's subtree, from its node's rows and its neighbours'
  const float4 po = pre(h, t), so = suf(h, t);
  const float4 pl = t == 0 ? po : t % TW == 0 ? pre(hw, w - 1)
                                              : pre(h, t - 1);
  const float4 sr = t == T - 1 ? so : t % TW == TW - 1 ? suf(hw, w + 1)
                                                       : suf(h, t + 1);
  int sig[R + 1];            // the state before each position, then after
  sig[0] = t == 0 ? 0 : argmin4(pl, so, true);
  if constexpr (R == 1) {
    sig[1] = argmin4(po, sr, t != T - 1);
  } else {
    float4 pp[R / 2], ps[R / 2];      // level l + 1's rows, then level l's
    pp[0] = po;
    ps[0] = so;
#pragma unroll
    for (int l = h - 1; l >= 1; --l) {
      const int cnt = R >> l;
      float4 np[R / 2], ns[R / 2];
#pragma unroll
      for (int i = 0; i < cnt; ++i) {
        float4 m[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          m[a] = loc[((R - (R >> (l - 1)) + i) * 4 + a) * T + t];
        const int gb = t * cnt + i;
        if (i & 1) {
          np[i] = pp[i >> 1];
          ns[i] = mp_col(m, gb == (n >> l) - 1 ? kMins
                            : i == cnt - 1     ? sr
                                               : ps[(i + 1) >> 1]);
        } else {
          np[i] = mp_row(gb == 0 ? kRow0 : i == 0 ? pl : pp[i / 2 - 1], m);
          ns[i] = ps[i >> 1];
        }
      }
#pragma unroll
      for (int i = 0; i < cnt; ++i) {
        pp[i] = np[i];
        ps[i] = ns[i];
      }
    }
    // level 0: position 2i's prefix and 2i+1's suffix from the leaves
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      float4 m0[4], m1[4];
      dq_leaf(cst[2 * i], m0);
      dq_leaf(cst[2 * i + 1], m1);
      const int j0 = t * R + 2 * i;
      const float4 a0 =
          mp_row(j0 == 0 ? kRow0 : i == 0 ? pl : pp[i - 1], m0);
      const float4 nx = i + 1 == R / 2 ? sr : ps[i + 1];
      const float4 b1 = mp_col(m1, j0 + 1 == n - 1 ? kMins : nx);
      sig[2 * i + 1] = argmin4(a0, b1, true);
      sig[2 * i + 2] = argmin4(pp[i], nx, j0 + 2 != n);
    }
  }
  bool path = true;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int before = sig[j], after = sig[j + 1];
    const uint32_t kq = before >= 2 ? kk[j][1] : kk[j][0];
    const int k = (kq >> (dq_next(before, 1) == after ? 16 : 0)) & 0xffff;
    const int r = pos(t * R + j);
    const int c = coef[r];
    // the level emitted: 0 where the coefficient is (whatever k the path
    // took there), so its parity may leave the path
    const int e = c != 0 ? k : 0;
    lev[r] = c < 0 ? -e : e;
    // dq_dequantize's value, with the trellis's state before the position
    path = path && dq_next(before, e & 1) == after;
    const int mag = ((2 * e - (e > 0 && before >= 2 ? 1 : 0)) * q.dscale +
                     (1 << q.ishift)) >> (q.ishift + 1);
    const int v = mag < 32767 ? mag : 32767;
    coef[r] = c < 0 ? -v : v;
  }
  X266_PH(pc, kPhDqOwnDown);
  return path;
}

// Dependent dequantization of a side-S TU's levels `lev` (raster, pitch
// `pitch`) on its G threads: each position's state from the parities of
// the levels before it in coding order (thread lt composes the maps of
// positions lt*C .. lt*C + C - 1, a warp scan and the warps' totals give
// its start state), then sgn(k) * min(((2|k| - q1) * dscale + 2^ishift)
// >> (ishift + 1), 32767) with q1 = state >= 2, into `out` (raster, pitch
// S).  Ends with the group's barrier.
template <int S, int G, typename T>
__device__ X266_NOINLINE void dq_dequant(Shared& sh, const Group& g,
                                         bool small, int lt, int plane,
                                         const T* lev, int pitch, int* out,
                                         int dscale, int ishift) {
  uint32_t* tot = reinterpret_cast<uint32_t*>(
                      reinterpret_cast<float*>(&sh + 1) + kDqTot) +
                  4 * plane;
  constexpr int n = S * S, C = n >= G ? n / G : 1;
  // the thread's positions lt*C .. lt*C + C - 1: raster index, level, and
  // the map of their parities (each start state walked through them)
  int r[C], k[C];
  uint32_t m = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lt * C + c;
    r[c] = j < n ? scan_raster<S>(n - 1 - j) : 0;
    k[c] = j < n ? (int)lev[(r[c] / S) * pitch + (r[c] & (S - 1))] : 0;
  }
#pragma unroll
  for (int s0 = 0; s0 < 4; ++s0) {
    int s = s0;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (lt * C + c < n) s = dq_next(s, k[c] & 1);
    m |= (uint32_t)s << (2 * s0);
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const uint32_t o = __shfl_up_sync(kFull, m, d);
    if (lane >= d) m = dq_compose(o, m);
  }
  uint32_t ex = __shfl_up_sync(kFull, m, 1);
  if (lane == 0) ex = kDqId;
  if (G > 32) {
    const int w = lt >> 5;
    if (lane == 31) tot[w] = m;
    group_sync(g, small);
    uint32_t pre = kDqId;
    for (int q = 0; q < w; ++q) pre = dq_compose(pre, tot[q]);
    ex = dq_compose(pre, ex);
  }
  int s = ex & 3;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (lt * C + c >= n) continue;
    const int a = k[c] < 0 ? -k[c] : k[c];
    const int mag = ((2 * a - (a > 0 && s >= 2 ? 1 : 0)) * dscale +
                     (1 << ishift)) >> (ishift + 1);
    const int v = mag < 32767 ? mag : 32767;
    out[r[c]] = k[c] < 0 ? -v : (k[c] > 0 ? v : 0);
    s = dq_next(s, a & 1);
  }
  group_sync(g, small);
}

// A plane group's DQ scratch (kDqBytes after Shared, DQ instances only).
__device__ __forceinline__ float* dq_scratch(Shared& sh, int plane) {
  return reinterpret_cast<float*>(&sh + 1) +
         (plane == 0 ? 0 : kDqLuma + (plane - 1) * kDqChroma);
}

// Dependent quantization of a side-S TU on its G threads: the trellis's
// levels (coefficients `a` in, dequantized values out; levels into `b`),
// each dequantized value under the trellis's state, or where a level's
// parity leaves the trellis's path in the TU, under the parities' states
// (dq_dequant).  Ends with the group's barrier.
template <int S, int G>
__device__ __forceinline__ void dq_quantize(const QuantArgs& q, Shared& sh,
                                            const Group& g, bool small,
                                            int lt, int plane, int* a,
                                            int* b X266_PH_PARAM) {
  const bool path = dq_trellis<S, G>(q, g, small, lt, a, b,
                                     dq_scratch(sh, plane) X266_PH_PASS);
  const bool fallback = group_any(g, small, !path);
  // the phase split counts the TUs that fall back, by plane
  X266_PH_COUNT(12 + plane, fallback && lt == 0);
  if (fallback)
    dq_dequant<S, G>(sh, g, small, lt, plane, b, S, a, q.dscale, q.ishift);
}

// The arguments of one TU: plane coords (x, y) of a CU of the CTU at plane
// origin (x0, y0) (its inputs are staged at (x - x0, y - y0), row pitch 64
// luma, 32 chroma), its mode, prediction shift, transform types,
// transform skip, kind, whether its staged levels are non-zero (decode),
// whether the group meets first (a small TU came just before), its
// substitution sources (nullptr without substitution), its LFNST (Cu::lf),
// its frame, and under CCLM its CU's index in the CTU's list, the CTU's
// mbarrier parity and the CU's mts map value.
template <typename Src>
struct TuArgs {
  int x, y, x0, y0, mode, shift, tv, th, lf;
  bool ts;
  int kind;
  bool nz, sync_first;
  const Src* src;
  int f;
  int cu, par, mval;
};

#ifdef X266_MUTATE_CCLM_WAIT
// tests only: the chroma groups skip their wait on the luma group, which
// the host tests must catch
#define X266_CCLM_WAIT_ON false
#else
#define X266_CCLM_WAIT_ON true
#endif

// CCLM on a chroma TU of side S (plane v.plane, on G threads), after its
// DM prediction pr: K2 takes the model where the stream's bit 3 says so;
// K1 where the joint Cb + Cr SSE of the model against the source is
// strictly below DM's, writing the choice over the CU's units of the mts
// map out.  The luma view is the CTU's window, with the row two above it
// and the column two to its left beside it.
template <bool kEncode, int S, int G, typename Sh, typename A>
__device__ __forceinline__ void cclm(const Params& p, Sh& sh,
                                     const View& v, const A& a,
                                     bool active, int lt, int row0, int col,
                                     int st, int (&pr)[Map<S, G>::kK]) {
  using M = Map<S, G>;
  constexpr int K = M::kK, kStep = M::kStep;
  constexpr bool kSmall = S * S <= 64;
  bool use = ((a.mval >> 3) & 1) != 0;
  if (!kEncode && !use) return;
  if (X266_CCLM_WAIT_ON) x266_mbar_wait(&sh.cc_bar[a.cu], a.par);
  const int lx0 = 2 * a.x0, ly0 = 2 * a.y0;   // the CTU's luma origin
  const View vy{sh.win_y, Sh::kWinY, Sh::kPitchY, lx0 - 1, ly0 - 1, p.width,
                p.height, 1, 0};
  auto lum = [&](int px, int py) -> int {
    if (py == ly0 - 2) return sh.cc_row[px - lx0];
    if (px == lx0 - 2) return sh.cc_col[py - ly0];
    return at(vy, px, py);
  };
  auto pair = [&](int px, int py) {
    return (lum(px, py) + lum(px + 1, py) + lum(px, py + 1) +
            lum(px + 1, py + 1) + 2) >> 2;
  };
  const int xc = a.x, yc = a.y;
  constexpr int d0 = S / 4, d1 = (3 * S) / 4;
  const int cl[4] = {pair(2 * (xc + d0), 2 * yc - 2),
                     pair(2 * (xc + d1), 2 * yc - 2),
                     pair(2 * xc - 2, 2 * (yc + d0)),
                     pair(2 * xc - 2, 2 * (yc + d1))};
  const int cc[4] = {at(v, xc + d0, yc - 1), at(v, xc + d1, yc - 1),
                     at(v, xc - 1, yc + d0), at(v, xc - 1, yc + d1)};
  int imin = 0, imax = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (cl[i] < cl[imin]) imin = i;
    if (cl[i] > cl[imax]) imax = i;
  }
  const int num = (cc[imax] - cc[imin]) * 64;
  const int den = cl[imax] - cl[imin] > 1 ? cl[imax] - cl[imin] : 1;
  const int quo = num / den - (num % den != 0 && num < 0);   // floored
  const int alpha = clampi(quo, -512, 511);
  const int beta = cc[imin] - ((alpha * cl[imin] + 32) >> 6);
  int cp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int rr = row0 + k * kStep;
    const int px = 2 * (xc + col), py = 2 * (yc + rr);
    const int ds = active ? (at(vy, px, py) + at(vy, px + 1, py) +
                             at(vy, px, py + 1) + at(vy, px + 1, py + 1) +
                             2) >> 2
                          : 0;
    cp[k] = clampi(((alpha * ds + 32) >> 6) + beta, 0, 255);
  }
  if constexpr (kEncode) {
    int ecc = 0, edm = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!active) continue;
      const int o = sh.in.src[st + (row0 + k * kStep) * 32 + col];
      ecc += (cp[k] - o) * (cp[k] - o);
      edm += (pr[k] - o) * (pr[k] - o);
    }
    ecc = (int)__reduce_add_sync(kFull, (unsigned)ecc);
    edm = (int)__reduce_add_sync(kFull, (unsigned)edm);
    int(*x)[2][2] = sh.cc_sse[a.cu & 1];
    if ((lt & 31) == 0) {
      x[v.plane - 1][lt >> 5][0] = ecc;
      x[v.plane - 1][lt >> 5][1] = edm;
    }
    // Cb and Cr meet: warp 0 of each group, or both groups
    x266_bar_sync(kSmall ? 4 : 5, kSmall ? 64 : 128);
    int tcc = 0, tdm = 0;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int w = 0; w < G / 32; ++w) {
        tcc += x[pl][w][0];
        tdm += x[pl][w][1];
      }
    use = tcc < tdm;
    if (v.plane == 1 && lt == 0) {
      const int ux_n = p.width / 8, uy_n = p.height / 8, u = S / 4;
      const int ux = mini(xc / 4, ux_n - u), uy = mini(yc / 4, uy_n - u);
      int32_t* m = p.mts_out + (size_t)a.f * ux_n * uy_n;
      for (int dy = 0; dy < u; ++dy)
        for (int dx = 0; dx < u; ++dx)
          m[(uy + dy) * ux_n + ux + dx] = (a.mval & 7) | (use << 3);
    }
  }
  if (use) {
#pragma unroll
    for (int k = 0; k < K; ++k) pr[k] = cp[k];
  }
}

// LFNST (x266_tpu/kernels/lfnst.py:81-105) on the low 4x4 of a TU: entry
// vi of the 16x16 kernel of lf (Cu::lf) times the vector vec, or of its
// transpose for the inverse, rounded at 1 << 7 and clipped: exact int32
// (|m| <= 127, |v| <= 2^15).  The thread owning coefficient (r, c) of the
// low 4x4 computes entry vi = r * 4 + c, or c * 4 + r where the mode
// transposes the region.
__device__ __forceinline__ int lfnst_index(int lf, int r, int c) {
  return (lf & 1) ? c * 4 + r : r * 4 + c;
}

template <typename Sh>
__device__ __forceinline__ int lfnst_entry(const Sh& sh, int lf,
                                           bool inverse, const int* vec,
                                           int vi) {
  const int8_t* m = sh.lfnst[inverse] + ((lf >> 1) & 7) * 256 + vi * 16;
  int acc = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) acc += m[j] * vec[j];
  return clampi((acc + 64) >> 7, -32768, 32767);
}

// The inverse LFNST in place on the dequantized coefficients a (raster,
// pitch S) of a TU's threads; thread (row0, col) of the first sample row
// block owns entry (row0, col).  Starts after a barrier over a's writes
// and ends with one.
template <int S, typename Sh>
__device__ X266_NOINLINE void lfnst_inverse(const Sh& sh, const Group& g,
                                            bool small, int lf, int row0,
                                            int col, int* a) {
  const bool low = row0 < 4 && col < 4;
  int out = 0;
  if (low) {
    int vec[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      vec[j] = (lf & 1) ? a[(j & 3) * S + (j >> 2)] : a[(j >> 2) * S + (j & 3)];
    out = lfnst_entry(sh, lf, true, vec, lfnst_index(lf, row0, col));
  }
  group_sync(g, small);
  if (low) a[row0 * S + col] = out;
  group_sync(g, small);
}

// One TU of side S of plane v.plane, on G threads: the group (a TU of more
// than 64 samples) or the group's warp 0 (G = 32; the caller keeps the
// other warps out).  A 64-TU (CU-64 instances, on the luma group: 32
// samples a thread, two rows apart) codes only its low 32x32 band (the
// zero-out, x266_tpu/kernels/transforms.py:90-97): the forward vertical
// pass makes rows 0-31, the horizontal one their columns 0-31, the others
// quantize to 0; the inverse sums over those 32 rows and columns only.  It
// takes no LFNST or transform skip (its mts map value is 0), and its
// angular taps are loaded as its prediction reads them.

template <bool kEncode, int S, int G, int kQ, bool kMl, bool kCc,
          typename Sh, typename A>
__device__ void tu(const Params& p, Sh& sh, const View& v,
                   const Group& g, const A& a) {
  using M = Map<S, G>;
  constexpr int K = M::kK, kStep = M::kStep, kLog2 = M::kLog2;
  constexpr bool kSmall = S * S <= 64;
  constexpr bool k64 = S == 64;
  // a 64-TU's rows 0-31 are its samples k < kBand; its coded band
  // (rows and columns 0-31) is 32 wide
  constexpr int kBand = k64 ? K / 2 : K, kZo = k64 ? 32 : S;
  static_assert(!kSmall || G == 32, "a TU of <= 64 samples is one warp's");
  const int x = a.x, y = a.y, mode = a.mode;
  const int lt = kSmall ? (threadIdx.x & 31) : g.lt;
  const int col = lt & (S - 1), row0 = lt >> kLog2;
  // every thread owns samples but on a 4x4 TU (lanes 16-31 own none)
  const bool active = G <= S * S || row0 < S;
  const bool luma = v.plane == 0;
  const bool is_mc = a.kind != kIntra;
  const bool skip = a.kind == kSkip;
  const bool mip = !is_mc && mode >= p.n_std;   // luma only
  const int sp = luma ? 64 : 32;
  const int st = (luma ? 0 : v.plane == 1 ? 4096 : 5120) + (y - a.y0) * sp +
                 (x - a.x0);                  // staged (0, 0)
  int* sa = luma ? sh.a_y : sh.a_c[v.plane - 1];
  int* sb = luma ? sh.b_y : sh.b_c[v.plane - 1];
  auto& r = sh.refs[threadIdx.x >> 5];
  X266_PH_START(pc, (v.plane * 4 + size_index(S)) * kPhases, g.lt == 0);
  X266_PH_COUNT(v.plane * 4 + size_index(S), g.lt == 0);

  // the angular taps of this thread's samples, in flight while the
  // reference vector is built
  const bool taps = !is_mc && !mip && mode != 1;
  const int4* t4 = reinterpret_cast<const int4*>(
      p.taps + taps_offset(S, p.n_std)) + mode * S * S;
  int4 tp[k64 ? 1 : K];
  if constexpr (!k64) {
    if (taps && active) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        tp[k] = x266_ldg_early(t4 + (row0 + k * kStep) * S + col);
    }
  }
  if (a.sync_first) group_sync(g, false);
  int dc = 0;
  if (!is_mc)
    dc = build_refs<S>(sh, v, r, x, y, mode, mip, a.src X266_PH_PASS);

  // the prediction, in registers until the write-back: one branch-free
  // loop over the thread's samples for each kind of prediction
  const int hm = p.n_std == 35 ? 10 : 18, vm = p.n_std == 35 ? 26 : 50;
  int pr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) pr[k] = 0;
  if (!active) {
  } else if (is_mc) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      pr[k] = sh.mcp[st + (row0 + k * kStep) * sp + col];
  } else if (mip) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int4* m4 = reinterpret_cast<const int4*>(
          p.mip + mip_offset(S) +
          ((mode - p.n_std) * S * S + (row0 + k * kStep) * S + col) * 16);
      int acc = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 wq = __ldg(m4 + q);
        acc += wq.x * r.grp[4 * q] + wq.y * r.grp[4 * q + 1] +
               wq.z * r.grp[4 * q + 2] + wq.w * r.grp[4 * q + 3];
      }
      pr[k] = rshift_round(acc, a.shift);
    }
  } else if (mode == 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) pr[k] = rshift_round(dc, a.shift);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int4 e;
      if constexpr (k64) e = __ldg(t4 + (row0 + k * kStep) * S + col);
      else e = tp[k];
      pr[k] = rshift_round(
          (e.x & 255) * r.ext[e.x >> 8] + (e.y & 255) * r.ext[e.y >> 8] +
              (e.z & 255) * r.ext[e.z >> 8] + (e.w & 255) * r.ext[e.w >> 8],
          a.shift);
    }
  }
  // PDPC's blend with the raw references, after the shift
  if (active && p.pdpc && luma && !is_mc &&
      (mode <= 1 || mode == hm || mode == vm)) {
    constexpr int pscale = (2 * kLog2 - 2) >> 2;
    const int lok = x > 0, tok = y > 0;
    const int wl = (32 >> mini(31, (2 * col) >> pscale)) * lok;
    const int top = r.ext[1 + col], corner = r.ext[0];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int rr = row0 + k * kStep;
      const int wt = (32 >> mini(31, (2 * rr) >> pscale)) * tok;
      const int left = r.ext[2 * S + 1 + rr];
      int q = pr[k];
      if (mode <= 1)
        q = (wl * left + wt * top + (64 - wl - wt) * q + 32) >> 6;
      else if (lok && tok && mode == vm)
        q = (64 * q + wl * (left - corner) + 32) >> 6;
      else if (lok && tok)
        q = (64 * q + wt * (top - corner) + 32) >> 6;
      pr[k] = q;
    }
  }
  if constexpr (kCc)
    if (!luma) cclm<kEncode, S, G>(p, sh, v, a, active, lt, row0, col, st, pr);
  X266_PH(pc, kPhPred);

  const int cpitch = p.width / v.scale;
  int16_t* co = kEncode ? p.coef_out[v.plane] +
                              (size_t)a.f * cpitch * (p.height / v.scale) +
                              (size_t)y * cpitch + x
                        : nullptr;
  constexpr int tsh = 7 - kLog2;               // 8-bit
  constexpr int ishift = 6 - tsh;
  const int dscale = kDequantScale[p.qp % 6] << (p.qp / 6);
  const int8_t* tvm = sh.tx[0] + a.tv * kTxPerType + tx_offset(S);
  const int8_t* thm = sh.tx[0] + a.th * kTxPerType + tx_offset(S);
  int res[K], acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) res[k] = 0;
  bool inverse = false;
  const int16_t* lev = nullptr;

  if (p.lossless) {
    // no transform, no quantizer: the level is the residual
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!active) continue;
      const int rr = row0 + k * kStep;
      if (kEncode) {
        res[k] = skip ? 0 : sh.in.src[st + rr * sp + col] - pr[k];
        co[(size_t)rr * cpitch + col] = (int16_t)res[k];
      } else {
        res[k] = sh.in.lev[st + rr * sp + col];
      }
    }
  } else if (kEncode && skip) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (active) co[(size_t)(row0 + k * kStep) * cpitch + col] = 0;
  } else if (kEncode) {
    int c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c[k] = 0;
      if (!active) continue;
      const int rr = row0 + k * kStep;
      const int res0 = sh.in.src[st + rr * sp + col] - pr[k];
      if (a.ts) c[k] = res0 << tsh;
      else sa[rr * S + col] = res0;
    }
    if (!a.ts) {
      group_sync(g, kSmall);
      // forward vertical: b[k][m] = sum_j Tv[k][j] a[j][m] (a 64-TU: rows
      // k < 32)
      if (active) {
        int fa[kBand];
        column_pass<S, kBand, kStep, false, false>(row0, col, tvm, sa,
                                                   nullptr, 0, 0, 1, fa);
#pragma unroll
        for (int k = 0; k < kBand; ++k)
          sb[(row0 + k * kStep) * S + col] = rshift_round(fa[k], kLog2 - 1);
      }
      group_sync(g, kSmall);
      X266_PH(pc, kPhFwd);
      // forward horizontal: c[k][l] = sum_j b[k][j] Th[l][j] (a 64-TU:
      // columns l < 32 of those rows)
      if (active && col < kZo) {
        int fa[kBand];
        row_pass<S, kBand, kStep>(
            row0, col, sh.tx[1] + a.th * kTxPerType + tx_offset(S), sb, fa);
#pragma unroll
        for (int k = 0; k < kBand; ++k)
          c[k] = clampi(rshift_round(fa[k], kLog2 + 6), -32768, 32767);
      }
      if (kMl && !k64 && a.lf) {
        // the forward LFNST on the low 4x4 (k = 0: kStep >= 4), from its
        // entries in vector order
        int* vec = sh.lf_vec[v.plane];
        const bool low = active && row0 < 4 && col < 4;
        const int vi = lfnst_index(a.lf, row0, col);
        if (low) vec[vi] = c[0];
        group_sync(g, kSmall);
        if (low) c[0] = lfnst_entry(sh, a.lf, false, vec, vi);
      }
    }
    // quantization: the level out to global, dequantized into a (or, for
    // transform skip, into the residual's registers)
    bool any = false;
    if constexpr (kQ != kQPlain) {
      // the TU-wide quantizers: the coefficients into a, the levels into
      // b (SDH: a lane a coefficient; DQ: the trellis on the TU's
      // threads), under DQ the state-dependent dequantized values into a
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (active) sa[(row0 + k * kStep) * S + col] = c[k];
      group_sync(g, kSmall);
      const QuantArgs qa = quant_args(p, sh, tsh);
      if constexpr (kQ == kQDq) {
        dq_quantize<S, G>(qa, sh, g, kSmall, lt, v.plane, sa, sb
                          X266_PH_PASS);
        X266_PH(pc, kPhDeq);
      } else {
        sdh_tu<S, G>(qa, lt, sa, sb X266_PH_PASS);
        group_sync(g, kSmall);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!active) continue;
        const int rr = row0 + k * kStep;
        const int lv = sb[rr * S + col];
        co[(size_t)rr * cpitch + col] = (int16_t)lv;
        any = any || lv != 0;
        const int dq =
            kQ == kQDq ? sa[rr * S + col]
                       : clampi((lv * dscale + (1 << (ishift - 1))) >> ishift,
                                -32768, 32767);
        if (a.ts) res[k] = (dq + (1 << (tsh - 1))) >> tsh;
        else if (kQ != kQDq) sa[rr * S + col] = dq;
      }
    } else {
      const QuantArgs qa = quant_args(p, sh, tsh);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!active) continue;
        const int cc = c[k];
        // outside a 64-TU's band the level is 0 (as quant_level(0))
        int lv = k < kBand && col < kZo ? quant_level(qa, cc < 0 ? -cc : cc)
                                        : 0;
        lv = cc < 0 ? -lv : (cc > 0 ? lv : 0);
        const int rr = row0 + k * kStep;
        co[(size_t)rr * cpitch + col] = (int16_t)lv;
        any = any || lv != 0;
        const int dq = clampi((lv * dscale + (1 << (ishift - 1))) >> ishift,
                              -32768, 32767);
        if (a.ts) res[k] = (dq + (1 << (tsh - 1))) >> tsh;
        else sa[rr * S + col] = dq;
      }
    }
    X266_PH(pc, kPhQuant);
    inverse = !a.ts && group_any(g, kSmall, any);
  } else if (kQ == kQDq && a.nz) {
    // decode under DQ: the state-dependent dequantized levels into a
    if constexpr (kQ == kQDq)
      dq_dequant<S, G>(sh, g, kSmall, lt, v.plane, sh.in.lev + st, sp, sa,
                       dscale, ishift);
    if (a.ts) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (active)
          res[k] = (sa[(row0 + k * kStep) * S + col] + (1 << (tsh - 1))) >>
                   tsh;
    }
    inverse = !a.ts;
  } else if (a.nz) {
    // decode: the dequantization fused into the level reads
    lev = sh.in.lev + st;
    if (a.ts) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (active)
          res[k] = (clampi((lev[(row0 + k * kStep) * sp + col] * dscale +
                            (1 << (ishift - 1))) >> ishift, -32768, 32767) +
                    (1 << (tsh - 1))) >> tsh;
    } else if (kMl && a.lf) {
      // under LFNST the dequantized levels go to a first
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int rr = row0 + k * kStep;
        if (active)
          sa[rr * S + col] = clampi((lev[rr * sp + col] * dscale +
                                     (1 << (ishift - 1))) >> ishift,
                                    -32768, 32767);
      }
      group_sync(g, kSmall);
      lev = nullptr;
    }
    inverse = !a.ts;
  }
  // the inverse LFNST between the dequantizer and the primary inverse (a
  // TU whose levels are all 0 has none: it maps 0 to 0)
  if (kMl && !k64 && inverse && a.lf)
    lfnst_inverse<S>(sh, g, kSmall, a.lf, row0, col, sa);
  if (inverse) {
    // inverse vertical: b[n][m] = clip((sum_k Tv[k][n] a[k][m] + 64) >> 7)
    // (a 64-TU: k < 32, and columns m < 32, the others being 0)
    if (active && col < kZo) {
      if (lev)
        column_pass<S, K, kStep, true, true, kZo>(row0, col, tvm, sa, lev,
                                                  sp, dscale, ishift, acc);
      else
        column_pass<S, K, kStep, true, false, kZo>(row0, col, tvm, sa,
                                                   nullptr, 0, 0, 1, acc);
#pragma unroll
      for (int k = 0; k < K; ++k)
        sb[(row0 + k * kStep) * S + col] =
            clampi(rshift_round(acc[k], 7), -32768, 32767);
    }
    group_sync(g, kSmall);
    X266_PH(pc, kPhInvV);
    // inverse horizontal (a 64-TU: over columns j < 32 of b)
    if (active) {
      row_pass<S, K, kStep, kZo>(row0, col, thm, sb, acc);
#pragma unroll
      for (int k = 0; k < K; ++k)
        res[k] = clampi(rshift_round(acc[k], 12), -32768, 32767);
    }
  }

  // add the prediction, clip, write the window
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (active)
      at(v, x + col, y + row0 + k * kStep) =
          (uint8_t)clampi(pr[k] + res[k], 0, 255);
  group_sync(g, kSmall);
  X266_PH(pc, kPhInvH);
}

// A plane's TU of side s: the instance of tu for its size and thread
// count (luma 8 on a warp, 16 and 32 on 128 threads; chroma 4 and 8 on a
// warp, 16 on 64 threads; the CU-64 instances' luma 64 on 128 threads and
// chroma 32 on 64).
template <bool kEncode, int kQ, bool kMl, bool kCc, typename Sh, typename A>
__device__ __forceinline__ void plane_tu(const Params& p, Sh& sh,
                                         const View& v, const Group& g,
                                         int s, const A& a) {
  if constexpr (Sh::kCu64) {
    if (s == (v.plane == 0 ? 64 : 32)) {
      if (v.plane == 0) tu<kEncode, 64, 128, kQ, kMl, kCc>(p, sh, v, g, a);
      else tu<kEncode, 32, 64, kQ, kMl, kCc>(p, sh, v, g, a);
      return;
    }
  }
  switch (v.plane == 0 ? (s == 8 ? 1 : s == 16 ? 3 : 4)
                       : (s == 4 ? 0 : s == 8 ? 1 : 2)) {
    case 0: tu<kEncode, 4, 32, kQ, kMl, kCc>(p, sh, v, g, a); break;
    case 1: tu<kEncode, 8, 32, kQ, kMl, kCc>(p, sh, v, g, a); break;
    case 2: tu<kEncode, 16, 64, kQ, kMl, kCc>(p, sh, v, g, a); break;
    case 3: tu<kEncode, 16, 128, kQ, kMl, kCc>(p, sh, v, g, a); break;
    default: tu<kEncode, 32, 128, kQ, kMl, kCc>(p, sh, v, g, a); break;
  }
}

// One coded sample of a window's first row (the row above the CTU) or
// first column (the column to its left): entry e < wdim is row 0 column e,
// the others column 0 of rows 1 .. CTU side.  Returns its window offset,
// and in val the sample from the plane, or mid-gray where it is outside
// the picture.
__device__ __forceinline__ int edge_sample(const View& v, const uint8_t* rec,
                                           int e, int& val) {
  const int r = e < v.wdim ? 0 : e - v.wdim + 1;
  const int c = e < v.wdim ? e : 0;
  const int px = v.ox + c, py = v.oy + r;
  const bool coded = px >= 0 && py >= 0 && px < v.pw && py < v.ph;
  val = coded ? __ldcg(rec + (size_t)py * v.pw + px) : 128;
  return r * v.pitch + c;
}

// Fill the three windows for the CTU at luma origin (x0, y0): the samples
// of earlier CTUs -- the row above (first row, overhang included) and the
// column to the left (first column) -- from the output planes, everything
// else mid-gray; kCc: also the luma two rows above the CTU and two columns
// to its left into cc_row and cc_col (mid-gray outside the picture).  The
// global loads go out first, one to three a thread, so that one round trip
// to the L2 covers them all.  L: the instance's Layout.
template <bool kCc, typename L>
__device__ void load_windows(const View& vy, const View& vcb,
                             const View& vcr, const uint8_t* rec_y,
                             const uint8_t* rec_cb, const uint8_t* rec_cr,
                             uint8_t* cc_row, uint8_t* cc_col) {
  constexpr int ny = L::kWinY + kCtu, nc = L::kWinC + kCtu / 2;
  constexpr int kQ = (ny + 2 * nc + (kCc ? 2 * kCtu : 0) + kThreads - 1) /
                     kThreads;
  int off[kQ], val[kQ];
  uint8_t* win[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    off[q] = -1;
    val[q] = 0;
    win[q] = nullptr;
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int e = threadIdx.x + kThreads * q;
    if (e < ny) {
      off[q] = edge_sample(vy, rec_y, e, val[q]);
      win[q] = vy.win;
    } else if (e < ny + nc) {
      off[q] = edge_sample(vcb, rec_cb, e - ny, val[q]);
      win[q] = vcb.win;
    } else if (e < ny + 2 * nc) {
      off[q] = edge_sample(vcr, rec_cr, e - ny - nc, val[q]);
      win[q] = vcr.win;
    } else if (kCc && e < ny + 2 * nc + 2 * kCtu) {
      // i < kCtu: row y0 - 2 at x0 + i; else column x0 - 2 at row y0 + i
      // - kCtu
      const int i = e - ny - 2 * nc, r = i < kCtu;
      const int x0 = vy.ox + 1, y0 = vy.oy + 1;
      const int px = r ? x0 + i : x0 - 2, py = r ? y0 - 2 : y0 + i - kCtu;
      const bool coded = px >= 0 && py >= 0 && px < vy.pw && py < vy.ph;
      val[q] = coded ? __ldcg(rec_y + (size_t)py * vy.pw + px) : 128;
      off[q] = r ? i : i - kCtu;
      win[q] = r ? cc_row : cc_col;
    }
  }
  constexpr uint32_t kMid = 0x80808080u;
  for (int i = threadIdx.x; i < L::kWinY * L::kPitchY / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(vy.win)[i] = kMid;
  for (int i = threadIdx.x; i < L::kWinC * L::kPitchC / 4; i += kThreads) {
    reinterpret_cast<uint32_t*>(vcb.win)[i] = kMid;
    reinterpret_cast<uint32_t*>(vcr.win)[i] = kMid;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (off[q] >= 0) win[q][off[q]] = (uint8_t)val[q];
}

// Write the CTU's samples of the window back to the plane, a word at a
// time (plane widths and CTU origins are multiples of 4).
__device__ void store_window(const View& v, uint8_t* rec, int x0, int y0,
                             int ctu) {
  const int lane = threadIdx.x & 31;
  if (lane >= ctu / 4) return;
  const int px = x0 + 4 * lane;
  for (int r = threadIdx.x >> 5; r < ctu; r += kThreads / 32) {
    const int py = y0 + r;
    if (py >= v.ph || px >= v.pw) continue;
    const uint8_t* w = &at(v, px, py);
    const uint32_t word = w[0] | (uint32_t)w[1] << 8 | (uint32_t)w[2] << 16 |
                          (uint32_t)w[3] << 24;
    *reinterpret_cast<uint32_t*>(rec + (size_t)py * v.pw + px) = word;
  }
}

__device__ __forceinline__ bool coded_mv(int kind) {
  return kind != kIntra && kind != kSkip;
}

// K3: the s x s MC block of an inter CU at plane (x, y) and MV (mvx, mvy)
// (chroma: the MV halved) must lie inside its pyramid plane.
__device__ __forceinline__ void check_mc(int h, int w, int x, int y, int mvx,
                                         int mvy, int s) {
  const int py = y + kRefPad + (mvy >> 2), px = x + kRefPad + (mvx >> 2);
  X266_ASSERT(py >= 0 && py + s <= h && px >= 0 && px + s <= w);
}

// The MC prediction of plane sample (x, y) at MV (mvx, mvy): pyramid
// plane (mvy&3)*4 + (mvx&3) at (y + pad + (mvy>>2), x + pad + (mvx>>2)).
__device__ __forceinline__ int mc_sample(const uint8_t* pyr, int h, int w,
                                         int x, int y, int mvx, int mvy) {
  const int py = y + kRefPad + (mvy >> 2), px = x + kRefPad + (mvx >> 2);
  return __ldg(pyr + ((size_t)((mvy & 3) * 4 + (mvx & 3)) * h + py) * w + px);
}

// Staging before the row wait, by all threads: the CTU's maps (raster
// units; the mts map also under CCLM, whose choice rides bit 3) and inputs
// (encode: the source; decode: the levels and each unit's non-zero flags,
// into sh.unz, which the CTU before left zero).
template <bool kEncode, bool kInter, bool kB, bool kMl, bool kCc,
          typename Sh>
__device__ void stage_inputs(const Params& p, Sh& sh, int f, int cx,
                             int cy) {
  const int w = p.width, h = p.height, cw = w / 2, ch = h / 2;
  const int ux_n = w / 8, uy_n = h / 8;
  const int t = threadIdx.x;
  if (t < 64) {
    const int ux = cx * 8 + (t & 7), uy = cy * 8 + (t >> 3);
    const bool in = ux < ux_n && uy < uy_n;
    const size_t mi = (size_t)f * ux_n * uy_n + (size_t)uy * ux_n + ux;
    sh.size[t] = in ? p.size_map[mi] : 0;
    sh.mode[t] = in ? p.mode_map[mi] : 0;
    sh.mts[t] = in && (kCc || p.mts || p.ts || (kMl && (p.mtt || p.lfnst)))
                    ? p.mts_map[mi] : 0;
    if (kInter) {
      sh.ukind[t >> 3][1 + (t & 7)] = in ? p.pred_map[mi] : kIntra;
      sh.mvx[t] = in ? p.mvx_map[mi] : 0;
      sh.mvy[t] = in ? p.mvy_map[mi] : 0;
      sh.mv1x[t] = kB && in ? p.mv1_map[0][mi] : 0;
      sh.mv1y[t] = kB && in ? p.mv1_map[1][mi] : 0;
      sh.umv[0][t >> 3][1 + (t & 7)] = 0;
      sh.umv[1][t >> 3][1 + (t & 7)] = 0;
      sh.cu_kind[t] = -1;
    }
  }
  // 4 threads a unit: luma 2 rows of 8 each, chroma 1 row of 4 a plane
  const int unit = t >> 2, q = t & 3;
  const int ulx = unit & 7, uly = unit >> 3;
  if (cx * 8 + ulx >= ux_n || cy * 8 + uly >= uy_n) return;
  if (kEncode) {
    const uint8_t* srcy = p.src[0] + (size_t)f * p.plane_y;
    for (int r = 0; r < 2; ++r) {
      const int yy = uly * 8 + 2 * q + r;
      const uint8_t* row = srcy + (size_t)(cy * 64 + yy + 1) * p.pitch_y +
                           cx * 64 + ulx * 8 + 1;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        sh.in.src[yy * 64 + ulx * 8 + c] = __ldg(row + c);
    }
    for (int pl = 0; pl < 2; ++pl) {
      const int yy = uly * 4 + q;
      const uint8_t* row = p.src[1 + pl] + (size_t)f * p.plane_c +
                           (size_t)(cy * 32 + yy + 1) * p.pitch_c +
                           cx * 32 + ulx * 4 + 1;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sh.in.src[4096 + pl * 1024 + yy * 32 + ulx * 4 + c] = __ldg(row + c);
    }
  } else {
    // a luma row of a unit is 16 bytes, a chroma row 8 (plane widths
    // are multiples of 8)
    int nz = 0;
    for (int r = 0; r < 2; ++r) {
      const int yy = uly * 8 + 2 * q + r;
      const int4 lv = __ldg(reinterpret_cast<const int4*>(
          p.coef_in[0] + (size_t)f * w * h + (size_t)(cy * 64 + yy) * w +
          cx * 64 + ulx * 8));
      *reinterpret_cast<int4*>(sh.in.lev + yy * 64 + ulx * 8) = lv;
      nz |= (lv.x | lv.y | lv.z | lv.w) != 0;
    }
    for (int pl = 0; pl < 2; ++pl) {
      const int yy = uly * 4 + q;
      const int2 lv = __ldg(reinterpret_cast<const int2*>(
          p.coef_in[1 + pl] + (size_t)f * cw * ch + (size_t)(cy * 32 + yy) * cw +
          cx * 32 + ulx * 4));
      *reinterpret_cast<int2*>(sh.in.lev + 4096 + pl * 1024 + yy * 32 +
                               ulx * 4) = lv;
      nz |= ((lv.x | lv.y) != 0) << (1 + pl);
    }
    if (nz) atomicOr(&sh.unz[unit], nz);
  }
}

// A unit's TU under MTT (bits 4-5 of the mts map: 1 BT-H, 2 BT-V): a BT
// leaf of side s tiles as four TUs of side s / 2, else the CU is one TU.
// Returns the TU's side in units (0 outside the picture) and bt.
template <bool kMl, typename Sh>
__device__ __forceinline__ int tu_units(const Params& p, const Sh& sh,
                                        int t, int& bt) {
  const int u = sh.size[t] >> 3;
  bt = kMl && p.mtt ? (sh.mts[t] >> 4) & 3 : 0;
  return bt ? u >> 1 : u;
}

// The CTU's TU list in coding order (warp 1, after stage_inputs), and for
// K3 each CU's final MV, derived in z-order (its lane 0) over its units:
// the MV state derive_mv and above_mv read.  A TU is a CU, or under MTT
// one of a BT leaf's four t-TUs (x266_tpu/engine/recon.py:393-499): its
// mode is its rectangular CU's (the CU origin's unit), its transform
// choice, LFNST, levels and prediction shifts its own; z-order but for a
// BT-V leaf, whose left CU's two TUs come first (entries 1 and 2 of the
// leaf swap).
template <bool kEncode, bool kInter, bool kB, bool kMl, typename Sh>
__device__ void build_cus(const Params& p, Sh& sh, int cx, int cy) {
  const int lane = threadIdx.x & 31;
  unsigned ball[2];
  bool org[2];
  int unit[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    int zx, zy, bt;
    z_unit(lane + 32 * hf, zx, zy);
    unit[hf] = zy * 8 + zx;
    const int u = tu_units<kMl>(p, sh, unit[hf], bt);   // 0 outside
    org[hf] = u > 0 && (zx & (u - 1)) == 0 && (zy & (u - 1)) == 0;
    ball[hf] = __ballot_sync(kFull, org[hf]);
  }
  const unsigned below = (1u << lane) - 1;

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!org[hf]) continue;
    const int t = unit[hf];
    int bt;
    const int u = tu_units<kMl>(p, sh, t, bt);
    Cu cu;
    cu.ux = t & 7;
    cu.uy = t >> 3;
    cu.s = u * 8;
    // a BT TU's mode is its rectangular CU's, at the CU's origin: the
    // leaf's column (BT-H) or row (BT-V) of units
    const int lu = 2 * u - 1;                   // leaf side in units - 1
    const int cu_t = bt == 1 ? cu.uy * 8 + (cu.ux & ~lu)
                   : bt == 2 ? (cu.uy & ~lu) * 8 + cu.ux : t;
    const int mode = sh.mode[cu_t];
    cu.mode = mode;
    cu.mode_c = mode >= p.n_std ? 0 : mode;   // chroma of MIP: planar
    // the map holds an MTS pair (0-4) or transform skip (5), read when
    // either tool is on
    const int mval = (p.mts || p.ts) ? (sh.mts[t] & 7) : 0;
    cu.ts = p.ts && mval == 5;
    const int mts = p.mts && !cu.ts ? mini(mval, 4) : 0;
    // MTS combos (tables.MTS_COMBOS) 0-4: (vertical, horizontal) types
    // (0, 0), (1, 1), (2, 1), (1, 2), (2, 2); 0 DCT-II, 1 DST-VII, 2
    // DCT-VIII
    cu.tv = mts == 0 ? 0 : 2 - (mts & 1);
    cu.th = (mts + 1) >> 1;
    // LFNST (bits 6-7) on the DCT-II pair: its kernel set * 2 + idx - 1
    // by the mode's class (kernels/lfnst.py mode_class), transposed past
    // the diagonal
    const int li = kMl && p.lfnst ? (sh.mts[t] >> 6) & 3 : 0;
    cu.lf = 0;
    if (li && !cu.ts && mts == 0) {
      const int diag = p.n_modes == 35 ? 18 : 34;
      const int m = p.n_modes > 67 && mode >= 67 ? 0 : mode;
      const bool tr = m > diag;
      const int a = clampi(tr ? 2 * diag - m : m, 2, diag);
      const int set = m <= 1 ? 0 : 1 + mini(2, (3 * (a - 2)) / (diag - 1));
      cu.lf = kLfOn | (set * 2 + li - 1) << 1 | (m > 1 && tr);
    }
    cu.kind = kInter ? sh.ukind[cu.uy][1 + cu.ux] : kIntra;
    cu.shift_y = sh.shift[size_index(cu.s) * p.n_modes + mode];
    cu.shift_c = sh.shift[size_index(cu.s >> 1) * p.n_modes + cu.mode_c];
    int nz = 0;
    for (int dy = 0; dy < u; ++dy)
      for (int dx = 0; dx < u; ++dx) nz |= sh.unz[t + dy * 8 + dx];
    cu.nz = nz;
    int i = hf == 0 ? __popc(ball[0] & below)
                    : __popc(ball[0]) + __popc(ball[1] & below);
    if (bt == 2) {
      // the TU's place in its leaf in z-order, 1 (top right) and 2
      // (bottom left) swapped
      const int k = ((cu.uy / u) & 1) * 2 + ((cu.ux / u) & 1);
      i += k == 1 ? 1 : k == 2 ? -1 : 0;
    }
    sh.cus[i] = cu;
  }
  const int n = __popc(ball[0]) + __popc(ball[1]);
  if (lane == 0) sh.n_cus = n;
  __syncwarp();
  for (int c = 0; kInter && lane == 0 && c < n; ++c) {
    const Cu& cu = sh.cus[c];
    const int t = cu.uy * 8 + cu.ux, ux = cx * 8 + cu.ux, uy = cy * 8 + cu.uy;
    const bool skip = cu.kind == kSkip;
    int mvx = 0, mvy = 0;
    // the above unit's MV while inside the CTU row, else (0, 0)
    auto above = [&]() {
      if (cu.uy > 0 && coded_mv(sh.ukind[cu.uy - 1][1 + cu.ux])) {
        mvx = sh.umv[0][cu.uy - 1][1 + cu.ux];
        mvy = sh.umv[1][cu.uy - 1][1 + cu.ux];
      }
    };
    if (!skip || (p.merge && !kEncode)) {
      mvx = sh.mvx[t];
      mvy = sh.mvy[t];
    } else if (p.merge && sh.mvx[t] == 1) {
      above();                          // merge candidate 1
    } else if (ux > 0 && coded_mv(sh.ukind[cu.uy][cu.ux])) {
      mvx = sh.umv[0][cu.uy][cu.ux];    // the left unit (column 0: the
      mvy = sh.umv[1][cu.uy][cu.ux];    // left CTU's last)
    } else {
      above();
    }
    const int u = cu.s >> 3;
    for (int dy = 0; dy < u; ++dy)
      for (int dx = 0; dx < u; ++dx) {
        sh.umv[0][cu.uy + dy][1 + cu.ux + dx] = (int16_t)mvx;
        sh.umv[1][cu.uy + dy][1 + cu.ux + dx] = (int16_t)mvy;
        sh.cu_kind[t + dy * 8 + dx] = (int8_t)cu.kind;
        if (kB) {
          sh.cu_mv1[0][t + dy * 8 + dx] = sh.mv1x[t];
          sh.cu_mv1[1][t + dy * 8 + dx] = sh.mv1y[t];
        }
      }
    if (cu.kind != kIntra) {
      const int x = ux * 8, y = uy * 8, s = cu.s;
      check_mc(p.pyr_h[0], p.pyr_w[0], x, y, mvx, mvy, s);
      check_mc(p.pyr_h[1], p.pyr_w[1], x / 2, y / 2, mvx >> 1, mvy >> 1,
               s / 2);
      if (kB && cu.kind == kBi) {
        check_mc(p.pyr_h[0], p.pyr_w[0], x, y, sh.mv1x[t], sh.mv1y[t], s);
        check_mc(p.pyr_h[1], p.pyr_w[1], x / 2, y / 2, sh.mv1x[t] >> 1,
                 sh.mv1y[t] >> 1, s / 2);
      }
    }
  }
}

// K3, after the row wait, beside the window load: each inter CU's MC
// prediction into sh.mcp (a bi CU's two blocks averaged); eight samples'
// loads go out before their stores.
template <bool kB, typename Sh>
__device__ void stage_mc(const Params& p, Sh& sh, int cx, int cy) {
  constexpr int kPer = kStage / kThreads, kBatch = 8;
  static_assert(kPer % kBatch == 0, "whole batches");
  for (int b = 0; b < kPer; b += kBatch) {
    int val[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = threadIdx.x + kThreads * (b + q);
      int pl, sx, sy, unit;
      if (i < 4096) {
        pl = 0; sx = i & 63; sy = i >> 6;
        unit = (sy >> 3) * 8 + (sx >> 3);
      } else {
        const int j = i - 4096;
        pl = 1 + (j >> 10); sx = j & 31; sy = (j & 1023) >> 5;
        unit = (sy >> 2) * 8 + (sx >> 2);
      }
      const int kind = sh.cu_kind[unit];
      val[q] = -1;
      if (kind <= kIntra) continue;     // intra, or outside the picture
      const int c = pl > 0;
      int mvx = sh.umv[0][unit >> 3][1 + (unit & 7)];
      int mvy = sh.umv[1][unit >> 3][1 + (unit & 7)];
      if (c) { mvx >>= 1; mvy >>= 1; }
      const int x = (c ? cx * 32 : cx * 64) + sx;
      const int y = (c ? cy * 32 : cy * 64) + sy;
      const int l1 = kB && kind == kL1 ? 3 : 0;
      val[q] = mc_sample(p.pyr[l1 + pl], p.pyr_h[c], p.pyr_w[c], x, y, mvx,
                         mvy);
      if (kB && kind == kBi) {
        int m1x = sh.cu_mv1[0][unit], m1y = sh.cu_mv1[1][unit];
        if (c) { m1x >>= 1; m1y >>= 1; }
        val[q] = (val[q] + mc_sample(p.pyr[3 + pl], p.pyr_h[c], p.pyr_w[c],
                                     x, y, m1x, m1y) + 1) >> 1;
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (val[q] >= 0) sh.mcp[threadIdx.x + kThreads * (b + q)] = val[q];
  }
}

template <bool kEncode, bool kInter, bool kB = false, int kQ = kQPlain,
          bool kMl = false, bool kCc = false, bool kC64 = false>
__global__ void __launch_bounds__(kThreads)
recon_kernel(Params p) {
  using Sh = SharedT<kC64>;
  X266_DYNAMIC_SHARED(int4, smem);
  Sh& sh = *reinterpret_cast<Sh*>(smem);
  X266_SHARED(int, ticket);
  X266_PH_START(bc, 12 * kPhases, threadIdx.x == 0);
  X266_PH_START(blk, 12 * kPhases, threadIdx.x == 0);
  const int w = p.width, h = p.height, cw = w / 2, ch = h / 2;
  const int ux_n = w / 8, uy_n = h / 8;
  const int ctus_x = (w + kCtu - 1) / kCtu, ctus_y = (h + kCtu - 1) / kCtu;
  const int tid = threadIdx.x;
  // the tables, once per launch: the transform matrices as given and
  // transposed within each (type, size) matrix
  for (int i = tid; i < 3 * kTxPerType; i += kThreads) {
    const int v = __ldg(p.tx + i);
    const int type = i / kTxPerType, o = i - type * kTxPerType;
    const int s = o < 16 ? 4 : o < 80 ? 8 : o < 336 ? 16 : 32;
    const int e = o - tx_offset(s), log2s = 31 - __clz(s);
    sh.tx[0][i] = (int8_t)v;
    sh.tx[1][type * kTxPerType + tx_offset(s) + (e & (s - 1)) * s +
             (e >> log2s)] = (int8_t)v;
  }
  // CU 64: the 64-point DCT-II after the three types
  for (int i = tid; kC64 && i < kTx64; i += kThreads) {
    const int v = __ldg(p.tx + 3 * kTxPerType + i);
    sh.tx[0][3 * kTxPerType + i] = (int8_t)v;
    sh.tx[1][3 * kTxPerType + (i & 63) * 64 + (i >> 6)] = (int8_t)v;
  }
  for (int i = tid; i < Sh::kSmoothN; i += kThreads)
    sh.smooth[i] = __ldg(p.smooth + i);
  for (int i = tid; i < Sh::kSizes * p.n_modes; i += kThreads)
    sh.shift[i] = __ldg(p.shift + i);
  for (int i = tid; i < kRateShared; i += kThreads) sh.rate[i] = __ldg(p.rate + i);
  for (int i = tid; kMl && p.lfnst && i < 8 * 256; i += kThreads) {
    const int v = __ldg(p.lfnst_tab + i);
    sh.lfnst[0][i] = (int8_t)v;
    sh.lfnst[1][(i & ~255) + (i & 15) * 16 + ((i >> 4) & 15)] = (int8_t)v;
  }
  if (tid < 64) sh.unz[tid] = 0;
  if (kCc && tid < 64) x266_mbar_init(&sh.cc_bar[tid], 1);
  if (kCc) x266_mbar_init_fence();
  if (tid == 0) ticket = atomicAdd(p.sync, 1);
  __syncthreads();
  const int f = ticket / ctus_y, cy = ticket % ctus_y;
  int* progress = p.sync + 1 + (size_t)f * ctus_y;
  uint8_t* rec_y = p.rec[0] + (size_t)f * w * h;
  uint8_t* rec_c[2] = {p.rec[1] + (size_t)f * cw * ch,
                       p.rec[2] + (size_t)f * cw * ch};
  // this thread's plane group
  const int plane = tid < 128 ? 0 : (tid < 192 ? 1 : 2);
  const Group grp{1 + plane, plane == 0 ? 128 : 64,
                  tid - (plane == 0 ? 0 : plane == 1 ? 128 : 192)};

  for (int cx = 0; cx < ctus_x; ++cx) {
    stage_inputs<kEncode, kInter, kB, kMl, kCc>(p, sh, f, cx, cy);
    __syncthreads();
    X266_PH(bc, kPhMv);
    // the CU list (and K3's MVs) on warp 1 while thread 0 waits for the
    // row above: tickets make that row a running block, so the wait ends;
    // the cap (seconds) only keeps a fault from hanging the card
    if (tid >> 5 == 1) build_cus<kEncode, kInter, kB, kMl>(p, sh, cx, cy);
    if (tid >> 5 >= 2 && p.subst) {
      // each TU's substitution sources, luma and chroma
      for (int t = (tid >> 5) - 2; t < 64; t += 6) {
        int bt;
        const int ux = t & 7, uy = t >> 3, u = tu_units<kMl>(p, sh, t, bt);
        if (u == 0 || (ux & (u - 1)) || (uy & (u - 1))) continue;
        const int x = cx * kCtu + ux * 8, y = cy * kCtu + uy * 8, s = u * 8;
        // a BT-V leaf's TUs compare by its order inside it
        const int lf = bt == 2 ? 2 * s : 0;
        const int lx = x & ~(lf - 1), ly = y & ~(lf - 1);
        ref_sources<Sh::kSrcWords>(p, x, y, s, 1, BtvLeaf{lx, ly, lf},
                                   sh.rsrc_y[t]);
        ref_sources<Sh::kSrcWords>(p, x / 2, y / 2, s / 2, 2,
                                   BtvLeaf{lx / 2, ly / 2, lf / 2},
                                   sh.rsrc_c[t]);
      }
    }
    if (cy > 0 && tid == 0) {
      const int need = cx + 2 < ctus_x ? cx + 2 : ctus_x;
      for (int spins = 0;
           x266_ld_acquire(progress + cy - 1) < need && spins < kMaxSpins;
           ++spins)
        __nanosleep(64);
    }
    __syncthreads();
    X266_PH(bc, kPhWait);
    const int x0 = cx * kCtu, y0 = cy * kCtu;
    // the planes' views (built in registers: an array of them indexed by
    // the plane would sit in local memory and make every window access a
    // generic one)
    const View vy{sh.win_y, Sh::kWinY, Sh::kPitchY, x0 - 1, y0 - 1, w, h, 1,
                  0};
    const View vcb{sh.win_c[0], Sh::kWinC, Sh::kPitchC, x0 / 2 - 1,
                   y0 / 2 - 1, cw, ch, 2, 1};
    const View vcr{sh.win_c[1], Sh::kWinC, Sh::kPitchC, x0 / 2 - 1,
                   y0 / 2 - 1, cw, ch, 2, 2};
    load_windows<kCc, Sh>(vy, vcb, vcr, rec_y, rec_c[0], rec_c[1], sh.cc_row,
                          sh.cc_col);
    if (kInter) stage_mc<kB>(p, sh, cx, cy);
    __syncthreads();
    X266_PH(bc, kPhLoad);

    // the walk: each group its plane's TUs in z-order
    {
      const View v = plane == 0 ? vy : plane == 1 ? vcb : vcr;
      const int px0 = plane ? x0 / 2 : x0, py0 = plane ? y0 / 2 : y0;
      const int n_cus = sh.n_cus;
      bool synced = true;
      for (int c = 0; c < n_cus; ++c) {
        const Cu cu = sh.cus[c];
        const int s = plane ? cu.s >> 1 : cu.s;
        const bool small = s * s <= 64;
        const int unit = plane ? 4 : 8;
        const int t = cu.uy * 8 + cu.ux;
        if (!small || grp.lt < 32)
          plane_tu<kEncode, kQ, kMl, kCc>(
              p, sh, v, grp, s,
              TuArgs<typename Sh::Src>{px0 + cu.ux * unit, py0 + cu.uy * unit, px0, py0,
                     plane ? cu.mode_c : cu.mode,
                     plane ? cu.shift_c : cu.shift_y, plane ? 0 : cu.tv,
                     plane ? 0 : cu.th, plane ? 0 : cu.lf, !plane && cu.ts,
                     cu.kind,
                     ((cu.nz >> plane) & 1) != 0, !small && !synced,
                     !p.subst ? nullptr : plane ? sh.rsrc_c[t]
                                                : sh.rsrc_y[t], f,
                     c, cx & 1, kCc ? sh.mts[t] : 0});
        // CCLM: the CU's luma is in the window (its TU ended with the
        // group's barrier, or warp 0's for a small one)
        if (kCc && plane == 0 && grp.lt == 0) x266_mbar_arrive(&sh.cc_bar[c]);
        synced = !small;
      }
      // CCLM: the slots past the CTU's CUs complete their phase too
      for (int c = n_cus; kCc && tid == 0 && c < 64; ++c)
        x266_mbar_arrive(&sh.cc_bar[c]);
    }
    __syncthreads();
    X266_PH(bc, kPhInvH);

    store_window(vy, rec_y, x0, y0, kCtu);
    store_window(vcb, rec_c[0], x0 / 2, y0 / 2, kCtu / 2);
    store_window(vcr, rec_c[1], x0 / 2, y0 / 2, kCtu / 2);
    if (tid < 64) {
      sh.unz[tid] = 0;
      const int ux = cx * 8 + (tid & 7), uy = cy * 8 + (tid >> 3);
      if (kInter && ux < ux_n && uy < uy_n) {
        // the final MVs; the MV state of the CTU to the right
        p.mv_out[0][uy * ux_n + ux] = sh.umv[0][tid >> 3][1 + (tid & 7)];
        p.mv_out[1][uy * ux_n + ux] = sh.umv[1][tid >> 3][1 + (tid & 7)];
      }
    }
    __syncthreads();
    if (kInter && tid < 8) {
      sh.ukind[tid][0] = sh.ukind[tid][8];
      sh.umv[0][tid][0] = sh.umv[0][tid][8];
      sh.umv[1][tid][0] = sh.umv[1][tid][8];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) x266_st_release(progress + cy, cx + 1);
    X266_PH(bc, kPhStore);
  }
  X266_PH(blk, kPhBlock);
}

#ifdef X266_RECON_MAIN_PART
// A test entry: the warp-scan substitution on one reference vector of
// side s (host stand-in only: ref, avail and out are host arrays).
struct SubstTest {
  int s;
  const int* ref;
  const uint8_t* avail;
  int* out;
};

struct Sources {
  uint8_t i[kMaxR];
};

__global__ void subst_test_kernel(SubstTest a) {
  X266_SHARED(Sources, src);
  const int lane = threadIdx.x & 31;
  const int r_len = 4 * a.s + 1;
  unsigned m[5];
  for (int w = 0; w < 5; ++w) {
    const int k = lane + 32 * w;
    m[w] = __ballot_sync(kFull, k < r_len && a.avail[scan_index(k, a.s)]);
  }
  subst_sources(a.s, m, src.i);
  __syncwarp();
  for (int i = lane; i < r_len; i += 32)
    a.out[i] = src.i[i] == 255 ? 128 : a.ref[src.i[i]];
}
#endif

void set_common(Params& p, int frames, int width, int height,
                int pitch_y, int pitch_c, int plane_y, int plane_c, int qp,
                float lam, int rdoq, int mts, int subst, int n_modes,
                const void* const* src, const void* const* cin,
                const void* size_map, const void* mode_map,
                const void* mts_map, void* const* rec, void* const* cout,
                const void* taps, const void* smooth, const void* tx,
                const void* shift, const void* rate) {
  p = Params{};
  p.frames = frames; p.width = width; p.height = height;
  p.pitch_y = pitch_y; p.pitch_c = pitch_c;
  p.plane_y = plane_y; p.plane_c = plane_c;
  p.qp = qp; p.lam = lam; p.rdoq = rdoq; p.mts = mts; p.subst = subst;
  p.n_modes = n_modes;
  p.n_std = n_modes < 67 ? n_modes : 67;   // MIP's modes follow the 67
  for (int i = 0; i < 3; ++i) {
    p.src[i] = (const uint8_t*)src[i];
    p.coef_in[i] = (const int16_t*)cin[i];
    p.rec[i] = (uint8_t*)rec[i];
    p.coef_out[i] = (int16_t*)cout[i];
  }
  p.size_map = (const int32_t*)size_map; p.mode_map = (const int32_t*)mode_map;
  p.mts_map = (const int32_t*)mts_map;
  p.taps = (const int32_t*)taps; p.smooth = (const int32_t*)smooth;
  p.tx = (const int32_t*)tx; p.shift = (const int32_t*)shift;
  p.rate = (const float*)rate;
}

// Launch `kernel`, an instance of recon_kernel (kInter: K3's), with smem
// bytes of dynamic shared memory, one block per CTU row of each frame,
// after zeroing the row ticket and progress counters (and, for K3, the
// final-MV planes) on the stream, and for K1 under CCLM copying the mts
// map in to the map out, whose CUs the kernel then overwrites.  Every row
// must be resident at once on the card, or the launch is refused
// (cudaErrorInvalidConfiguration); so is a mode alphabet larger than the
// kernel's shift table (cudaErrorInvalidValue).
int launch_kernel(Params& p, void (*kernel)(Params), bool kInter,
                  size_t smem, void* stream) {
  void* args[] = {&p};
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = p.frames * ((p.height + kCtu - 1) / kCtu);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = p.n_modes > kMaxModes ? cudaErrorInvalidValue
                                          : cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err == cudaSuccess && rows > per_sm * sms)
    err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess)
    err = cudaMemsetAsync(p.sync, 0, sizeof(int) * (1 + rows), st);
  const size_t mv_bytes = sizeof(int16_t) * (p.width / 8) * (p.height / 8);
  for (int i = 0; kInter && i < 2 && err == cudaSuccess; ++i)
    err = cudaMemsetAsync(p.mv_out[i], 0, mv_bytes, st);
  if (err == cudaSuccess && p.mts_out != nullptr)
    err = cudaMemcpyAsync(p.mts_out, p.mts_map,
                          sizeof(int32_t) * p.frames * (p.width / 8) *
                              (p.height / 8),
                          cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaLaunchKernel(kernel, dim3(rows), dim3(kThreads), args, smem, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// An intra launch under MTT or LFNST takes the instances with their code
// (kMl, a template parameter like the quantizer, so the others compile
// without it); K3's never do (kMl = !kInter is then the default).  CCLM
// (kCc, intra only) is the caller's.
using KernelFn = void (*)(Params);

template <bool kEncode, bool kInter, bool kB, int kQ, bool kCc = false>
KernelFn instance(const Params& p) {
  return !kInter && (p.mtt || p.lfnst)
             ? recon_kernel<kEncode, kInter, kB, kQ, !kInter, kCc>
             : recon_kernel<kEncode, kInter, kB, kQ, false, kCc>;
}

#if defined(X266_RECON_CCLM_PART)
// The CCLM instances of K1 and K2, each quantizer's (an encode under SDH
// or DQ, a decode under DQ; a decode under SDH is element-wise); DQ's with
// its scratch.
int launch_cclm(Params& p, int encode, void* stream) {
  const KernelFn kernel =
      encode ? (p.dq    ? instance<true, false, false, kQDq, true>(p)
                : p.sdh ? instance<true, false, false, kQSdh, true>(p)
                        : instance<true, false, false, kQPlain, true>(p))
             : (p.dq ? instance<false, false, false, kQDq, true>(p)
                     : instance<false, false, false, kQPlain, true>(p));
  return launch_kernel(p, kernel, false,
                       sizeof(Shared) + (p.dq ? kDqBytes : 0), stream);
}
#elif defined(X266_RECON_CU64_PART)
// The CU-64 instances of K1 and K2 (kC64; element-wise quantizer: CU 64
// comes without SDH and DQ), with and without LFNST (kMl): this part's
// with CCLM (kCc, csrc/recon_cu64_cclm.cu) or without it
// (csrc/recon_cu64.cu), so that the two build at once.
#if defined(X266_RECON_CU64_CCLM_PART)
constexpr bool kCu64Cc = true;
#else
constexpr bool kCu64Cc = false;
#endif
template <bool kEncode>
KernelFn instance64(const Params& p) {
  return p.mtt || p.lfnst
             ? recon_kernel<kEncode, false, false, kQPlain, true, kCu64Cc,
                            true>
             : recon_kernel<kEncode, false, false, kQPlain, false, kCu64Cc,
                            true>;
}

int launch_cu64(Params& p, int encode, void* stream) {
  return launch_kernel(p, encode ? instance64<true>(p) : instance64<false>(p),
                       false, sizeof(SharedT<true>), stream);
}
#elif defined(X266_RECON_MAIN_PART)
// The element-wise instances (the quantizer of kQPlain).
template <bool kInter, bool kB = false>
int launch(Params& p, int encode, void* stream) {
  return launch_kernel(p, encode ? instance<true, kInter, kB, kQPlain>(p)
                                 : instance<false, kInter, kB, kQPlain>(p),
                       kInter, sizeof(Shared), stream);
}
#else
// The SDH and DQ instances: an encode under SDH or DQ, a decode under DQ
// (a decode under SDH is element-wise); DQ's with its scratch.
template <bool kInter, bool kB>
int launch_quant(Params& p, int encode, void* stream) {
  const KernelFn kernel =
      !encode ? instance<false, kInter, kB, kQDq>(p)
      : p.dq  ? instance<true, kInter, kB, kQDq>(p)
              : instance<true, kInter, kB, kQSdh>(p);
  return launch_kernel(p, kernel, kInter,
                       sizeof(Shared) + (p.dq ? kDqBytes : 0), stream);
}

// A test entry: one TU's quantizer alone, on one block of a plane group's
// G threads (the TU's own on a warp), from the coefficients `coef`
// (raster, int32): SDH's levels, or DQ's levels and their state-dependent
// dequantized values.
struct QuantTest {
  Params p;
  int dq, s, g, plane;
  const int* coef;
  int* lev;
  int* deq;
};

template <int S, int G>
__device__ void quant_test_tu(const QuantTest& a, Shared& sh) {
  constexpr bool kSmall = S * S <= 64;
  constexpr int tsh = 7 - Map<S, G>::kLog2;
  const Group g{1 + a.plane, G, (int)threadIdx.x};
  int* sa = a.plane == 0 ? sh.a_y : sh.a_c[a.plane - 1];
  int* sb = a.plane == 0 ? sh.b_y : sh.b_c[a.plane - 1];
  for (int i = threadIdx.x; i < S * S; i += G) sa[i] = a.coef[i];
  __syncthreads();
  X266_PH_START(pc, 0, false);
  const QuantArgs qa = quant_args(a.p, sh, tsh);
  if (a.dq) {
    dq_quantize<S, G>(qa, sh, g, kSmall, g.lt, a.plane, sa, sb X266_PH_PASS);
  } else {
    sdh_tu<S, G>(qa, g.lt, sa, sb X266_PH_PASS);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * S; i += G) {
    a.lev[i] = sb[i];
    if (a.dq) a.deq[i] = sa[i];
  }
}

__global__ void quant_test_kernel(QuantTest a) {
  X266_DYNAMIC_SHARED(int4, smem);
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  for (int i = threadIdx.x; i < kRateShared; i += a.g)
    sh.rate[i] = __ldg(a.p.rate + i);
  __syncthreads();
  switch (a.s * 1000 + a.g) {
    case 4032: quant_test_tu<4, 32>(a, sh); break;
    case 8032: quant_test_tu<8, 32>(a, sh); break;
    case 16064: quant_test_tu<16, 64>(a, sh); break;
    case 16128: quant_test_tu<16, 128>(a, sh); break;
    default: quant_test_tu<32, 128>(a, sh); break;
  }
}
#endif

void set_inter(Params& p, int merge, int pyr_hy, int pyr_wy, int pyr_hc,
               int pyr_wc, const void* pred_map, const void* mvx_map,
               const void* mvy_map, const void* const* pyr, void* mv_x,
               void* mv_y) {
  p.merge = merge;
  p.pred_map = (const int32_t*)pred_map;
  p.mvx_map = (const int32_t*)mvx_map;
  p.mvy_map = (const int32_t*)mvy_map;
  for (int i = 0; i < 3; ++i) p.pyr[i] = (const uint8_t*)pyr[i];
  p.pyr_h[0] = pyr_hy; p.pyr_w[0] = pyr_wy;
  p.pyr_h[1] = pyr_hc; p.pyr_w[1] = pyr_wc;
  p.mv_out[0] = (int16_t*)mv_x; p.mv_out[1] = (int16_t*)mv_y;
}

}  // namespace

extern "C" {

#ifdef X266_RECON_PHASES
// The phase split's sums of this part's kernels since the last call
// (kPhaseSlots uint64: see Phase), added to host memory `out`, then
// zeroed: csrc/recon_intra.cu, recon_quant.cu and recon_cclm.cu each hold
// their own.
#if defined(X266_RECON_CCLM_PART)
int x266_recon_phases_cclm(void* out) {
#elif defined(X266_RECON_CU64_CCLM_PART)
int x266_recon_phases_cu64_cclm(void* out) {
#elif defined(X266_RECON_CU64_PART)
int x266_recon_phases_cu64(void* out) {
#elif defined(X266_RECON_QUANT_PART)
int x266_recon_phases_quant(void* out) {
#else
int x266_recon_phases_main(void* out) {
#endif
  unsigned long long part[kPhaseSlots];
  static const unsigned long long zero[kPhaseSlots] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(part, g_recon_phases, sizeof(part));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_recon_phases, zero, sizeof(zero));
  for (int i = 0; err == cudaSuccess && i < kPhaseSlots; ++i)
    static_cast<unsigned long long*>(out)[i] += part[i];
  return (int)err;
}
#endif

#if defined(X266_RECON_CCLM_PART)
// Launches the CCLM instance of K1 (encode != 0) or K2 on `stream` with
// the parameters x266_recon_intra set (`params`, a Params); returns
// cudaGetLastError().
int x266_recon_cclm(const void* params, int encode, void* stream) {
  Params p = *static_cast<const Params*>(params);
  return launch_cclm(p, encode, stream);
}
#elif defined(X266_RECON_CU64_CCLM_PART)
// Launches the CU-64 CCLM instance of K1 (encode != 0) or K2 on `stream`
// with the parameters x266_recon_intra set (`params`, a Params); returns
// cudaGetLastError().
int x266_recon_cu64_cclm(const void* params, int encode, void* stream) {
  Params p = *static_cast<const Params*>(params);
  return launch_cu64(p, encode, stream);
}
#elif defined(X266_RECON_CU64_PART)
int x266_recon_cu64_cclm(const void* params, int encode, void* stream);

// Launches the CU-64 instance of K1 (encode != 0) or K2 on `stream` with
// the parameters x266_recon_intra set (`params`, a Params), under CCLM
// csrc/recon_cu64_cclm.cu's; returns cudaGetLastError().
int x266_recon_cu64(const void* params, int encode, void* stream) {
  Params p = *static_cast<const Params*>(params);
  if (p.cclm) return x266_recon_cu64_cclm(params, encode, stream);
  return launch_cu64(p, encode, stream);
}
#elif defined(X266_RECON_QUANT_PART)
// Launches the SDH / DQ instance of K1/K2 (inter 0), K3-P (inter 1, b 0)
// or K3-B (b 1) on `stream` with the parameters the entry point below
// set (`params`, a Params); returns cudaGetLastError().
int x266_recon_quant(const void* params, int inter, int b, int encode,
                     void* stream) {
  Params p = *static_cast<const Params*>(params);
  if (!inter) return launch_quant<false, false>(p, encode, stream);
  if (!b) return launch_quant<true, false>(p, encode, stream);
  return launch_quant<true, true>(p, encode, stream);
}

// One TU's quantizer alone (dq 0: SDH, 1: DQ) at side s on g threads as
// the recon kernels run it: (s, g) one of (4, 32), (8, 32), (16, 64),
// (16, 128), (32, 128), in plane group `plane`'s scratch, with the
// quantizer's qp, rdoq, lam and the rate table `rate` (float32, 32768);
// coef the TU's coefficients (int32 s x s raster), lev its levels and,
// under DQ, deq their dequantized values (int32 s x s).  A test entry;
// returns the launch's error.
int x266_quant_tu(int dq, int s, int g, int plane, int qp, int rdoq,
                  float lam, const void* rate, const void* coef, void* lev,
                  void* deq) {
  const int key = s * 1000 + g;
  if (key != 4032 && key != 8032 && key != 16064 && key != 16128 &&
      key != 32128)
    return (int)cudaErrorInvalidValue;
  QuantTest a{};
  a.p.qp = qp;
  a.p.rdoq = rdoq;
  a.p.lam = lam;
  a.p.dq = dq;
  a.p.rate = (const float*)rate;
  a.dq = dq; a.s = s; a.g = g; a.plane = plane;
  a.coef = (const int*)coef;
  a.lev = (int*)lev;
  a.deq = (int*)deq;
  void* args[] = {&a};
  void (*kernel)(QuantTest) = quant_test_kernel;
  const size_t smem = sizeof(Shared) + kDqBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaLaunchKernel(kernel, dim3(1), dim3(g), args, smem, nullptr);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
#else
int x266_recon_quant(const void* params, int inter, int b, int encode,
                     void* stream);
int x266_recon_cclm(const void* params, int encode, void* stream);
int x266_recon_cu64(const void* params, int encode, void* stream);

// Launches K1 (encode != 0) or K2 on `stream`; `sync` is scratch of
// 1 + frames x CTU rows int32; lossless, ts and pdpc switch the intra
// tools on, and `mip` holds tables.k_mip; sdh (encode) and dq switch the
// quantizer, whose instances csrc/recon_quant.cu compiles; mtt takes the
// BT leaves of bits 4-5 of the mts map, lfnst the LFNST of bits 6-7 with
// the kernels `lfnst_tab` (tables.k_lfnst); cclm takes the CCLM instances
// (csrc/recon_cclm.cu): K2 reads each CU's choice from bit 3 of the mts
// map, K1 writes the map with its choices to mts_out (int32, as the
// maps); cu64 (max_cu_size 64) takes the CU-64 instances
// (csrc/recon_cu64.cu, csrc/recon_cu64_cclm.cu), with the tables' 64
// size.  Returns
// cudaGetLastError().
int x266_recon_intra(
    int encode, int frames, int width, int height, int pitch_y, int pitch_c,
    int plane_y, int plane_c, int qp, float lam, int rdoq, int mts, int subst,
    int n_modes, int lossless, int ts, int pdpc, int sdh, int dq, int mtt,
    int lfnst, int cclm, int cu64,
    const void* src_y, const void* src_cb, const void* src_cr,
    const void* cin_y, const void* cin_cb, const void* cin_cr,
    const void* size_map, const void* mode_map, const void* mts_map,
    void* rec_y, void* rec_cb, void* rec_cr, void* cout_y, void* cout_cb,
    void* cout_cr, const void* taps, const void* smooth, const void* tx,
    const void* shift, const void* rate, const void* mip,
    const void* lfnst_tab, void* mts_out, void* sync, void* stream) {
  const void* src[3] = {src_y, src_cb, src_cr};
  const void* cin[3] = {cin_y, cin_cb, cin_cr};
  void* rec[3] = {rec_y, rec_cb, rec_cr};
  void* cout[3] = {cout_y, cout_cb, cout_cr};
  Params p;
  set_common(p, frames, width, height, pitch_y, pitch_c, plane_y,
             plane_c, qp, lam, rdoq, mts, subst, n_modes, src, cin, size_map,
             mode_map, mts_map, rec, cout, taps, smooth, tx, shift, rate);
  p.lossless = lossless; p.ts = ts; p.pdpc = pdpc;
  p.dq = dq;
  p.mtt = mtt; p.lfnst = lfnst;
  p.cclm = cclm; p.sdh = sdh;
  p.mip = (const int32_t*)mip;
  p.lfnst_tab = (const int32_t*)lfnst_tab;
  p.sync = (int*)sync;
  p.mts_out = cclm && encode ? (int32_t*)mts_out : nullptr;
  if (cu64) return x266_recon_cu64(&p, encode, stream);
  if (cclm) return x266_recon_cclm(&p, encode, stream);
  if (dq || (sdh && encode)) return x266_recon_quant(&p, 0, 0, encode, stream);
  return launch<false>(p, encode, stream);
}

// Launches K3-P on one P picture, or K3-B on one B picture when pyr1_y is
// not null (encode != 0: the encoder's form), on `stream`; returns
// cudaGetLastError().  Arguments as x266_recon_intra (the intra tools'
// lossless, ts, pdpc and the MIP table `mip` included), plus the inter
// maps, the reference's three pyramids (16, Hp, Wp), the final-MV planes
// (int16, H/8 x W/8), for K3-B the L1 pyramids (the shapes of L0's) and
// the mvx1/mvy1 maps (int32, H/8 x W/8), and the scratch `sync` of 1 +
// CTU rows int32.  Under lossless an inter CU's level is the source minus
// its MC prediction and a skip CU's is 0 (recon = clip(prediction)); the
// intra CUs of a P or B picture take K1's PDPC and MIP branches; their
// mts map is 0, so no TU of a P or B picture takes transform skip.
int x266_recon_inter(
    int encode, int width, int height, int pitch_y, int pitch_c,
    int plane_y, int plane_c, int qp, float lam, int rdoq, int mts, int subst,
    int n_modes, int lossless, int ts, int pdpc, int sdh, int dq, int merge,
    int pyr_hy,
    int pyr_wy, int pyr_hc, int pyr_wc,
    const void* src_y, const void* src_cb, const void* src_cr,
    const void* cin_y, const void* cin_cb, const void* cin_cr,
    const void* size_map, const void* mode_map, const void* mts_map,
    const void* pred_map, const void* mvx_map, const void* mvy_map,
    const void* pyr_y, const void* pyr_cb, const void* pyr_cr,
    void* rec_y, void* rec_cb, void* rec_cr, void* cout_y, void* cout_cb,
    void* cout_cr, void* mv_x, void* mv_y, const void* taps,
    const void* smooth, const void* tx, const void* shift, const void* rate,
    const void* mip, const void* pyr1_y, const void* pyr1_cb, const void* pyr1_cr,
    const void* mvx1_map, const void* mvy1_map, void* sync, void* stream) {
  const void* src[3] = {src_y, src_cb, src_cr};
  const void* cin[3] = {cin_y, cin_cb, cin_cr};
  void* rec[3] = {rec_y, rec_cb, rec_cr};
  void* cout[3] = {cout_y, cout_cb, cout_cr};
  const void* pyr[3] = {pyr_y, pyr_cb, pyr_cr};
  Params p;
  set_common(p, 1, width, height, pitch_y, pitch_c, plane_y,
             plane_c, qp, lam, rdoq, mts, subst, n_modes, src, cin, size_map,
             mode_map, mts_map, rec, cout, taps, smooth, tx, shift, rate);
  set_inter(p, merge, pyr_hy, pyr_wy, pyr_hc, pyr_wc, pred_map, mvx_map,
            mvy_map, pyr, mv_x, mv_y);
  p.lossless = lossless; p.ts = ts; p.pdpc = pdpc;
  p.dq = dq;
  p.mip = (const int32_t*)mip;
  p.sync = (int*)sync;
  const bool quant = dq || (sdh && encode);
  if (pyr1_y == nullptr)
    return quant ? x266_recon_quant(&p, 1, 0, encode, stream)
                 : launch<true>(p, encode, stream);
  p.pyr[3] = (const uint8_t*)pyr1_y; p.pyr[4] = (const uint8_t*)pyr1_cb;
  p.pyr[5] = (const uint8_t*)pyr1_cr;
  p.mv1_map[0] = (const int32_t*)mvx1_map;
  p.mv1_map[1] = (const int32_t*)mvy1_map;
  return quant ? x266_recon_quant(&p, 1, 1, encode, stream)
               : launch<true, true>(p, encode, stream);
}

#ifdef X266_RECON_PHASES
int x266_recon_phases_quant(void* out);
int x266_recon_phases_cclm(void* out);
int x266_recon_phases_cu64(void* out);
int x266_recon_phases_cu64_cclm(void* out);

// The phase split's sums since the last call over the three parts
// (kPhaseSlots uint64: see Phase), copied to host memory `out`, then
// zeroed.
int x266_recon_phases(void* out) {
  for (int i = 0; i < kPhaseSlots; ++i)
    static_cast<unsigned long long*>(out)[i] = 0;
  int err = x266_recon_phases_main(out);
  if (err == 0) err = x266_recon_phases_quant(out);
  if (err == 0) err = x266_recon_phases_cclm(out);
  if (err == 0) err = x266_recon_phases_cu64(out);
  if (err == 0) err = x266_recon_phases_cu64_cclm(out);
  return err;
}
#endif

// The warp-scan substitution of one reference vector of side s (4, 8,
// 16, 32): ref and avail in [corner, top 2s, left 2s] order, out the
// substituted vector (4s + 1 int32).  A test entry for the host stand-in,
// where the pointers are host memory; returns the launch's error.
int x266_subst_scan(int s, const void* ref, const void* avail, void* out) {
  SubstTest a{s, (const int*)ref, (const uint8_t*)avail, (int*)out};
  void* args[] = {&a};
  void (*kernel)(SubstTest) = subst_test_kernel;
  return (int)cudaLaunchKernel(kernel, dim3(1), dim3(32), args, 0, nullptr);
}

const char* x266_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif  // X266_RECON_QUANT_PART, X266_RECON_CCLM_PART

}  // extern "C"
