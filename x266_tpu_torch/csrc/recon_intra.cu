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
// lie outside x0 - 1 .. x0 + 95.  Rows above are read through the L2
// (__ldcg), after the acquire.
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
// (kQPlain) are the code above unchanged.  Both stage the TU's
// coefficients in shared memory.  SDH: a lane a 4x4 group quantizes its
// 16 coefficients and makes the parity move.  DQ: the 4-state trellis's
// (4, 4) (min,+) matrices are combined in the tree of
// jax.lax.associative_scan (every prefix and suffix entry a float32 sum
// grouped as the reference groups it), going up as matrices and coming
// down as the two rows the trellis reads (the prefix's row 0 and the
// suffix's row minima); the states and the state-dependent dequantized
// values come from the emitted levels' parities by a warp scan of 4-state
// maps (also the decode's).  DQ's scratch is dynamic shared memory after
// Shared.
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

namespace {

constexpr int kThreads = 256;     // luma group 128, Cb 64, Cr 64
constexpr int kCtu = 64;
constexpr int kMaxSpins = 1 << 24;   // row wait cap, ~10 s at 64 ns a spin
constexpr int kWinY = 1 + 96;     // luma window: CTU origin -1 .. +95
constexpr int kWinC = 1 + 48;     // chroma window
constexpr int kPitchY = 100, kPitchC = 52;   // their row pitches (words)
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
enum Phase {
  kPhWait, kPhLoad, kPhMv, kPhStore, kPhRef, kPhSubst, kPhExt, kPhPred,
  kPhFwd, kPhQuant, kPhDeq, kPhInvV, kPhInvH, kPhCu, kPhBlock, kPhases = 16
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
  // K3-P and K3-B only (frames == 1)
  int merge;                      // merge candidates on
  const int32_t *pred_map, *mvx_map, *mvy_map;   // (H/8, W/8)
  const uint8_t* pyr[6];          // (16, Hp, Wp) L0 Y, Cb, Cr; L1 (K3-B)
  int pyr_h[2], pyr_w[2];         // luma, chroma pyramid plane sizes
  int16_t* mv_out[2];             // final MVs (H/8, W/8)
  const int32_t* mv1_map[2];      // K3-B: a bi CU's L1 MV (H/8, W/8)
  int* sync;                      // row ticket, then progress per row
};

// Offsets of size s in the flat tables (sizes 4, 8, 16, 32 in order).
constexpr int kTxPerType = 16 + 64 + 256 + 1024;
constexpr int kSmooth = (17 + 33 + 65 + 129) * 3;

__device__ __forceinline__ int size_index(int s) {
  return s == 4 ? 0 : s == 8 ? 1 : s == 16 ? 2 : 3;
}

__device__ __forceinline__ int tx_offset(int s) {
  return s == 4 ? 0 : s == 8 ? 16 : s == 16 ? 80 : 336;
}

__device__ __forceinline__ int smooth_offset(int s) {
  return s == 4 ? 0 : s == 8 ? 17 * 3 : s == 16 ? (17 + 33) * 3
                                               : (17 + 33 + 65) * 3;
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

// One warp's reference scratch: [substituted refs, smoothed refs] and the
// MIP group sums.
struct Refs {
  int ext[2 * kMaxR];
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

struct Shared {
  // the windows: the CTU, the row above and the column to the left
  alignas(16) uint8_t win_y[kWinY * kPitchY];
  alignas(16) uint8_t win_c[2][kWinC * kPitchC];
  // tables, once per launch: the transform matrices [k][n], transposed
  int8_t tx[2][3 * kTxPerType];
  int smooth[kSmooth];
  int shift[4 * kMaxModes];
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
  uint8_t rsrc_y[64][kMaxR];
  uint8_t rsrc_c[64][2 * 32 + 1];
  Cu cus[64];
  int n_cus;
  // per group: the TU's coefficients; per warp: its reference vector
  alignas(16) int a_y[32 * 32];
  alignas(16) int b_y[32 * 32];
  alignas(16) int a_c[2][16 * 16];
  alignas(16) int b_c[2][16 * 16];
  int lf_vec[3][16];              // per group: an LFNST input vector
  Refs refs[8];
};

// The quantizer of a recon kernel instance (a template parameter, so the
// instances without SDH or DQ compile to the code they had before them):
// element-wise (deadzone or RDOQ), sign-data hiding (encode only) or
// dependent quantization.
constexpr int kQPlain = 0, kQSdh = 1, kQDq = 2;

// Dependent quantization's scratch, after Shared in dynamic shared memory
// in the DQ instances: per group, the trellis's (min,+) matrices of tree
// levels 2 and up (n/2 - 1 of 16 floats for n = S*S positions) and each
// tree node's prefix row and suffix row minima of levels 1 and up (n - 1
// of 8 floats), luma n <= 1024, chroma n <= 256; then each group's warp
// totals of the state scan (4 words a group).
constexpr int dq_floats(int n) { return (n / 2 - 1) * 16 + (n - 1) * 8; }
constexpr int kDqLuma = dq_floats(1024), kDqChroma = dq_floats(256);
constexpr int kDqTot = kDqLuma + 2 * kDqChroma;
constexpr size_t kDqBytes = sizeof(float) * kDqTot + sizeof(uint32_t) * 12;

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
// position 32 w + l (left bottom->top, corner, top left->right).  Writes,
// for each entry i of [corner, top 2s, left 2s], the entry whose sample it
// takes: itself when available; else the last available one before it in
// the scan (__clz on the masked word, or the last word before it with one),
// for a leading gap the first available one; 255 (mid-gray) for an empty
// vector.  The serial scan's integers by construction.
__device__ void subst_sources(int s, const unsigned (&m)[5], uint8_t* src) {
  const int lane = threadIdx.x & 31;
  const int r_len = 4 * s + 1;
  int before[5], last = -1, first = -1;
#pragma unroll
  for (int w = 0; w < 5; ++w) {
    before[w] = last;
    if (m[w]) last = 32 * w + 31 - __clz((int)m[w]);
  }
#pragma unroll
  for (int w = 4; w >= 0; --w)
    if (m[w]) first = 32 * w + __ffs((int)m[w]) - 1;
#pragma unroll
  for (int w = 0; w < 5; ++w) {
    const int k = lane + 32 * w;
    if (k >= r_len) continue;
    int from = k;
    if (!((m[w] >> lane) & 1)) {
      const unsigned below = m[w] & ((1u << lane) - 1);
      from = below ? 32 * w + 31 - __clz((int)below) : before[w];
      if (from < 0) from = first;
    }
    src[scan_index(k, s)] = from < 0 ? 255 : scan_index(from, s);
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
__device__ void ref_sources(const Params& p, int x, int y, int s, int scale,
                            const BtvLeaf& leaf, uint8_t* src) {
  const int lane = threadIdx.x & 31;
  unsigned m[5];
#pragma unroll
  for (int w = 0; w < 5; ++w) {
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
// (entry i reads entry src[i]'s sample, mid-gray for 255, when src is
// given: substitution), the smoothed copy from 4S + 1, MIP's 16 group
// sums into r.grp; returns the DC sum (mode 1).
template <int S>
__device__ int build_refs(const Shared& sh, const View& v, Refs& r, int x,
                          int y, int mode, bool mip,
                          const uint8_t* src X266_PH_PARAM) {
  constexpr int r_len = 4 * S + 1;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w * 32 < r_len; ++w) {
    const int i = lane + 32 * w;
    if (i >= r_len) continue;
    const int j = src ? src[i] : i;
    int val = 128, px, py;
    if (j != 255) {
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
    if (lane < S) dc = r.ext[1 + lane] + r.ext[1 + 2 * S + lane];
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
  static constexpr int kLog2 = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
};

// A column pass, out[k] = sum_j W(row_k, j) * in[j][col], W(r, j) =
// t[r * S + j] (forward vertical) or t[j * S + r] (inverse vertical,
// kTrans); in from `in` (int, pitch S) or, kLev, the dequantized staged
// levels lev (pitch sp).
template <int S, int K, int kStep, bool kTrans, bool kLev>
__device__ __forceinline__ void column_pass(int row0, int col,
                                            const int8_t* t, const int* in,
                                            const int16_t* lev, int sp,
                                            int dscale, int ishift,
                                            int (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
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
}

// A row pass, out[k] = sum_j in[row_k][j] * t[j * S + col], the row's
// entries four at a time in 16-byte loads.
template <int S, int K, int kStep>
__device__ __forceinline__ void row_pass(int row0, int col, const int8_t* t,
                                         const int* in, int (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0;
#pragma unroll
  for (int j = 0; j < S; j += 4) {
    const int t0 = t[j * S + col], t1 = t[(j + 1) * S + col];
    const int t2 = t[(j + 2) * S + col], t3 = t[(j + 3) * S + col];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int4 v = *reinterpret_cast<const int4*>(
          in + (row0 + k * kStep) * S + j);
      out[k] += v.x * t0 + v.y * t1 + v.z * t2 + v.w * t3;
    }
  }
}

// ---- the TU-wide quantizers: sign-data hiding and dependent quantization
// (x266_tpu/kernels/quant.py:102-450; plain versions in kernels/quant.py)

// tu_scan (cabac/syntax.py): scan index i of a TU of side S is position
// kScan4[i & 15] of the 4x4 group at kScanCg[i >> 4] (diagonal orders,
// x | y << 4), the groups of a side-S TU at offset S/4 - 1 + ...
__constant__ uint8_t kScan4[16] = {0, 16, 1, 32, 17, 2, 48, 33,
                                   18, 3, 49, 34, 19, 50, 35, 51};
__constant__ uint8_t kScanCg[1 + 4 + 16 + 64] = {
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
  const int g = kScanCg[base + (i >> 4)], e = kScan4[i & 15];
  return ((g >> 4) * 4 + (e >> 4)) * S + (g & 15) * 4 + (e & 15);
}

// RDOQ's rate of level l (0 <= l <= 32767).
__device__ __forceinline__ float rate_of(const Params& p, const Shared& sh,
                                         int l) {
  return l < kRateShared ? sh.rate[l] : __ldg(p.rate + l);
}

// The element-wise quantizer's level of |coefficient| aa: RDOQ (the level
// of {0, l_dn, l_up} of least e*e*err_scale + lam*rate) or the deadzone
// one; qbits, qscale, dscale and ishift of the TU's size and QP.
__device__ __forceinline__ int quant_mag(const Params& p, const Shared& sh,
                                         int aa, int qbits, int qscale,
                                         int dscale, int ishift, int tsh) {
  if (p.rdoq) {
    const int lup = clampi((aa * qscale + (1 << (qbits - 1))) >> qbits, 0,
                           32767);
    const int ldn = lup > 0 ? lup - 1 : 0;
    const float err_scale = ldexpf(1.0f, -2 * tsh);
    auto cost = [&](int l) {
      const int d = clampi((l * dscale + (1 << (ishift - 1))) >> ishift,
                           -32768, 32767);
      const float e = (float)(aa - d);
      return __fadd_rn(__fmul_rn(__fmul_rn(e, e), err_scale),
                       __fmul_rn(p.lam, rate_of(p, sh, l)));
    };
    const float c0 = cost(0), cd = cost(ldn), cu = cost(lup);
    const int lbest = cu <= cd ? lup : ldn;
    return fminf(cu, cd) <= c0 ? lbest : 0;
  }
  const int add = 171 << (qbits - 9);
  return clampi((aa * qscale + add) >> qbits, 0, 32767);
}

constexpr int kSdhSpan = 4;
constexpr float kSdhBig = 3.4e38f;

// Sign-data hiding on 4x4 group cg (scan order) of a side-S TU: its 16
// levels from the coefficients `coef` (raster, pitch S) by quant_mag,
// then, where the group's first and last significant scan positions are
// >= 4 apart and the first one's sign disagrees with the parity of the
// group's absolute sum, the +-1 move in [first, last] of least D + lam*R
// increase that zeroes neither end (ties: the -1 move, then the first
// position); the levels into `lev` (raster, pitch S).
template <int S>
__device__ X266_NOINLINE void sdh_group(const Params& p, const Shared& sh,
                                        int cg, const int* coef, int* lev,
                                        int tsh) {
  const int qbits = 14 + p.qp / 6 + tsh;
  const int qscale = kQuantScale[p.qp % 6];
  const int ishift = 6 - tsh;
  const int dscale = kDequantScale[p.qp % 6] << (p.qp / 6);
  const float err_scale = ldexpf(1.0f, -2 * tsh);
  int v[16], c[16], r[16];
  int first = -1, last = -1, sum = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    r[k] = scan_raster<S>(cg * 16 + k);
    c[k] = coef[r[k]];
    const int m = quant_mag(p, sh, c[k] < 0 ? -c[k] : c[k], qbits, qscale,
                            dscale, ishift, tsh);
    v[k] = c[k] < 0 ? -m : (c[k] > 0 ? m : 0);
    if (v[k] != 0) {
      if (first < 0) first = k;
      last = k;
    }
    sum += v[k] < 0 ? -v[k] : v[k];
  }
  if (first >= 0 && last - first >= kSdhSpan &&
      (v[first] < 0) != ((sum & 1) == 1)) {
    auto rdcost = [&](int l, int cc) {
      const int d = clampi((l * dscale + (1 << (ishift - 1))) >> ishift,
                           -32768, 32767);
      const float e = (float)(d - cc);
      return __fadd_rn(__fmul_rn(__fmul_rn(e, e), err_scale),
                       __fmul_rn(p.lam, rate_of(p, sh, l < 0 ? -l : l)));
    };
    float best = 0.0f;
    int pos = 0, nv_best = 0;
    for (int k = 0; k < 16; ++k) {
      const float e0 = rdcost(v[k], c[k]);
      float dl[2];
      int nv[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        nv[q] = clampi(v[k] + (q ? 1 : -1), -32767, 32767);
        const bool ok = k >= first && k <= last &&
                        !(nv[q] == 0 && (k == first || k == last)) &&
                        nv[q] != v[k];
        dl[q] = ok ? __fsub_rn(rdcost(nv[q], c[k]), e0) : kSdhBig;
      }
      const int q = dl[1] < dl[0];
      if (k == 0 || dl[q] < best) {
        best = dl[q];
        pos = k;
        nv_best = nv[q];
      }
    }
    v[pos] = nv_best;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) lev[r[k]] = v[k];
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

__device__ __forceinline__ DqPos dq_pos(const Params& p, const Shared& sh,
                                        int a, int tsh) {
  const int qbits = 14 + p.qp / 6 + tsh;
  const int qscale = kQuantScale[p.qp % 6];
  const int ishift = 6 - tsh;
  const int dscale = kDequantScale[p.qp % 6] << (p.qp / 6);
  const float err_scale = ldexpf(1.0f, -2 * tsh);
  DqPos r;
#pragma unroll
  for (int q1 = 0; q1 < 2; ++q1) {
    const int u = (a * qscale + (1 << (qbits - 2))) >> (qbits - 1);
    const int kup = clampi((u + q1 + 1) >> 1, 0, 32767);
    const int kdn = kup > 0 ? kup - 1 : 0;
    auto cost = [&](int k) {
      const int d = ((2 * k - (k > 0 ? q1 : 0)) * dscale + (1 << ishift)) >>
                    (ishift + 1);
      const float e = (float)(a - d);
      return __fadd_rn(__fmul_rn(__fmul_rn(e, e), err_scale),
                       __fmul_rn(p.lam, rate_of(p, sh, k)));
    };
    const float cu = cost(kup), cd = cost(kdn), c0 = cost(0);
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

// The position's (4, 4) (min,+) transition matrix: M[s][next(s, p)] =
// c[s >= 2][p], kDqBig elsewhere.
__device__ __forceinline__ void dq_matrix(const DqPos& d, float* m) {
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = kDqBig;
#pragma unroll
  for (int st = 0; st < 4; ++st)
#pragma unroll
    for (int par = 0; par < 2; ++par)
      m[st * 4 + dq_next(st, par)] = fminf(kDqBig, d.c[st >= 2][par]);
}

// (min,+) products: of two matrices, row vector by matrix, and the row
// minima of a matrix times a vector of row minima (min_x min_c (A[a][x] +
// B[x][c]) = min_x (A[a][x] + min_c B[x][c]): rounding is monotonic).
__device__ __forceinline__ void mp_mat(const float* a, const float* b,
                                       float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float m = __fadd_rn(a[i * 4], b[c]);
#pragma unroll
      for (int x = 1; x < 4; ++x) m = fminf(m, __fadd_rn(a[i * 4 + x], b[x * 4 + c]));
      out[i * 4 + c] = m;
    }
}

__device__ __forceinline__ float mp_vec_mat(const float* v, const float* m,
                                            int c) {
  float r = __fadd_rn(v[0], m[c]);
#pragma unroll
  for (int x = 1; x < 4; ++x) r = fminf(r, __fadd_rn(v[x], m[x * 4 + c]));
  return r;
}

__device__ __forceinline__ float mp_mat_vec(const float* m, const float* v,
                                            int a) {
  float r = __fadd_rn(m[a * 4], v[0]);
#pragma unroll
  for (int x = 1; x < 4; ++x) r = fminf(r, __fadd_rn(m[a * 4 + x], v[x]));
  return r;
}

__device__ __forceinline__ float row_min(const float* m, int a) {
  return fminf(fminf(m[a * 4], m[a * 4 + 1]), fminf(m[a * 4 + 2], m[a * 4 + 3]));
}

// The first index of the least of v[b] + t[b] (t null: zeros).
__device__ __forceinline__ int argmin_sum(const float* v, const float* t) {
  int best = 0;
  float m = t ? __fadd_rn(v[0], t[0]) : v[0];
#pragma unroll
  for (int b = 1; b < 4; ++b) {
    const float x = t ? __fadd_rn(v[b], t[b]) : v[b];
    if (x < m) {
      m = x;
      best = b;
    }
  }
  return best;
}

// Node b of a tree level of nl nodes (matrix m), output o: o < 4 entry o
// of its prefix's row 0, else entry o - 4 of its suffix's row minima, from
// the level above's rows `up` (8 floats a node: prefix row 0, suffix row
// minima).  The grouping of jax.lax.associative_scan (the prefix of an
// odd node is its parent's, of an even one its parent's left neighbour's
// times the node; the suffix of an even node is its parent's, of an odd
// one the node times its right neighbour's parent's; a level's first
// prefix and last suffix are the node's own).
__device__ __forceinline__ float dq_down(const float* m, const float* up,
                                         int b, int nl, int o) {
  if (o < 4) {
    if (b == 0) return m[o];
    if (b & 1) return up[8 * (b >> 1) + o];
    return mp_vec_mat(up + 8 * (b / 2 - 1), m, o);
  }
  const int a = o - 4;
  if (b == nl - 1) return row_min(m, a);
  if (!(b & 1)) return up[8 * (b >> 1) + 4 + a];
  return mp_mat_vec(m, up + 8 * ((b + 1) >> 1) + 4, a);
}

// Offsets (in nodes) of tree level l in the scratch: matrices of levels
// >= 2, rows of levels >= 1.
__device__ __forceinline__ int dq_mat_off(int n, int l) {
  return (n >> 1) - (n >> (l - 1));
}
__device__ __forceinline__ int dq_vec_off(int n, int l) {
  return n - (n >> (l - 1));
}

// Dependent quantization of a side-S TU on its G threads (lt): the exact
// 4-state trellis of quant.py's dq_quantize_trellis over the coefficients
// `coef` (raster, pitch S) in coding order (the reverse scan), the levels
// into `lev` (raster).  Each position's costs are recomputed where they
// are needed (the same integers and float32 ops each time).  The tree:
// level 1 pairs positions, level l + 1 pairs level l's nodes; going up,
// threads take quads (level 2) and then a matrix entry each; coming down,
// each node's prefix row 0 and suffix row minima -- all the trellis reads
// of a product -- from the level above; level 0 reads each position's
// state after it (argmin of prefix row 0 + the next suffix's row minima,
// first on ties), the state before it, and so its quantizer and parity.
// `scratch`: the group's DQ scratch.  Ends before the caller's barrier.
template <int S, int G>
__device__ X266_NOINLINE void dq_trellis(const Params& p, const Shared& sh,
                                         const Group& g, bool small, int lt,
                                         const int* coef, int* lev,
                                         float* scratch, int tsh) {
  constexpr int n = S * S;
  constexpr int L = S == 4 ? 4 : S == 8 ? 6 : S == 16 ? 8 : 10;   // log2 n
  float* mats = scratch;
  float* vecs = scratch + 16 * (n / 2 - 1);
  auto pos = [&](int j) { return scan_raster<S>(n - 1 - j); };
  auto costs = [&](int j) {
    const int c = coef[pos(j)];
    return dq_pos(p, sh, c < 0 ? -c : c, tsh);
  };
  // up: level 2 from quads of positions
  for (int i = lt; i < n / 4; i += G) {
    float m0[16], m1[16], la[16], lb[16];
    dq_matrix(costs(4 * i), m0);
    dq_matrix(costs(4 * i + 1), m1);
    mp_mat(m0, m1, la);
    dq_matrix(costs(4 * i + 2), m0);
    dq_matrix(costs(4 * i + 3), m1);
    mp_mat(m0, m1, lb);
    mp_mat(la, lb, mats + 16 * i);
  }
  group_sync(g, small);
  for (int l = 3; l <= L; ++l) {
    const float* src = mats + 16 * dq_mat_off(n, l - 1);
    float* dst = mats + 16 * dq_mat_off(n, l);
    for (int e = lt; e < (n >> l) * 16; e += G) {
      const int i = e >> 4, a = (e >> 2) & 3, c = e & 3;
      const float* x = src + 32 * i;
      float m = __fadd_rn(x[a * 4], x[16 + c]);
#pragma unroll
      for (int k = 1; k < 4; ++k)
        m = fminf(m, __fadd_rn(x[a * 4 + k], x[16 + k * 4 + c]));
      dst[16 * i + a * 4 + c] = m;
    }
    group_sync(g, small);
  }
  // down: the root's rows, then levels L - 1 .. 2
  if (lt < 8) {
    const float* t = mats + 16 * dq_mat_off(n, L);
    vecs[8 * dq_vec_off(n, L) + lt] = lt < 4 ? t[lt] : row_min(t, lt - 4);
  }
  group_sync(g, small);
  for (int l = L - 1; l >= 2; --l) {
    const int nl = n >> l;
    const float* m = mats + 16 * dq_mat_off(n, l);
    const float* up = vecs + 8 * dq_vec_off(n, l + 1);
    float* v = vecs + 8 * dq_vec_off(n, l);
    for (int e = lt; e < nl * 8; e += G)
      v[e] = dq_down(m + 16 * (e >> 3), up, e >> 3, nl, e & 7);
    group_sync(g, small);
  }
  // level 1: each pair's product again
  for (int b = lt; b < n / 2; b += G) {
    float m0[16], m1[16], l1[16];
    dq_matrix(costs(2 * b), m0);
    dq_matrix(costs(2 * b + 1), m1);
    mp_mat(m0, m1, l1);
    const float* up = vecs + 8 * dq_vec_off(n, 2);
#pragma unroll
    for (int o = 0; o < 8; ++o) vecs[8 * b + o] = dq_down(l1, up, b, n / 2, o);
  }
  group_sync(g, small);
  // level 0: the states and the levels
  for (int i = lt; i < n / 2; i += G) {
    const DqPos d0 = costs(2 * i), d1 = costs(2 * i + 1);
    float m0[16], m1[16], alpha0[4], beta1[4];
    dq_matrix(d0, m0);
    dq_matrix(d1, m1);
    const float* v1 = vecs;                  // level 1's rows
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      alpha0[c] = i == 0 ? m0[c] : mp_vec_mat(v1 + 8 * (i - 1), m0, c);
      beta1[c] = i == n / 2 - 1 ? row_min(m1, c)
                                : mp_mat_vec(m1, v1 + 8 * (i + 1) + 4, c);
    }
    const int s0 = argmin_sum(alpha0, beta1);
    const int s1 = argmin_sum(v1 + 8 * i,
                              i + 1 < n / 2 ? v1 + 8 * (i + 1) + 4 : nullptr);
    const int sb = i == 0 ? 0 : argmin_sum(v1 + 8 * (i - 1), v1 + 8 * i + 4);
    const int st[3] = {sb, s0, s1};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const DqPos& d = h ? d1 : d0;
      const int before = st[h], after = st[h + 1];
      const int k = d.k[before >= 2][dq_next(before, 1) == after];
      const int r = pos(2 * i + h);
      const int c = coef[r];
      lev[r] = c < 0 ? -k : (c > 0 ? k : 0);
    }
  }
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
  auto at = [&](int j, int& r) {
    const int i = scan_raster<S>(n - 1 - j);
    r = i;
    return (int)lev[(i / S) * pitch + (i & (S - 1))];
  };
  uint32_t m = kDqId;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lt * C + c;
    int r;
    if (j < n) m = dq_compose(m, (at(j, r) & 1) ? kDqP1 : kDqP0);
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
    const int j = lt * C + c;
    if (j >= n) continue;
    int r;
    const int k = at(j, r);
    const int a = k < 0 ? -k : k;
    const int mag = ((2 * a - (a > 0 && s >= 2 ? 1 : 0)) * dscale +
                     (1 << ishift)) >> (ishift + 1);
    const int v = mag < 32767 ? mag : 32767;
    out[r] = k < 0 ? -v : (k > 0 ? v : 0);
    s = dq_next(s, a & 1);
  }
  group_sync(g, small);
}

// The arguments of one TU: plane coords (x, y) of a CU of the CTU at plane
// origin (x0, y0) (its inputs are staged at (x - x0, y - y0), row pitch 64
// luma, 32 chroma), its mode, prediction shift, transform types,
// transform skip, kind, whether its staged levels are non-zero (decode),
// whether the group meets first (a small TU came just before), its
// substitution sources (nullptr without substitution) and its LFNST (Cu::lf).
struct TuArgs {
  int x, y, x0, y0, mode, shift, tv, th, lf;
  bool ts;
  int kind;
  bool nz, sync_first;
  const uint8_t* src;
  int f;
};

// LFNST (x266_tpu/kernels/lfnst.py:81-105) on the low 4x4 of a TU: entry
// vi of the 16x16 kernel of lf (Cu::lf) times the vector vec, or of its
// transpose for the inverse, rounded at 1 << 7 and clipped: exact int32
// (|m| <= 127, |v| <= 2^15).  The thread owning coefficient (r, c) of the
// low 4x4 computes entry vi = r * 4 + c, or c * 4 + r where the mode
// transposes the region.
__device__ __forceinline__ int lfnst_index(int lf, int r, int c) {
  return (lf & 1) ? c * 4 + r : r * 4 + c;
}

__device__ __forceinline__ int lfnst_entry(const Shared& sh, int lf,
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
template <int S>
__device__ X266_NOINLINE void lfnst_inverse(const Shared& sh, const Group& g,
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
// other warps out).
// A plane group's DQ scratch (kDqBytes after Shared, DQ instances only).
__device__ __forceinline__ float* dq_scratch(Shared& sh, const View& v) {
  return reinterpret_cast<float*>(&sh + 1) +
         (v.plane == 0 ? 0 : kDqLuma + (v.plane - 1) * kDqChroma);
}

template <bool kEncode, int S, int G, int kQ, bool kMl>
__device__ void tu(const Params& p, Shared& sh, const View& v,
                   const Group& g, const TuArgs& a) {
  using M = Map<S, G>;
  constexpr int K = M::kK, kStep = M::kStep, kLog2 = M::kLog2;
  constexpr bool kSmall = S * S <= 64;
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
  Refs& r = sh.refs[threadIdx.x >> 5];
  X266_PH_START(pc, (v.plane * 4 + size_index(S)) * kPhases, g.lt == 0);
  X266_PH_COUNT(v.plane * 4 + size_index(S), g.lt == 0);

  // the angular taps of this thread's samples, in flight while the
  // reference vector is built
  const bool taps = !is_mc && !mip && mode != 1;
  int4 tp[K];
  if (taps && active) {
    const int4* t4 = reinterpret_cast<const int4*>(
        p.taps + taps_offset(S, p.n_std)) + mode * S * S;
#pragma unroll
    for (int k = 0; k < K; ++k)
      tp[k] = x266_ldg_early(t4 + (row0 + k * kStep) * S + col);
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
      const int4 e = tp[k];
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
      // forward vertical: b[k][m] = sum_j Tv[k][j] a[j][m]
      if (active) {
        column_pass<S, K, kStep, false, false>(row0, col, tvm, sa, nullptr,
                                               0, 0, 1, acc);
#pragma unroll
        for (int k = 0; k < K; ++k)
          sb[(row0 + k * kStep) * S + col] = rshift_round(acc[k], kLog2 - 1);
      }
      group_sync(g, kSmall);
      X266_PH(pc, kPhFwd);
      // forward horizontal: c[k][l] = sum_j b[k][j] Th[l][j]
      if (active) {
        row_pass<S, K, kStep>(row0, col,
                              sh.tx[1] + a.th * kTxPerType + tx_offset(S), sb,
                              acc);
#pragma unroll
        for (int k = 0; k < K; ++k)
          c[k] = clampi(rshift_round(acc[k], kLog2 + 6), -32768, 32767);
      }
      if (kMl && a.lf) {
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
      // b (SDH: a lane a 4x4 group; DQ: the trellis on the TU's threads),
      // under DQ the state-dependent dequantized values into a
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (active) sa[(row0 + k * kStep) * S + col] = c[k];
      group_sync(g, kSmall);
      if constexpr (kQ == kQDq)
        dq_trellis<S, G>(p, sh, g, kSmall, lt, sa, sb, dq_scratch(sh, v),
                         tsh);
      else
        for (int cg = lt; cg < S * S / 16; cg += G)
          sdh_group<S>(p, sh, cg, sa, sb, tsh);
      group_sync(g, kSmall);
      if constexpr (kQ == kQDq)
        dq_dequant<S, G>(sh, g, kSmall, lt, v.plane, sb, S, sa, dscale,
                         ishift);
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
      const int qbits = 14 + p.qp / 6 + tsh;
      const int qscale = kQuantScale[p.qp % 6];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!active) continue;
        const int cc = c[k];
        int lv = quant_mag(p, sh, cc < 0 ? -cc : cc, qbits, qscale, dscale,
                           ishift, tsh);
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
  if (kMl && inverse && a.lf)
    lfnst_inverse<S>(sh, g, kSmall, a.lf, row0, col, sa);
  if (inverse) {
    // inverse vertical: b[n][m] = clip((sum_k Tv[k][n] a[k][m] + 64) >> 7)
    if (active) {
      if (lev)
        column_pass<S, K, kStep, true, true>(row0, col, tvm, sa, lev, sp,
                                             dscale, ishift, acc);
      else
        column_pass<S, K, kStep, true, false>(row0, col, tvm, sa, nullptr, 0,
                                              0, 1, acc);
#pragma unroll
      for (int k = 0; k < K; ++k)
        sb[(row0 + k * kStep) * S + col] =
            clampi(rshift_round(acc[k], 7), -32768, 32767);
    }
    group_sync(g, kSmall);
    X266_PH(pc, kPhInvV);
    // inverse horizontal
    if (active) {
      row_pass<S, K, kStep>(row0, col, thm, sb, acc);
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
// warp, 16 on 64 threads).
template <bool kEncode, int kQ, bool kMl>
__device__ __forceinline__ void plane_tu(const Params& p, Shared& sh,
                                         const View& v, const Group& g,
                                         int s, const TuArgs& a) {
  switch (v.plane == 0 ? (s == 8 ? 1 : s == 16 ? 3 : 4)
                       : (s == 4 ? 0 : s == 8 ? 1 : 2)) {
    case 0: tu<kEncode, 4, 32, kQ, kMl>(p, sh, v, g, a); break;
    case 1: tu<kEncode, 8, 32, kQ, kMl>(p, sh, v, g, a); break;
    case 2: tu<kEncode, 16, 64, kQ, kMl>(p, sh, v, g, a); break;
    case 3: tu<kEncode, 16, 128, kQ, kMl>(p, sh, v, g, a); break;
    default: tu<kEncode, 32, 128, kQ, kMl>(p, sh, v, g, a); break;
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
// else mid-gray.  The global loads go out first, one or two a thread, so
// that one round trip to the L2 covers them all.
__device__ void load_windows(const View& vy, const View& vcb,
                             const View& vcr, const uint8_t* rec_y,
                             const uint8_t* rec_cb, const uint8_t* rec_cr) {
  constexpr int ny = kWinY + kCtu, nc = kWinC + kCtu / 2;
  int off[2] = {-1, -1}, val[2] = {0, 0};
  uint8_t* win[2] = {nullptr, nullptr};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
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
    }
  }
  constexpr uint32_t kMid = 0x80808080u;
  for (int i = threadIdx.x; i < kWinY * kPitchY / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(vy.win)[i] = kMid;
  for (int i = threadIdx.x; i < kWinC * kPitchC / 4; i += kThreads) {
    reinterpret_cast<uint32_t*>(vcb.win)[i] = kMid;
    reinterpret_cast<uint32_t*>(vcr.win)[i] = kMid;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q)
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
// units) and inputs (encode: the source; decode: the levels and each
// unit's non-zero flags, into sh.unz, which the CTU before left zero).
template <bool kEncode, bool kInter, bool kB, bool kMl>
__device__ void stage_inputs(const Params& p, Shared& sh, int f, int cx,
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
    sh.mts[t] = in && (p.mts || p.ts || (kMl && (p.mtt || p.lfnst)))
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
template <bool kMl>
__device__ __forceinline__ int tu_units(const Params& p, const Shared& sh,
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
template <bool kEncode, bool kInter, bool kB, bool kMl>
__device__ void build_cus(const Params& p, Shared& sh, int cx, int cy) {
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
template <bool kB>
__device__ void stage_mc(const Params& p, Shared& sh, int cx, int cy) {
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
          bool kMl = false>
__global__ void __launch_bounds__(kThreads)
recon_kernel(Params p) {
  X266_DYNAMIC_SHARED(int4, smem);
  Shared& sh = *reinterpret_cast<Shared*>(smem);
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
  for (int i = tid; i < kSmooth; i += kThreads) sh.smooth[i] = __ldg(p.smooth + i);
  for (int i = tid; i < 4 * p.n_modes; i += kThreads)
    sh.shift[i] = __ldg(p.shift + i);
  for (int i = tid; i < kRateShared; i += kThreads) sh.rate[i] = __ldg(p.rate + i);
  for (int i = tid; kMl && p.lfnst && i < 8 * 256; i += kThreads) {
    const int v = __ldg(p.lfnst_tab + i);
    sh.lfnst[0][i] = (int8_t)v;
    sh.lfnst[1][(i & ~255) + (i & 15) * 16 + ((i >> 4) & 15)] = (int8_t)v;
  }
  if (tid < 64) sh.unz[tid] = 0;
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
    stage_inputs<kEncode, kInter, kB, kMl>(p, sh, f, cx, cy);
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
        ref_sources(p, x, y, s, 1, BtvLeaf{lx, ly, lf}, sh.rsrc_y[t]);
        ref_sources(p, x / 2, y / 2, s / 2, 2,
                    BtvLeaf{lx / 2, ly / 2, lf / 2}, sh.rsrc_c[t]);
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
    const View vy{sh.win_y, kWinY, kPitchY, x0 - 1, y0 - 1, w, h, 1, 0};
    const View vcb{sh.win_c[0], kWinC, kPitchC, x0 / 2 - 1, y0 / 2 - 1, cw,
                   ch, 2, 1};
    const View vcr{sh.win_c[1], kWinC, kPitchC, x0 / 2 - 1, y0 / 2 - 1, cw,
                   ch, 2, 2};
    load_windows(vy, vcb, vcr, rec_y, rec_c[0], rec_c[1]);
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
          plane_tu<kEncode, kQ, kMl>(
              p, sh, v, grp, s,
              TuArgs{px0 + cu.ux * unit, py0 + cu.uy * unit, px0, py0,
                     plane ? cu.mode_c : cu.mode,
                     plane ? cu.shift_c : cu.shift_y, plane ? 0 : cu.tv,
                     plane ? 0 : cu.th, plane ? 0 : cu.lf, !plane && cu.ts,
                     cu.kind,
                     ((cu.nz >> plane) & 1) != 0, !small && !synced,
                     !p.subst ? nullptr : plane ? sh.rsrc_c[t]
                                                : sh.rsrc_y[t], f});
        synced = !small;
      }
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

#ifndef X266_RECON_QUANT_PART
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
// final-MV planes) on the stream.  Every row must be resident at once on
// the card, or the launch is refused (cudaErrorInvalidConfiguration); so
// is a mode alphabet larger than the kernel's shift table
// (cudaErrorInvalidValue).
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
  if (err == cudaSuccess)
    err = cudaLaunchKernel(kernel, dim3(rows), dim3(kThreads), args, smem, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// An intra launch under MTT or LFNST takes the instances with their code
// (kMl, a template parameter like the quantizer, so the others compile
// without it); K3's never do (kMl = !kInter is then the default).
using KernelFn = void (*)(Params);

template <bool kEncode, bool kInter, bool kB, int kQ>
KernelFn instance(const Params& p) {
  return !kInter && (p.mtt || p.lfnst)
             ? recon_kernel<kEncode, kInter, kB, kQ, !kInter>
             : recon_kernel<kEncode, kInter, kB, kQ>;
}

#ifndef X266_RECON_QUANT_PART
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

#ifdef X266_RECON_QUANT_PART
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
#else
int x266_recon_quant(const void* params, int inter, int b, int encode,
                     void* stream);

// Launches K1 (encode != 0) or K2 on `stream`; `sync` is scratch of
// 1 + frames x CTU rows int32; lossless, ts and pdpc switch the intra
// tools on, and `mip` holds tables.k_mip; sdh (encode) and dq switch the
// quantizer, whose instances csrc/recon_quant.cu compiles; mtt takes the
// BT leaves of bits 4-5 of the mts map, lfnst the LFNST of bits 6-7 with
// the kernels `lfnst_tab` (tables.k_lfnst).  Returns cudaGetLastError().
int x266_recon_intra(
    int encode, int frames, int width, int height, int pitch_y, int pitch_c,
    int plane_y, int plane_c, int qp, float lam, int rdoq, int mts, int subst,
    int n_modes, int lossless, int ts, int pdpc, int sdh, int dq, int mtt,
    int lfnst,
    const void* src_y, const void* src_cb, const void* src_cr,
    const void* cin_y, const void* cin_cb, const void* cin_cr,
    const void* size_map, const void* mode_map, const void* mts_map,
    void* rec_y, void* rec_cb, void* rec_cr, void* cout_y, void* cout_cb,
    void* cout_cr, const void* taps, const void* smooth, const void* tx,
    const void* shift, const void* rate, const void* mip,
    const void* lfnst_tab, void* sync, void* stream) {
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
  p.mip = (const int32_t*)mip;
  p.lfnst_tab = (const int32_t*)lfnst_tab;
  p.sync = (int*)sync;
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
// The phase split's sums since the last call (kPhaseSlots uint64: see
// Phase), copied to host memory `out`, then zeroed.
int x266_recon_phases(void* out) {
  static const unsigned long long zero[kPhaseSlots] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_recon_phases, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_recon_phases, zero, sizeof(zero));
  return (int)err;
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
#endif  // X266_RECON_QUANT_PART

}  // extern "C"
