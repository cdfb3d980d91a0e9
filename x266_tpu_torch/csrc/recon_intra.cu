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
// The design shortens the chain and keeps each step's latency short:
// - Schedule: a CTU-row wavefront.  The grid is frames x CTU rows, one
//   thread block per row.  A block takes its row from an atomic ticket
//   (so rows start in order whatever order the hardware runs blocks in,
//   and a block only ever waits on a row that started before it); before
//   CTU cx, thread 0 waits (acquire) until the row above has published
//   progress >= min(cx + 2, CTUs per row); after the CTU's stores every
//   thread fences, the block meets at a barrier and thread 0 publishes
//   progress cx + 1 (release).  So CTU (cx, cy) runs after (cx + 1,
//   cy - 1), the order d = cx + 2*cy that engine/recon_wave.py proves
//   bit-identical to the raster order; the longest chain is ctus_x +
//   2*(ctus_y - 1) CTUs (126 at 3840x2160 against 2,040 in raster order).
//   The ticket and the progress counters are an int32 buffer the launcher
//   zeroes on the stream; the launcher also zeroes the MV-state planes
//   and refuses a grid that does not fit the card's resident blocks.
// - Why it stays exact: load_window's `coded` predicate depends on
//   positions only, so samples of CTUs not yet coded read as mid-gray
//   whatever memory holds; store_window writes only the CTU itself;
//   above_mv reads only inside the CTU row and derive_mv only the left
//   unit.  No CTU of a diagonal touches another's window: (cx +- 2,
//   cy -+ 1) lie outside x0 - 1 .. x0 + 95.  Rows above are read through
//   the L2 (__ldcg), after the acquire.
// - Inside a block: its threads share out each TU's pixels and dot
//   products, and the current CTU's reconstruction window -- the CTU, the
//   row above and the column to the left, including the top-right and
//   bottom-left overhang -- sits in shared memory, loaded when the CTU
//   starts and written back to the output planes when it ends.  Samples
//   not yet coded (or outside the picture) hold mid-gray, which is the
//   reference's availability rule.

// The intra tools of _build_pallas (recon_pallas.py :248, :391-393,
// :503-534, :603-644, :688-689) are runtime fields of Params, like qp and
// lambda (the registers do not call for template parameters: the branches
// are uniform per TU and add no live state across the TU's steps):
// - lossless: steps 5-9 are skipped; encode writes level = source -
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
// Integer math is int32 multiply-accumulate (|residual x matrix| sums stay
// below 2^31).  RDOQ compares float32 costs e*e*err_scale + lam*rate with
// explicitly rounded __fmul_rn/__fadd_rn (and the library is built with
// -fmad=false), so no FMA contraction changes which level wins.  qp and
// lambda are runtime arguments.
//
// K3-P replaces the same Pallas kernel with inter=True, b_mode=False
// (make_recon_inter_pallas_raw, recon_pallas.py:1075-1152).  Its plain
// version is engine/inter.py (make_recon_inter_raw).  A P picture's CU is
// intra (K1's TU pipeline unchanged), inter (MC from the previous
// picture's 16-plane pyramids at the CU's MV, then the residual) or skip
// (MC at a derived MV, zero levels).  The skip MV comes from a unit
// MV-state plane -- the final-MV output planes themselves, in global
// memory: the left unit's MV if its CU is a coded-MV inter CU, else the
// above unit's while inside the CTU row's 8 unit rows, else (0, 0); skip
// CUs' own MVs are never predictors (one hop).  Under merge candidates
// the encoder takes the above rule when the mvx map holds 1 and the
// decoder the MV the entropy walker resolved.  MC reads the pyramid plane
// (mvy&3)*4 + (mvx&3) at x + REF_PAD + (mvx>>2); chroma uses mv >> 1 on
// the chroma pyramids.  Each CU writes its final MV over its units.  What
// bounds it is the same serial chain as K1, and P pictures depend on each
// other, so a launch holds one frame: one block walks the picture.
//
// K3-B replaces the same Pallas kernel with b_mode=True (recon_pallas.py
// :280-291, 587-592, 758-770, 858-868); its plain version is
// make_recon_inter_raw(..., b_mode=True).  It is K3-P's instantiation with
// a second reference: the L1 pyramids and the mvx1/mvy1 maps.  Kind
// PRED_L1 takes the pointer path from the L1 pyramid at the primary MV;
// PRED_BI hands tu() a second MC origin (L0 at the primary MV, L1 at mv1;
// chroma mv >> 1) and the prediction load forms (p0 + p1 + 1) >> 1.  L1
// and bi CUs are coded-MV CUs for the skip derivation, and the MV state
// holds their primary MV.  B pictures depend on their references, so one
// launch still holds one picture.
//
// The launch goes through cudaLaunchKernel rather than <<<...>>>, so this
// file is plain C++ apart from CUDA's built-ins: tests/test_torch_kernel_host.py
// compiles it with g++ against a host stand-in of the runtime
// (tests/cuda_host/cuda_runtime.h) and holds it against the plain scan.

#include <cstdint>
#include <cuda_runtime.h>

#include "x266_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCtu = 64;
constexpr int kMaxSpins = 1 << 24;   // row wait cap, ~10 s at 64 ns a spin
constexpr int kWinY = 1 + 96;     // luma window: CTU origin -1 .. +95
constexpr int kWinC = 1 + 48;     // chroma window
constexpr int kMaxS = 32;
constexpr int kMaxR = 4 * kMaxS + 1;
constexpr int kRefPad = 80;       // kernels/interp.py REF_PAD
constexpr int kIntra = 0, kSkip = 2, kL1 = 3, kBi = 4;  // inter.PRED_*

// specmodel.quant QUANT_SCALES / DEQUANT_SCALES
__constant__ int kQuantScale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
__constant__ int kDequantScale[6] = {40, 45, 51, 57, 64, 72};

struct Params {
  int frames, width, height;      // luma picture size
  int pitch_y, pitch_c;           // padded source plane widths (encode)
  int plane_y, plane_c;           // padded source plane sizes (encode)
  int qp, rdoq, mts, subst, n_modes;
  int n_std;                      // analytic modes (taps); MIP above
  int lossless, ts, pdpc;         // intra tools, see the header
  float lam;
  const uint8_t* src[3];          // encode: padded planes (F, Hp, Wp)
  const int16_t* coef_in[3];      // decode: levels (F, H, W)
  const int32_t *size_map, *mode_map, *mts_map;   // (F, H/8, W/8)
  uint8_t* rec[3];                // (F, H, W) / (F, H/2, W/2)
  int16_t* coef_out[3];           // encode: levels
  const int32_t *taps, *smooth, *tx, *shift;
  const int32_t* mip;             // (MIP_K, s*s, 16) for s = 8, 16, 32
  const float* rate;              // (32768,) rate surrogate
  // K3-P and K3-B only (frames == 1)
  int merge;                      // merge candidates on
  const int32_t *pred_map, *mvx_map, *mvy_map;   // (H/8, W/8)
  const uint8_t* pyr[6];          // (16, Hp, Wp) L0 Y, Cb, Cr; L1 (K3-B)
  int pyr_h[2], pyr_w[2];         // luma, chroma pyramid plane sizes
  int16_t* mv_out[2];             // final MVs (H/8, W/8); the MV state
  const int32_t* mv1_map[2];      // K3-B: a bi CU's L1 MV (H/8, W/8)
  int* sync;                      // row ticket, then progress per row
};

struct Shared {
  uint8_t win_y[kWinY * kWinY];
  uint8_t win_c[2][kWinC * kWinC];
  int ref[kMaxR];
  int ext[2 * kMaxR];
  uint8_t avail[kMaxR];
  int dc;
  int grp[16];                    // MIP boundary group sums
  int pred[kMaxS * kMaxS];
  int a[kMaxS * kMaxS];
  int b[kMaxS * kMaxS];
};

__device__ __forceinline__ int size_index(int s) {
  return s == 4 ? 0 : s == 8 ? 1 : s == 16 ? 2 : 3;
}

// Offsets of size s in the flat tables (sizes 4, 8, 16, 32 in order).
__device__ __forceinline__ int tx_offset(int s) {
  return s == 4 ? 0 : s == 8 ? 16 : s == 16 ? 80 : 336;
}
constexpr int kTxPerType = 16 + 64 + 256 + 1024;

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

__device__ __forceinline__ int z_index(int ux, int uy) {
  int z = 0;
  for (int b = 0; b < 3; ++b) {
    z |= ((ux >> b) & 1) << (2 * b);
    z |= ((uy >> b) & 1) << (2 * b + 1);
  }
  return z;
}

// engine.availability.decoded_before on luma coordinates.
__device__ __forceinline__ bool decoded_before(int px, int py, int bx,
                                               int by, int w, int h) {
  if (px < 0 || py < 0 || px >= w || py >= h) return false;
  int cp = (py / kCtu) * (1 << 20) + px / kCtu;
  int cb = (by / kCtu) * (1 << 20) + bx / kCtu;
  if (cp != cb) return cp < cb;
  return z_index((px % kCtu) / 8, (py % kCtu) / 8) <
         z_index((bx % kCtu) / 8, (by % kCtu) / 8);
}

__device__ __forceinline__ int rshift_round(int x, int sh) {
  return (x + (1 << (sh - 1))) >> sh;
}

__device__ __forceinline__ int mini(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One plane's view for a TU: the shared window and where it sits.
struct View {
  uint8_t* win;
  int wdim;            // window side
  int ox, oy;          // plane coords of window element (0, 0)
  int pw, ph;          // plane size
  int scale;           // 1 luma, 2 chroma
};

__device__ __forceinline__ uint8_t& at(const View& v, int x, int y) {
  return v.win[(y - v.oy) * v.wdim + (x - v.ox)];
}

// One TU at plane coords (x, y), size s.  All threads of the block call
// it with the same arguments.  mc: the top-left sample of an inter CU's
// MC block in its pyramid plane (row pitch mc_pitch), nullptr for intra;
// skip: an inter CU coded without residual (encode writes zero levels);
// mc1: a bi CU's second MC block (same pitch), averaged with mc's; ts: a
// luma TU coded with transform skip.
template <bool kEncode>
__device__ void tu(const Params& p, Shared& sh, const View& v, int x, int y,
                   int s, int mode, int tv, int th, const uint8_t* src,
                   int pitch, const int16_t* cin, int16_t* cout, int f,
                   const uint8_t* mc = nullptr, int mc_pitch = 0,
                   bool skip = false, const uint8_t* mc1 = nullptr,
                   bool ts = false) {
  const int tid = threadIdx.x;
  const int r_len = 4 * s + 1;
  const int mid = 128;
  const bool luma = v.scale == 1;
  const bool mip = mc == nullptr && mode >= p.n_std;   // luma only

  if (mc == nullptr) {
  // 1. reference vector [corner, top 2s, left 2s] and its availability
  for (int i = tid; i < r_len; i += kThreads) {
    int px, py;
    if (i == 0) { px = x - 1; py = y - 1; }
    else if (i <= 2 * s) { px = x + i - 1; py = y - 1; }
    else { px = x - 1; py = y + i - 1 - 2 * s; }
    sh.ref[i] = at(v, px, py);
    if (p.subst)
      sh.avail[i] = decoded_before(px * v.scale, py * v.scale, x * v.scale,
                                   y * v.scale, p.width, p.height);
  }
  __syncthreads();

  // 2. substitution: scan left bottom->top, corner, top left->right;
  //    a gap takes the nearest available sample before it in the scan,
  //    leading gaps the first available one, an empty vector mid-gray
  if (p.subst && tid == 0) {
    auto idx = [&](int k) { return k < 2 * s ? 4 * s - k
                                              : (k == 2 * s ? 0 : k - 2 * s); };
    int first = -1;
    for (int k = 0; k < r_len; ++k)
      if (sh.avail[idx(k)]) { first = k; break; }
    int last = first < 0 ? mid : sh.ref[idx(first)];
    for (int k = 0; k < r_len; ++k) {
      int i = idx(k);
      if (sh.avail[i]) last = sh.ref[i];
      else sh.ref[i] = last;
    }
  }
  __syncthreads();

  // 3. [raw, smoothed] extension; the DC sum
  const int* smt = p.smooth + smooth_offset(s);
  for (int i = tid; i < r_len; i += kThreads) {
    int acc = 0;
    for (int t = 0; t < 3; ++t) {
      int e = __ldg(smt + i * 3 + t);
      acc += (e & 255) * sh.ref[e >> 8];
    }
    sh.ext[i] = sh.ref[i];
    sh.ext[r_len + i] = (acc + 2) >> 2;
  }
  if (tid == 0 && mode == 1) {
    int acc = 0;
    for (int i = 0; i < s; ++i) acc += sh.ref[1 + i] + sh.ref[1 + 2 * s + i];
    sh.dc = acc;
  }
  if (mip && tid < 16) {
    // group tid: s/4 raw references of [top 2s, left 2s]
    const int g = s >> 2;
    int acc = 0;
    for (int j = 0; j < g; ++j) acc += sh.ref[1 + tid * g + j];
    sh.grp[tid] = acc;
  }
  __syncthreads();
  }

  // 4. prediction (intra, or the MC block); encode: residual into a
  const int n = s * s;
  const int log2s = 31 - __clz(s);
  const int shift = __ldg(p.shift + size_index(s) * p.n_modes + mode);
  // PDPC's mode class (specmodel.intra.pdpc_mode_class) and gates
  const bool pdpc = p.pdpc && luma && mc == nullptr;
  const int hm = p.n_std == 35 ? 10 : 18, vm = p.n_std == 35 ? 26 : 50;
  const int lok = x > 0, tok = y > 0;
  const int pscale = (2 * log2s - 2) >> 2;
  for (int i = tid; i < n; i += kThreads) {
    int pr;
    if (mc != nullptr) {
      const size_t o = (size_t)(i / s) * mc_pitch + i % s;
      pr = __ldg(mc + o);
      if (mc1 != nullptr) pr = (pr + __ldg(mc1 + o) + 1) >> 1;
    } else {
      int acc = 0;
      if (mip) {
        const int* m = p.mip + mip_offset(s) + ((mode - p.n_std) * n + i) * 16;
        for (int k = 0; k < 16; ++k) acc += __ldg(m + k) * sh.grp[k];
      } else if (mode == 1) {
        acc = sh.dc;
      } else {
        const int* tp = p.taps + taps_offset(s, p.n_std) + (mode * n + i) * 4;
        for (int t = 0; t < 4; ++t) {
          int e = __ldg(tp + t);
          acc += (e & 255) * sh.ext[e >> 8];
        }
      }
      pr = rshift_round(acc, shift);
      if (pdpc && (mode <= 1 || mode == hm || mode == vm)) {
        const int xx = i % s, yy = i / s;
        const int wl = (32 >> mini(31, (2 * xx) >> pscale)) * lok;
        const int wt = (32 >> mini(31, (2 * yy) >> pscale)) * tok;
        const int left = sh.ref[2 * s + 1 + yy], top = sh.ref[1 + xx];
        const int corner = sh.ref[0];
        if (mode <= 1)
          pr = (wl * left + wt * top + (64 - wl - wt) * pr + 32) >> 6;
        else if (lok && tok && mode == vm)
          pr = (64 * pr + wl * (left - corner) + 32) >> 6;
        else if (lok && tok)
          pr = (64 * pr + wt * (top - corner) + 32) >> 6;
      }
    }
    sh.pred[i] = pr;
    if (kEncode) sh.a[i] = src[(y + 1 + i / s) * pitch + x + 1 + i % s] - pr;
  }
  __syncthreads();

  const int cpitch = p.width / v.scale;
  const size_t cbase = (size_t)f * cpitch * (p.height / v.scale);
  if (p.lossless) {
    // no transform, no quantizer: the level is the residual
    for (int i = tid; i < n; i += kThreads) {
      const size_t o = cbase + (size_t)(y + i / s) * cpitch + x + i % s;
      int lv;
      if (kEncode) {
        lv = skip ? 0 : sh.a[i];
        cout[o] = (int16_t)lv;
      } else {
        lv = cin[o];
      }
      at(v, x + i % s, y + i / s) = (uint8_t)clampi(sh.pred[i] + lv, 0, 255);
    }
    __syncthreads();
    return;
  }

  const int* mv = p.tx + tv * kTxPerType + tx_offset(s);   // (s, s) [k][n]
  const int* mh = p.tx + th * kTxPerType + tx_offset(s);
  const int tsh = 7 - log2s;                               // 8-bit

  if (kEncode && skip) {
    for (int i = tid; i < n; i += kThreads) {
      sh.a[i] = 0;
      cout[cbase + (size_t)(y + i / s) * cpitch + x + i % s] = 0;
    }
  } else if (kEncode) {
    // 5. forward vertical: b[k][m] = sum_n Tv[k][n] a[n][m]
    for (int i = tid; i < n && !ts; i += kThreads) {
      int k = i / s, m = i % s, acc = 0;
      for (int j = 0; j < s; ++j) acc += __ldg(mv + k * s + j) * sh.a[j * s + m];
      sh.b[i] = rshift_round(acc, log2s - 1);
    }
    __syncthreads();
    // 6. forward horizontal (transform skip: the residual << tsh) +
    //    quantization: level into a, out to global
    const int qbits = 14 + p.qp / 6 + tsh;
    const int qscale = kQuantScale[p.qp % 6];
    const int ishift = 6 - tsh;
    const int dscale = kDequantScale[p.qp % 6] << (p.qp / 6);
    for (int i = tid; i < n; i += kThreads) {
      int k = i / s, l = i % s, c;
      if (ts) {
        c = sh.a[i] << tsh;
      } else {
        int acc = 0;
        for (int j = 0; j < s; ++j)
          acc += sh.b[k * s + j] * __ldg(mh + l * s + j);
        c = clampi(rshift_round(acc, log2s + 6), -32768, 32767);
      }
      int a = c < 0 ? -c : c;
      int lv;
      if (p.rdoq) {
        int lup = clampi((a * qscale + (1 << (qbits - 1))) >> qbits, 0, 32767);
        int ldn = lup > 0 ? lup - 1 : 0;
        float err_scale = ldexpf(1.0f, -2 * tsh);
        auto cost = [&](int l) {
          int dq = clampi((l * dscale + (1 << (ishift - 1))) >> ishift,
                          -32768, 32767);
          float e = (float)(a - dq);
          return __fadd_rn(__fmul_rn(__fmul_rn(e, e), err_scale),
                           __fmul_rn(p.lam, __ldg(p.rate + l)));
        };
        float c0 = cost(0), cd = cost(ldn), cu = cost(lup);
        int lev = cu <= cd ? lup : ldn;
        lv = fminf(cu, cd) <= c0 ? lev : 0;
      } else {
        int add = 171 << (qbits - 9);
        lv = clampi((a * qscale + add) >> qbits, 0, 32767);
      }
      lv = c < 0 ? -lv : (c > 0 ? lv : 0);
      sh.a[i] = lv;
      cout[cbase + (size_t)(y + k) * cpitch + x + l] = (int16_t)lv;
    }
  } else {
    for (int i = tid; i < n; i += kThreads)
      sh.a[i] = cin[cbase + (size_t)(y + i / s) * cpitch + x + i % s];
  }
  __syncthreads();

  // 7. dequantization, in place
  {
    const int ishift = 6 - tsh;
    const int dscale = kDequantScale[p.qp % 6] << (p.qp / 6);
    for (int i = tid; i < n; i += kThreads)
      sh.a[i] = clampi((sh.a[i] * dscale + (1 << (ishift - 1))) >> ishift,
                       -32768, 32767);
  }
  __syncthreads();

  // 8. inverse vertical: b[n][m] = clip((sum_k Tv[k][n] a[k][m] + 64) >> 7)
  for (int i = tid; i < n && !ts; i += kThreads) {
    int nn = i / s, m = i % s, acc = 0;
    for (int k = 0; k < s; ++k) acc += __ldg(mv + k * s + nn) * sh.a[k * s + m];
    sh.b[i] = clampi(rshift_round(acc, 7), -32768, 32767);
  }
  __syncthreads();

  // 9. inverse horizontal (transform skip: (dequantized + round) >> tsh),
  //    add the prediction, clip, write the window
  for (int i = tid; i < n; i += kThreads) {
    int nn = i / s, l = i % s, res;
    if (ts) {
      res = (sh.a[i] + (1 << (tsh - 1))) >> tsh;
    } else {
      int acc = 0;
      for (int m = 0; m < s; ++m)
        acc += sh.b[nn * s + m] * __ldg(mh + m * s + l);
      res = clampi(rshift_round(acc, 12), -32768, 32767);
    }
    at(v, x + l, y + nn) = (uint8_t)clampi(sh.pred[i] + res, 0, 255);
  }
  __syncthreads();
}

// Fill a plane's window for the CTU at plane origin (x0, y0): samples of
// earlier CTUs come from the output plane, everything else is mid-gray.
__device__ void load_window(const View& v, const uint8_t* rec, int x0,
                            int y0, int ctu) {
  for (int i = threadIdx.x; i < v.wdim * v.wdim; i += kThreads) {
    int px = v.ox + i % v.wdim, py = v.oy + i / v.wdim;
    bool coded = px >= 0 && py >= 0 && px < v.pw && py < v.ph &&
                 (py < y0 || (py < y0 + ctu && px < x0));
    v.win[i] = coded ? __ldcg(rec + (size_t)py * v.pw + px) : 128;
  }
}

__device__ void store_window(const View& v, uint8_t* rec, int x0, int y0,
                             int ctu) {
  for (int i = threadIdx.x; i < ctu * ctu; i += kThreads) {
    int px = x0 + i % ctu, py = y0 + i / ctu;
    if (px < v.pw && py < v.ph)
      rec[(size_t)py * v.pw + px] = at(v, px, py);
  }
}

// K3-P: the skip MV of the CU at unit (ux, uy) from the MV state.
__device__ __forceinline__ bool coded_mv(int kind) {
  return kind != kIntra && kind != kSkip;
}

__device__ void above_mv(const Params& p, int ux, int uy, int ux_n, int* mv) {
  if (uy > 0 && (uy & 7) != 0 && coded_mv(p.pred_map[(uy - 1) * ux_n + ux])) {
    mv[0] = p.mv_out[0][(uy - 1) * ux_n + ux];
    mv[1] = p.mv_out[1][(uy - 1) * ux_n + ux];
  } else {
    mv[0] = mv[1] = 0;
  }
}

__device__ void derive_mv(const Params& p, int ux, int uy, int ux_n,
                          int* mv) {
  if (ux > 0 && coded_mv(p.pred_map[uy * ux_n + ux - 1])) {
    mv[0] = p.mv_out[0][uy * ux_n + ux - 1];
    mv[1] = p.mv_out[1][uy * ux_n + ux - 1];
  } else {
    above_mv(p, ux, uy, ux_n, mv);
  }
}

// K3-P: an inter CU's MC block origin in pyramid plane (mvy&3)*4 + (mvx&3);
// the s x s block read from there must lie inside the plane.
__device__ __forceinline__ const uint8_t* mc_origin(const uint8_t* pyr, int h,
                                                    int w, int x, int y,
                                                    int mvx, int mvy, int s) {
  const int py = y + kRefPad + (mvy >> 2), px = x + kRefPad + (mvx >> 2);
  X266_ASSERT(py >= 0 && py + s <= h && px >= 0 && px + s <= w);
  return pyr + ((size_t)((mvy & 3) * 4 + (mvx & 3)) * h + py) * w + px;
}

template <bool kEncode, bool kInter, bool kB = false>
__global__ void __launch_bounds__(kThreads)
recon_kernel(Params p) {
  X266_SHARED(Shared, sh);
  X266_SHARED(int, ticket);
  const int w = p.width, h = p.height, cw = w / 2, ch = h / 2;
  const int ux_n = w / 8, uy_n = h / 8;
  const int ctus_x = (w + kCtu - 1) / kCtu, ctus_y = (h + kCtu - 1) / kCtu;
  if (threadIdx.x == 0) ticket = atomicAdd(p.sync, 1);
  __syncthreads();
  const int f = ticket / ctus_y, cy = ticket % ctus_y;
  int* progress = p.sync + 1 + (size_t)f * ctus_y;
  const size_t map_base = (size_t)f * ux_n * uy_n;
  uint8_t* rec_y = p.rec[0] + (size_t)f * w * h;
  uint8_t* rec_c[2] = {p.rec[1] + (size_t)f * cw * ch,
                       p.rec[2] + (size_t)f * cw * ch};
  const uint8_t* src_y = kEncode ? p.src[0] + (size_t)f * p.plane_y : nullptr;
  const uint8_t* src_c[2] = {
      kEncode ? p.src[1] + (size_t)f * p.plane_c : nullptr,
      kEncode ? p.src[2] + (size_t)f * p.plane_c : nullptr};

  for (int cx = 0; cx < ctus_x; ++cx) {
    if (cy > 0) {
      if (threadIdx.x == 0) {
        // tickets make the row above a running block, so the wait ends;
        // the cap (seconds) only keeps a fault from hanging the card
        const int need = cx + 2 < ctus_x ? cx + 2 : ctus_x;
        for (int spins = 0;
             x266_ld_acquire(progress + cy - 1) < need && spins < kMaxSpins;
             ++spins)
          __nanosleep(64);
      }
      __syncthreads();
    }
    const int x0 = cx * kCtu, y0 = cy * kCtu;
    View vy{sh.win_y, kWinY, x0 - 1, y0 - 1, w, h, 1};
    View vc[2] = {{sh.win_c[0], kWinC, x0 / 2 - 1, y0 / 2 - 1, cw, ch, 2},
                  {sh.win_c[1], kWinC, x0 / 2 - 1, y0 / 2 - 1, cw, ch, 2}};
    load_window(vy, rec_y, x0, y0, kCtu);
    for (int c = 0; c < 2; ++c)
      load_window(vc[c], rec_c[c], x0 / 2, y0 / 2, kCtu / 2);
    __syncthreads();
    for (int z = 0; z < 64; ++z) {
      int zx = (z & 1) | (((z >> 2) & 1) << 1) | (((z >> 4) & 1) << 2);
      int zy = ((z >> 1) & 1) | (((z >> 3) & 1) << 1) | (((z >> 5) & 1) << 2);
      int ux = cx * 8 + zx, uy = cy * 8 + zy;
      if (ux >= ux_n || uy >= uy_n) continue;
      size_t mi = map_base + (size_t)uy * ux_n + ux;
      int s = p.size_map[mi];
      int u = s >> 3;
      if ((ux & (u - 1)) || (uy & (u - 1))) continue;
      int mode = p.mode_map[mi];
      // chroma of a MIP CU predicts planar
      const int mode_c = mode >= p.n_std ? 0 : mode;
      // the map holds an MTS pair (0-4) or transform skip (5), read when
      // either tool is on
      const int mval = (p.mts || p.ts) ? (p.mts_map[mi] & 7) : 0;
      const bool ts = p.ts && mval == 5;
      const int mts = p.mts && !ts ? mini(mval, 4) : 0;
      // MTS combos (tables.MTS_COMBOS): (vertical, horizontal) types,
      // 0 DCT-II, 1 DST-VII, 2 DCT-VIII
      const int tvs[5] = {0, 1, 2, 1, 2}, ths[5] = {0, 1, 1, 2, 2};
      int x = ux * 8, y = uy * 8;
      const int kind = kInter ? p.pred_map[mi] : kIntra;
      const bool skip = kind == kSkip;
      int mv[2] = {0, 0};
      if (kInter) {
        if (!skip || (p.merge && !kEncode)) {
          mv[0] = p.mvx_map[mi];
          mv[1] = p.mvy_map[mi];
        } else if (p.merge && p.mvx_map[mi] == 1) {
          above_mv(p, ux, uy, ux_n, mv);     // merge candidate 1
        } else {
          derive_mv(p, ux, uy, ux_n, mv);
        }
      }
      const bool is_mc = kind != kIntra;
      // K3-B: an L1 CU predicts from the L1 pyramids (pyr[3..5]); a bi
      // CU adds the L1 block at its mv1 to the L0 block at its MV
      const uint8_t* const* pyr = p.pyr + (kB && kind == kL1 ? 3 : 0);
      const bool bi = kB && kind == kBi;
      int mv1[2] = {0, 0};
      if (bi) {
        mv1[0] = p.mv1_map[0][mi];
        mv1[1] = p.mv1_map[1][mi];
      }
      tu<kEncode>(p, sh, vy, x, y, s, mode, tvs[mts], ths[mts], src_y,
                  p.pitch_y, p.coef_in[0], p.coef_out[0], f,
                  is_mc ? mc_origin(pyr[0], p.pyr_h[0], p.pyr_w[0], x,
                                    y, mv[0], mv[1], s) : nullptr,
                  p.pyr_w[0], skip,
                  bi ? mc_origin(p.pyr[3], p.pyr_h[0], p.pyr_w[0], x, y,
                                 mv1[0], mv1[1], s) : nullptr, ts);
      for (int c = 0; c < 2; ++c)
        tu<kEncode>(p, sh, vc[c], x / 2, y / 2, s / 2, mode_c, 0, 0,
                    src_c[c], p.pitch_c, p.coef_in[1 + c],
                    p.coef_out[1 + c], f,
                    is_mc ? mc_origin(pyr[1 + c], p.pyr_h[1], p.pyr_w[1],
                                      x / 2, y / 2, mv[0] >> 1, mv[1] >> 1,
                                      s / 2)
                          : nullptr,
                    p.pyr_w[1], skip,
                    bi ? mc_origin(p.pyr[4 + c], p.pyr_h[1], p.pyr_w[1],
                                   x / 2, y / 2, mv1[0] >> 1, mv1[1] >> 1,
                                   s / 2) : nullptr);
      if (kInter) {
        // the CU's final MV over its units: the MV state of later CUs
        for (int i = threadIdx.x; i < u * u; i += kThreads) {
          int mux = ux + i % u, muy = uy + i / u;
          if (mux < ux_n && muy < uy_n) {
            p.mv_out[0][muy * ux_n + mux] = (int16_t)mv[0];
            p.mv_out[1][muy * ux_n + mux] = (int16_t)mv[1];
          }
        }
        __syncthreads();
      }
    }
    store_window(vy, rec_y, x0, y0, kCtu);
    for (int c = 0; c < 2; ++c)
      store_window(vc[c], rec_c[c], x0 / 2, y0 / 2, kCtu / 2);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) x266_st_release(progress + cy, cx + 1);
  }
}

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

// Launch one block per CTU row of each frame, after zeroing the row
// ticket and progress counters (and, for K3, the MV state) on the
// stream.  Every row must be resident at once on the card, or the launch
// is refused (cudaErrorInvalidConfiguration).
template <bool kInter, bool kB = false>
int launch(Params& p, int encode, void* stream) {
  void* args[] = {&p};
  cudaStream_t st = (cudaStream_t)stream;
  void (*kernel)(Params) = encode ? recon_kernel<true, kInter, kB>
                                  : recon_kernel<false, kInter, kB>;
  const int rows = p.frames * ((p.height + kCtu - 1) / kCtu);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err == cudaSuccess && rows > per_sm * sms)
    err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess)
    err = cudaMemsetAsync(p.sync, 0, sizeof(int) * (1 + rows), st);
  const size_t mv_bytes = sizeof(int16_t) * (p.width / 8) * (p.height / 8);
  for (int i = 0; kInter && i < 2 && err == cudaSuccess; ++i)
    err = cudaMemsetAsync(p.mv_out[i], 0, mv_bytes, st);
  if (err == cudaSuccess)
    err = cudaLaunchKernel(kernel, dim3(rows), dim3(kThreads), args, 0, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

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

// Launches K1 (encode != 0) or K2 on `stream`; `sync` is scratch of
// 1 + frames x CTU rows int32; lossless, ts and pdpc switch the intra
// tools on, and `mip` holds tables.k_mip.  Returns cudaGetLastError().
int x266_recon_intra(
    int encode, int frames, int width, int height, int pitch_y, int pitch_c,
    int plane_y, int plane_c, int qp, float lam, int rdoq, int mts, int subst,
    int n_modes, int lossless, int ts, int pdpc, const void* src_y, const void* src_cb, const void* src_cr,
    const void* cin_y, const void* cin_cb, const void* cin_cr,
    const void* size_map, const void* mode_map, const void* mts_map,
    void* rec_y, void* rec_cb, void* rec_cr, void* cout_y, void* cout_cb,
    void* cout_cr, const void* taps, const void* smooth, const void* tx,
    const void* shift, const void* rate, const void* mip, void* sync,
    void* stream) {
  const void* src[3] = {src_y, src_cb, src_cr};
  const void* cin[3] = {cin_y, cin_cb, cin_cr};
  void* rec[3] = {rec_y, rec_cb, rec_cr};
  void* cout[3] = {cout_y, cout_cb, cout_cr};
  Params p;
  set_common(p, frames, width, height, pitch_y, pitch_c, plane_y,
             plane_c, qp, lam, rdoq, mts, subst, n_modes, src, cin, size_map,
             mode_map, mts_map, rec, cout, taps, smooth, tx, shift, rate);
  p.lossless = lossless; p.ts = ts; p.pdpc = pdpc;
  p.mip = (const int32_t*)mip;
  p.sync = (int*)sync;
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
    int n_modes, int lossless, int ts, int pdpc, int merge, int pyr_hy,
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
  p.mip = (const int32_t*)mip;
  p.sync = (int*)sync;
  if (pyr1_y == nullptr) return launch<true>(p, encode, stream);
  p.pyr[3] = (const uint8_t*)pyr1_y; p.pyr[4] = (const uint8_t*)pyr1_cb;
  p.pyr[5] = (const uint8_t*)pyr1_cr;
  p.mv1_map[0] = (const int32_t*)mvx1_map;
  p.mv1_map[1] = (const int32_t*)mvy1_map;
  return launch<true, true>(p, encode, stream);
}

const char* x266_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
