// ALF estimator: the per-class normal equations of the encoder's Wiener
// filters and their float32 solve, the per-CTB on/off decision with
// CC-ALF's whole-filter gate, and the nonlinear estimator's per-class SSE
// of 4x4 blocks, as the reference computes them on XLA's CPU backend
// (port-only kernels; ROADMAP queue 3, F9).
//
// Replaces no Pallas kernel: the reference runs the sums as XLA dots
// (x266_tpu/kernels/alf.py:367-370 luma, :278-280 chroma, :436-438
// nonlinear luma, :318-319 nonlinear chroma, :538-539 CC-ALF), the solve
// as jnp.linalg.solve, the decision's per-CTB SSE as an XLA reduction
// (:335-338, :379-382, :467-470, :547-550), CC-ALF's gate as a fused
// reduction (:558-559) and the per-class block SSE as a dot (:454-456).
// The plain PyTorch versions are kernels/alf.py (normal_solve_plain and
// cc_normal_solve_plain: features, _cc_feats, normal_sums, coefficients;
// _ctb_flags and _ccalf_gate: ctb_sse_plain, gain_total;
// class_sse_plain); the kernels agree with them bit for bit.
//
// The features: kind 12, the 7x7 diamond's, and kind 6, the 5x5's, from
// the post-SAO recon, each difference clipped to +-v when a clip value is
// given (the nonlinear estimators) and the 12 permuted by the 4x4 block's
// transpose when a transpose map is given; kind 7, CC-ALF's, the
// full-resolution luma's differences at each chroma sample's collocated
// luma sample, the error taken against the chroma plane.  A clipped
// feature is |f| <= 2v <= 510 and a CC-ALF one |f| <= 255, so every bound
// below holds for every kind.
//
// What fixes the result: float32 rounding in XLA's order.  Per (class,
// entry) the samples run in blocks of `block` in raster order; inside a
// block lane l adds the samples at offsets l, l + lanes, ... one after
// another; the lanes combine in pairs or halves, and the block sums add up
// in order from 0 (alf.py SUM_ORDERS).  A sample outside the class adds 0.
//
// Why most of it can be summed in any order: every term is an integer
// below 2^24 (a feature is |f| <= 510 and an error |e| <= 255 at 8 bits,
// so |f_i f_j| <= 260,100 and |f_i e| <= 130,050), and float32 holds every
// integer of magnitude <= 2^24.  Along any chain of float32 adds of
// integers whose magnitudes add up to at most 2^24, every partial sum is
// such an integer, so every add is exact and the chain's result is the
// integer sum, whatever the order.  A (class, entry) of one block whose
// terms' magnitudes add up to M_b <= 2^24 is therefore exact through its
// lanes and their combine: its block sum is the int32 sum S_b.  Block sums
// are integers (float32 rounds an integer to an integer), so the chain
// across blocks is exact while the magnitudes of the block sums added so
// far stay <= 2^24.  The squared errors of the CTB decision are integers
// <= 255^2 >= 0, so a window whose int32 total is <= 2^24 is exact too.
//
// The design, per call (all on the stream, no host sync):
//   1. alf_block_exact, one thread block per block of samples: each round
//      one cell (4 samples of a row of one 4x4 class block) per thread, its
//      diamond's rows read as 16-byte words with the plane's wrap (jnp's
//      roll) at the edges, its 12 (luma) or 6 (chroma) features and errors
//      formed in registers and its sums in int32 registers; each (entry, 16
//      of the round's cells) then adds them into per-class block sums.  The
//      gram's (i, j) and (j, i) chains add the same integers in the same
//      order, so only i <= j is summed.  The test uses Cauchy-Schwarz: a
//      (class, entry)'s magnitudes add up to at most sqrt(S_ii S_jj) (the
//      sums of squares of its two factors, which the pass sums too), so
//      S_ii S_jj <= 2^48 makes its block sum its int32 sum; it is added
//      into an int64 sum and magnitude per chunk of 128 blocks.  Else the
//      block sum is left as NaN.
//   2. alf_block_ordered, grid-stride over the blocks, works only on those
//      with a NaN: it stages their records (features and errors, int16)
//      and cells sorted by class (raster inside a class) in shared memory,
//      and each (class, entry) past the test adds its lanes' samples in
//      order, 8 cells' loads ahead of their adds; the lanes combine.
//   3. alf_total_sums, one thread block per (class, 8 entries): a chain's
//      chunks whose magnitudes stay <= 2^24 when added in order are its
//      exact prefix (their int64 sum); only the blocks from the next chunk
//      on are added in order, from that prefix, tiles of 512 block sums
//      staged in shared memory while the next tile loads.
//   4. The chroma rhs's order has no blocks: 8 lanes over the whole plane.
//      alf_plane_segments sums each (entry, lane)'s terms and magnitudes
//      per segment of 8,192 samples and writes the terms as float32;
//      alf_plane_chains, one block per entry, takes each lane chain's exact
//      prefix of segments, then one thread per lane adds the rest in order,
//      4,096 samples' terms staged per step while the next step loads.
//   5. alf_solve, one thread per class system: OpenBLAS's sgetrf + strsm
//      as jaxlib calls them, __fmaf_rn where they fuse, __fmul_rn /
//      __fadd_rn elsewhere (the library is built with -fmad=false).
//   6. alf_ctb_flags, one thread block per CTB: the squared errors of the
//      filtered and the unfiltered plane against the source, per 32x32
//      window in int32; a window past 2^24 is summed in XLA's order from
//      the planes; then the two SSEs' float32 difference + lam * 1.5 < 0
//      is the CTB's flag.  Its GATE instance ends with CC-ALF's
//      whole-filter gate, run by the block that takes the last ticket.
//   7. alf_class_blocks and alf_class_chains, the nonlinear estimator's
//      per-class SSE of 4x4 blocks (see there).
//
// What bounds it on the H100: operations.  The normal equations read the
// recon, the source and the class map once (a 4K luma plane: 66 MB of
// int32 and 2 MB of classes, ~0.02 ms at 3.35 TB/s) and do 2 N (T^2 + T)
// multiply-adds' worth of work (N = 8.3M samples, T = 12: 2.6 G, ~0.04 ms
// at 67 T/s).  What they take instead (PERF.md section 6): the exact pass,
// whose cells' loads and per-class adds issue at a fraction of the card's
// rate, and the ordered chains of dependent float32 adds, which run only
// where the magnitudes pass 2^24 (rarely, on an encoder's own planes).
// It is CUDA, not Triton, because the result is fixed by per-class
// sequential chains, which are neither an elementwise pass nor a
// reduction of free order.

#include <cstdint>
#include <cuda_runtime.h>

#include "x266_device.cuh"

namespace {

constexpr int kMaxLanes = 8;
constexpr int kMaxT = 12;
constexpr int kMaxClasses = 25;
constexpr int kExact = 1 << 24;
constexpr int kThreads = 256;
constexpr int kGroup = 8;          // entries per alf_total_sums block
constexpr int kTotThreads = 512;
constexpr int kTileRows = 512;     // block sums per ordered tile
constexpr int kChunkBlocks = 128;  // blocks per chunk of the totals' prefix
constexpr int kMaxChunks = 96;     // a 4K luma gram has 64
constexpr int kBlockThreads = 128;
constexpr int kSegment = 8192;     // samples per plane segment
constexpr int kMaxSegments = 256;   // a 4K chroma plane has 254
constexpr int kChainSamples = 4096;  // samples a plane-chain step adds
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kMaxGateBytes = 200 * 1024;  // a gate's kept gains

// The estimator's inputs and one order of its sums.
struct Plane {
  const int32_t* recon;   // (fh, fw) the features' plane: the post-SAO
                          // recon, or CC-ALF's post-SAO luma
  const int32_t* base;    // (h, w) the error's base: the recon, or CC-ALF's
                          // chroma plane
  const int32_t* orig;    // (h, w) source
  const int32_t* cls;     // (h/4, w/4) classes, or null: one class
  const int32_t* tmap;    // (h/4, w/4) transposes (t = 12), or null
  int h, w, t;            // t: the features, 12 (luma), 6 (chroma), 7 (CC)
  int clip;               // the clip value v, or 0: unclipped
  int fh, fw;             // the features' plane
};

struct Order {
  Plane p;
  float* partial;         // (blocks, C, E) block sums
  int* block_ordered;     // (blocks): a block sum takes the ordered path
  unsigned long long* chunk;  // (chunks, C, E, 2): int64 sums, magnitudes
  float* out;             // gram (C, T, T) or rhs (C, T)
  int* stats;             // [exact, ordered] chains, [exact, ordered] totals
  int n, n_classes, entries, block, lanes, halves, gram, blocks;
};

__device__ int wrap(int v, int n) { return v < 0 ? v + n : v >= n ? v - n : v; }

// Entry e's two factors: the gram's unique (i, j), i <= j, row by row; the
// rhs's (e, error).
__device__ void factors(int e, int t, int gram, int* i, int* j) {
  if (!gram) {
    *i = e;
    *j = t;               // the error's row
    return;
  }
  int r = 0;
  while (e >= t - r) {
    e -= t - r;
    ++r;
  }
  *i = r;
  *j = r + e;
}

// Folds `lanes` (a power of two, <= 16) lane sums into one, in pairs or
// in halves.
__device__ float combine(const float* v, int lanes, int halves) {
  float t[16];
  for (int l = 0; l < lanes; ++l) t[l] = v[l];
  for (int m = lanes; m > 1; m >>= 1)
    for (int q = 0; q < m / 2; ++q)
      t[q] = halves ? __fadd_rn(t[q], t[q + m / 2])
                    : __fadd_rn(t[2 * q], t[2 * q + 1]);
  return t[0];
}

// Adds block b's sum v of (class, entry) i (an integer, |v| < 2^31) into
// its chunk's int64 sum and magnitude.
__device__ void add_chunk(const Order& o, int b, int i, long long v) {
  unsigned long long* q =
      o.chunk + ((size_t)(b / kChunkBlocks) * o.n_classes * o.entries + i) * 2;
  atomicAdd(q, (unsigned long long)v);
  atomicAdd(q + 1, (unsigned long long)(v < 0 ? -v : v));
}

// The diamonds' taps (alf.py DIAMOND, CHROMA_DIAMOND), for the kernels
// that unroll them.
template <int T>
__host__ __device__ constexpr int tap_dy(int i) {
  return T == 12 ? (i < 3 ? 0 : i < 8 ? 1 : i < 11 ? 2 : 3)
                 : (i < 2 ? 0 : i < 5 ? 1 : 2);
}
template <int T>
__host__ __device__ constexpr int tap_dx(int i) {
  return T == 12 ? (i < 3 ? i + 1 : i < 8 ? i - 5 : i < 11 ? i - 9 : 0)
                 : (i < 2 ? i + 1 : i < 5 ? i - 3 : 0);
}

// The index of the gram's (i, i) among its upper triangle, row by row.
__host__ __device__ inline int diag(int i, int t) {
  return i * t - i * (i - 1) / 2;
}

__host__ __device__ inline int part_stride(int ea) { return ea | 1; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// The symmetric pair's feature of samples s0 and s1 around centre ctr:
// s0 + s1 - 2 ctr; in the nonlinear kinds (NL) with a clip value v,
// clip(s0 - ctr, +-v) + clip(s1 - ctr, +-v) (alf.py _clipped_diff_planes).
// The kind is a template parameter, so the linear kernels carry no clip
// branch.
template <bool NL>
__device__ __forceinline__ int pair(int s0, int s1, int ctr, int v) {
  if constexpr (NL)
    return v ? clampi(s0 - ctr, -v, v) + clampi(s1 - ctr, -v, v)
             : s0 + s1 - 2 * ctr;
  else
    return s0 + s1 - 2 * ctr;
}

// TRANSPOSE_PERMS (alf.py), each row packed 4 bits an entry.
__host__ __device__ constexpr unsigned long long perm_row(int t) {
  return t == 0 ? 0xba9876543210ull : t == 1 ? 0x2713a6048b95ull
       : t == 2 ? 0xb89a34567210ull : 0x23178406ab95ull;
}

// Permutes the 12 features by transpose t: fa[i] = f[PERMS[t][i]].
__device__ __forceinline__ void align12(int* f, int t) {
  int g[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) g[i] = f[i];
  const unsigned long long row = perm_row(t);
#pragma unroll
  for (int i = 0; i < 12; ++i) f[i] = g[(row >> (4 * i)) & 15];
}

// CC_OFFSETS (alf.py).
__host__ __device__ constexpr int cc_dy(int i) {
  return i == 0 ? -1 : i < 3 ? 0 : i < 6 ? 1 : 2;
}
__host__ __device__ constexpr int cc_dx(int i) {
  return i == 1 || i == 3 ? -1 : i == 2 || i == 5 ? 1 : 0;
}

// CC-ALF's 7 features of chroma sample (y, x) and its error: the luma's
// differences at (2y + dy, 2x + dx), wrapped like jnp.roll, from (2y, 2x).
__device__ void cc_features(const Plane& p, int y, int x, int* f) {
  const int32_t* l = p.recon;
  const int ly = 2 * y, lx = 2 * x;
  const int ctr = __ldg(l + ly * p.fw + lx);
#pragma unroll
  for (int i = 0; i < 7; ++i)
    f[i] = __ldg(l + wrap(ly + cc_dy(i), p.fh) * p.fw +
                 wrap(lx + cc_dx(i), p.fw)) - ctr;
  f[7] = __ldg(p.orig + y * p.w + x) - __ldg(p.base + y * p.w + x);
}

// Sample (y, x)'s T features and its error, with the plane's wrap; NL:
// clipped, and for T = 12 aligned by the transpose map.
template <int T, bool NL>
__device__ void features(const Plane& p, int y, int x, int* f) {
  if constexpr (T == 7) {
    cc_features(p, y, x, f);
  } else {
    const int32_t* r = p.recon;
    const int ctr = __ldg(r + y * p.w + x);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int dy = tap_dy<T>(i), dx = tap_dx<T>(i);
      const int y0 = wrap(y + dy, p.h), x0 = wrap(x + dx, p.w);
      const int y1 = wrap(y - dy, p.h), x1 = wrap(x - dx, p.w);
      f[i] = pair<NL>(__ldg(r + y0 * p.w + x0), __ldg(r + y1 * p.w + x1),
                      ctr, p.clip);
    }
    if constexpr (NL && T == 12)
      if (p.tmap) align12(f, p.tmap[(y >> 2) * (p.w >> 2) + (x >> 2)]);
    f[T] = __ldg(p.orig + y * p.w + x) - ctr;
  }
}

// The T features and the error of the 4 samples of the cell at (y, x) (x
// a multiple of 4): each of the diamond's rows read as three 16-byte words
// (columns x - 4 .. x + 7), wrapped like jnp.roll at the plane's edges.
template <int T, bool NL>
__device__ __forceinline__ void cell_features(const Plane& p, int y, int x,
                                              int (*f)[T + 1]) {
  if constexpr (T == 7) {
#pragma unroll
    for (int u = 0; u < 4; ++u) cc_features(p, y, x + u, f[u]);
    return;
  } else {
  constexpr int R = tap_dy<T>(T - 1);
  int row[2 * R + 1][12];
  const bool inside = x >= 4 && x + 8 <= p.w;
#pragma unroll
  for (int d = -R; d <= R; ++d) {
    const int yy = wrap(y + d, p.h);
    const int32_t* r = p.recon + yy * p.w;
    if (inside) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int4 v = __ldg((const int4*)(r + x - 4) + q);
        row[d + R][4 * q] = v.x;
        row[d + R][4 * q + 1] = v.y;
        row[d + R][4 * q + 2] = v.z;
        row[d + R][4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 12; ++c) row[d + R][c] = r[wrap(x - 4 + c, p.w)];
    }
  }
  const int4 o = __ldg((const int4*)(p.orig + y * p.w + x));
  const int ov[4] = {o.x, o.y, o.z, o.w};
  int tr = -1;
  if constexpr (NL && T == 12)
    if (p.tmap) tr = p.tmap[(y >> 2) * (p.w >> 2) + (x >> 2)];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int ctr = row[R][u + 4];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int dy = tap_dy<T>(i), dx = tap_dx<T>(i);
      f[u][i] = pair<NL>(row[R + dy][u + 4 + dx], row[R - dy][u + 4 - dx],
                         ctr, p.clip);
    }
    if constexpr (NL && T == 12)
      if (tr >= 0) align12(f[u], tr);
    f[u][T] = ov[u] - ctr;
  }
  }
}

// The exact path, one thread block per block of samples.  GRAM: the sums
// are the T(T+1)/2 products f_i f_j, i <= j (which hold the squares the
// test needs); else the T products f_i e, then the squares f_i^2 and e^2.
// Each round one cell per thread (raster order, 4 samples of one class,
// its diamond's rows read as 16-byte words), its sums in registers; then
// each (entry, 16 of the round's cells) adds the cells' sums into their
// classes.  A (class, entry) of the block is exact when its terms'
// magnitudes add up to <= 2^24; by Cauchy-Schwarz that holds when the
// product of its two factors' sums of squares is <= 2^48.  Its block sum
// is then its int32 sum, added into its chunk; else NaN, for
// alf_block_ordered.
template <int T, bool GRAM, bool NL>
__global__ void __launch_bounds__(kBlockThreads) alf_block_exact(Order o) {
  constexpr int E = GRAM ? T * (T + 1) / 2 : T;      // entries written
  constexpr int EA = GRAM ? E : 2 * T + 1;           // entries summed
  constexpr int PS = EA | 1;         // odd: a round's rows hit 32 banks
  using Sums = int[kMaxClasses][EA];
  using Present = int[kMaxClasses + 1];
  using Factors = int[E][2];
  using Cls = int[kBlockThreads];
  X266_SHARED(Sums, sums);
  X266_SHARED(Present, present);       // [C]: no cell
  X266_SHARED(Factors, fij);
  X266_SHARED(Cls, pcls);
  X266_SHARED(int, any_ordered);
  X266_DYNAMIC_SHARED(int, part);      // [kBlockThreads][PS]: a round's sums
  const int tid = threadIdx.x, C = o.n_classes;
  const int b = blockIdx.x, k0 = b * o.block;
  const int len = o.n - k0 < o.block ? o.n - k0 : o.block;
  const int cells = len / 4;
  const Plane& p = o.p;

  for (int i = tid; i < C * EA; i += kBlockThreads) sums[i / EA][i % EA] = 0;
  if (tid <= C) present[tid] = 0;
  for (int e = tid; e < E; e += kBlockThreads)
    factors(e, T, GRAM, &fij[e][0], &fij[e][1]);
  if (tid == 0) any_ordered = 0;
  __syncthreads();
  for (int r0 = 0; r0 < cells; r0 += kBlockThreads) {
    const int g = r0 + tid;
    int acc[EA];
#pragma unroll
    for (int e = 0; e < EA; ++e) acc[e] = 0;
    int cc = C;                   // no cell: a class of its own
    if (g < cells) {
      const int k = k0 + 4 * g, y = k / p.w, x = k - y * p.w;
      cc = p.cls ? p.cls[(y >> 2) * (p.w >> 2) + (x >> 2)] : 0;
      X266_ASSERT(cc >= 0 && cc < C);
      int f[4][T + 1];
      cell_features<T, NL>(p, y, x, f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (GRAM) {
          int e = 0;
#pragma unroll
          for (int i = 0; i < T; ++i)
#pragma unroll
            for (int j = i; j < T; ++j) acc[e++] += f[u][i] * f[u][j];
        } else {
#pragma unroll
          for (int i = 0; i < T; ++i) {
            acc[i] += f[u][i] * f[u][T];
            acc[T + i] += f[u][i] * f[u][i];
          }
          acc[2 * T] += f[u][T] * f[u][T];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < EA; ++e) part[tid * PS + e] = acc[e];
    pcls[tid] = cc;
    present[cc] = 1;
    __syncthreads();
    // each (entry, 16 rows) adds its rows into their classes, a run of
    // one class at a time
    for (int it = tid; it < EA * (kBlockThreads / 16); it += kBlockThreads) {
      const int e = it % EA, t0 = (it / EA) * 16;
      int cur = pcls[t0], run = 0;
#pragma unroll
      for (int t = t0; t < t0 + 16; ++t) {
        const int c = pcls[t], v = part[t * PS + e];
        if (c != cur) {
          if (cur < C) atomicAdd(&sums[cur][e], run);
          cur = c;
          run = 0;
        }
        run += v;
      }
      if (cur < C) atomicAdd(&sums[cur][e], run);
    }
    __syncthreads();
  }
  int exact = 0, ordered = 0;
  for (int i = tid; i < C * E; i += kBlockThreads) {
    const int c = i / E, e = i % E, fi = fij[e][0], fj = fij[e][1];
    const long long a = GRAM ? sums[c][diag(fi, T)] : sums[c][T + fi];
    const long long bb = GRAM ? sums[c][diag(fj, T)] : sums[c][2 * T];
    const bool ok = a * bb <= (long long)kExact * kExact;
    if (present[c]) ++(ok ? exact : ordered);
    if (present[c] && ok && sums[c][e]) add_chunk(o, b, i, sums[c][e]);
    o.partial[(size_t)b * C * E + i] = ok ? (float)sums[c][e]
                                          : nanf("");    // for the ordered
                                                         // path
  }
  if (exact) atomicAdd(&o.stats[0], exact);
  if (ordered) {
    atomicAdd(&o.stats[1], ordered);
    any_ordered = 1;
  }
  __syncthreads();
  if (tid == 0) o.block_ordered[b] = any_ordered;
}

// The ordered path, for the blocks with a (class, entry) past 2^24: the
// block's records (features and errors, int16) and its cells sorted by
// class (raster inside a class) in shared memory; each such (class,
// entry), lane by lane, adds its class's samples of the lane in raster
// order; the lanes combine into its block sum.
template <int T, bool GRAM, int L, bool NL>
__device__ void ordered_block(const Order& o, int b) {
  constexpr int E = GRAM ? T * (T + 1) / 2 : T;
  constexpr int RP = T + 1;
  static_assert(L == 2 || L == 4, "a cell holds 4 / L samples of a lane");
  X266_DYNAMIC_SHARED(int, smem);
  const int tid = threadIdx.x, C = o.n_classes;
  const int k0 = b * o.block;
  const int len = o.n - k0 < o.block ? o.n - k0 : o.block;
  const int cells = len / 4;
  const Plane& p = o.p;
  int* cnt = smem;                          // [C]
  int* off = cnt + C;                       // [C]
  int* nfail = off + C;                     // [1]
  int* fail = nfail + 1;                    // [C * E]
  float* acc = (float*)(fail + C * E);      // [C * E][lanes]
  uint8_t* ccls = (uint8_t*)(acc + C * E * L);        // [cells + 3]
  int16_t* rec = (int16_t*)(ccls + ((cells + 3) & ~3));   // [len][RP]
  int16_t* sorted = rec + (size_t)len * RP;           // [cells]
  float* part = o.partial + (size_t)b * C * E;

  for (int i = tid; i < C; i += kBlockThreads) cnt[i] = 0;
  if (tid == 0) *nfail = 0;
  __syncthreads();
  for (int g = tid; g < cells; g += kBlockThreads) {
    const int k = k0 + 4 * g, y = k / p.w, x = k - y * p.w;
    int f[4][T + 1];
    cell_features<T, NL>(p, y, x, f);
    for (int u = 0; u < 4; ++u)
      for (int i = 0; i <= T; ++i) rec[(4 * g + u) * RP + i] = (int16_t)f[u][i];
    const int c = p.cls ? p.cls[(y >> 2) * (p.w >> 2) + (x >> 2)] : 0;
    ccls[g] = (uint8_t)c;
    atomicAdd(&cnt[c], 1);
  }
  for (int i = tid; i < C * E; i += kBlockThreads)
    if (part[i] != part[i]) fail[atomicAdd(nfail, 1)] = i;    // NaN
  __syncthreads();
  if (tid == 0) {
    int a = 0;
    for (int c = 0; c < C; ++c) {
      off[c] = a;
      a += cnt[c];
    }
  }
  __syncthreads();
  if (tid < C) {                // 4 cells' classes per load
    int at = off[tid];
    const uint32_t* words = (const uint32_t*)ccls;
#pragma unroll 4
    for (int g4 = 0; g4 < (cells + 3) / 4; ++g4) {
      const uint32_t v = words[g4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * g4 + u < cells && (int)((v >> (8 * u)) & 255) == tid)
          sorted[at++] = (int16_t)(4 * g4 + u);
    }
  }
  __syncthreads();
  // each chain adds 8 cells' samples per step, their loads first (a cell
  // starts a lane's period: lane l's samples are l, l + L, ... < 4; past
  // the class's last cell a step adds 0)
  constexpr int kPerCell = 4 / L;
  const int nf = *nfail;
  for (int it = tid; it < nf * L; it += kBlockThreads) {
    const int i = fail[it / L], l = it % L, c = i / E;
    int fi, fj;
    factors(i % E, T, GRAM, &fi, &fj);
    float a = 0.f;
    const int end = off[c] + cnt[c];
    for (int q0 = off[c]; q0 < end; q0 += 8) {
      float t[8][kPerCell];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int g = q0 + j < end ? sorted[q0 + j] : -1;
#pragma unroll
        for (int h = 0; h < kPerCell; ++h) {
          const int16_t* r = rec + (4 * g + l + h * L) * RP;
          t[j][h] = g < 0 ? 0.f : (float)((int)r[fi] * (int)r[fj]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < kPerCell; ++h) a = __fadd_rn(a, t[j][h]);
    }
    acc[it] = a;
  }
  __syncthreads();
  for (int f = tid; f < nf; f += kBlockThreads) {
    const float v = combine(acc + (size_t)f * L, L, o.halves);
    part[fail[f]] = v;
    add_chunk(o, b, fail[f], (long long)v);     // an integer below 2^31
  }
  __syncthreads();
}

// The blocks of samples, grid-stride; most need nothing.
template <int T, bool GRAM, int L, bool NL>
__global__ void __launch_bounds__(kBlockThreads) alf_block_ordered(Order o) {
  for (int b = blockIdx.x; b < o.blocks; b += gridDim.x)
    if (o.block_ordered[b]) ordered_block<T, GRAM, L, NL>(o, b);
}

__host__ __device__ inline size_t ordered_smem_bytes(int t, int e, int c,
                                                     int lanes, int len) {
  return sizeof(int) * (2 * c + 1 + (size_t)c * e) +
         sizeof(float) * (size_t)c * e * lanes + ((len / 4 + 3) & ~3) +
         sizeof(int16_t) * (size_t)len * (t + 1) + sizeof(int16_t) * (len / 4);
}

// Writes total v of (class c, unique entry e): the gram's (i, j) and
// (j, i), or the rhs's i.
__device__ void put_total(const Order& o, int c, int e, float v) {
  int i, j;
  factors(e, o.p.t, o.gram, &i, &j);
  const int t = o.p.t;
  if (o.gram) {
    o.out[((size_t)c * t + i) * t + j] = v;
    o.out[((size_t)c * t + j) * t + i] = v;
  } else {
    o.out[(size_t)c * t + i] = v;
  }
}

// The totals over blocks of one class and kGroup entries.  The block sums
// are integers, so the chain across blocks is exact while the magnitudes
// added so far stay <= 2^24: per entry the threads sum the magnitudes and
// the values of consecutive chunks of blocks in parallel; the chunks whose
// magnitudes, added in order, stay <= 2^24 are the chain's exact prefix,
// and only the blocks from the next chunk on are added in order from it,
// tiles of kTileRows block sums staged in shared memory while the next
// tile loads.
__global__ void __launch_bounds__(kTotThreads) alf_total_sums(Order o) {
  constexpr int kRows = kTotThreads / kGroup;       // rows a pass covers
  constexpr int kPer = kTileRows / kRows;           // a thread's tile rows
  using Tile = float[2][kTileRows][kGroup];
  using Chunks = long long[kMaxChunks][kGroup][2];
  using Start = int[kGroup];
  using Prefix = float[kGroup];
  X266_SHARED(Tile, tile);
  X266_SHARED(Chunks, chunk);
  X266_SHARED(Start, start);
  X266_SHARED(Prefix, prefix);
  const int tid = threadIdx.x, E = o.entries, ce = o.n_classes * E;
  const int groups = (E + kGroup - 1) / kGroup;
  const int c = blockIdx.x / groups, e0 = (blockIdx.x % groups) * kGroup;
  const int ne = E - e0 < kGroup ? E - e0 : kGroup;
  const int q = tid % kGroup, r0 = tid / kGroup;
  const float* src = o.partial + (size_t)c * E + e0 + q;
  const int chunks = (o.blocks + kChunkBlocks - 1) / kChunkBlocks;
  for (int w = tid; w < chunks * kGroup * 2; w += kTotThreads) {
    const int ch = w / (kGroup * 2), u = (w / 2) % kGroup, h = w % 2;
    chunk[ch][u][h] = u < ne ? (long long)o.chunk[((size_t)ch * ce + c * E +
                                                   e0 + u) * 2 + h]
                             : 0;
  }
  __syncthreads();
  if (tid < kGroup) {
    long long s = 0, m = 0;
    int ch = 0;
    for (; ch < chunks && m + chunk[ch][tid][1] <= kExact; ++ch) {
      s += chunk[ch][tid][0];
      m += chunk[ch][tid][1];
    }
    start[tid] = tid < ne && ch < chunks ? ch * kChunkBlocks : o.blocks;
    prefix[tid] = (float)s;      // exact: an integer of magnitude <= 2^24
    if (tid < ne && (ch < chunks || m > 0))
      atomicAdd(&o.stats[ch < chunks ? 3 : 2], 1);
  }
  __syncthreads();
  int lo = o.blocks;            // every chain exact: no tile
  for (int u = 0; u < ne; ++u) lo = start[u] < lo ? start[u] : lo;
  if (lo < o.blocks) lo -= lo % kTileRows;
  const int tiles = (o.blocks - lo + kTileRows - 1) / kTileRows;
  float v[kPer];
  auto load = [&](int tl) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int b = lo + tl * kTileRows + r0 + u * kRows;
      v[u] = q < ne && b < o.blocks ? src[(size_t)b * ce] : 0.f;
    }
  };
  if (tiles > 0) load(0);
  float acc = tid < kGroup ? prefix[tid] : 0.f;
  const int my_start = tid < kGroup ? start[tid] : o.blocks;
  for (int tl = 0; tl < tiles; ++tl) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) tile[tl & 1][r0 + u * kRows][q] = v[u];
    __syncthreads();
    if (tl + 1 < tiles) load(tl + 1);
    if (tid < ne) {
      // a row before the chain's start (in its exact prefix) or past the
      // last block adds 0, which changes nothing
      const int skip = my_start - (lo + tl * kTileRows);
#pragma unroll 16
      for (int r = 0; r < kTileRows; ++r)
        acc = __fadd_rn(acc, r >= skip ? tile[tl & 1][r][tid] : 0.f);
    }
  }
  if (tid < ne) put_total(o, c, e0 + tid, acc);
}

// The chroma rhs: one class, 8 lanes over the whole plane.  Per segment of
// kSegment samples, the int32 sum and magnitude of each (entry, lane), and
// every term as a float32 (exact: an integer below 2^24) for the chains
// that must add them in order.
struct PlaneChains {
  Plane p;
  int* seg;               // (segments, 2, T, lanes): sums, magnitudes
  float* terms;           // (T, n)
  float* out;             // rhs (T)
  int* stats;
  int n, lanes, halves, segments;
};

template <int T, bool NL>
__global__ void __launch_bounds__(kThreads) alf_plane_segments(PlaneChains q) {
  using Red = int[2][T][kThreads];
  X266_SHARED(Red, red);
  const int tid = threadIdx.x, L = q.lanes;
  const int k0 = blockIdx.x * kSegment;
  int s[T], m[T];
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = m[i] = 0;
  // kSegment and kThreads are multiples of the lanes: thread tid's samples
  // all lie in lane tid % lanes
  for (int k = k0 + tid; k < q.n && k < k0 + kSegment; k += kThreads) {
    int f[T + 1];
    features<T, NL>(q.p, k / q.p.w, k % q.p.w, f);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int v = f[i] * f[T];
      s[i] += v;
      m[i] += v < 0 ? -v : v;
      q.terms[(size_t)i * q.n + k] = (float)v;
    }
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    red[0][i][tid] = s[i];
    red[1][i][tid] = m[i];
  }
  __syncthreads();
  for (int w = tid; w < 2 * T * L; w += kThreads) {
    const int h = w / (T * L), i = (w / L) % T, l = w % L;
    int acc = 0;
    for (int r = l; r < kThreads; r += L) acc += red[h][i][r];
    q.seg[(((size_t)blockIdx.x * 2 + h) * T + i) * L + l] = acc;
  }
}

// One block per entry.  Each lane chain's exact prefix of segments (their
// magnitudes add up to <= 2^24) is its int64 sum; the rest of the chain is
// added in order by one thread per lane from the terms, kChainSamples
// samples per step staged in shared memory while the next step's load;
// then the lanes combine.
__global__ void __launch_bounds__(kThreads) alf_plane_chains(PlaneChains q) {
  // a lane's row padded by 4 floats: the transposing stores hit 32 banks
  using Terms = float[2][kMaxLanes][kChainSamples / kMaxLanes + 4];
  using Segs = int[kMaxSegments][kMaxLanes];
  using LaneSums = float[kMaxLanes];
  using Starts = int[kMaxLanes];
  X266_SHARED(Terms, terms);          // a step's terms by lane
  X266_SHARED(Segs, seg_m);
  X266_SHARED(LaneSums, lane_sum);
  X266_SHARED(Starts, start);
  const int tid = threadIdx.x, i = blockIdx.x, t = q.p.t;
  constexpr int L = kMaxLanes, kPerLane = kChainSamples / L;
  for (int w = tid; w < q.segments * L; w += kThreads) {
    const int sg = w / L, l = w % L;
    seg_m[sg][l] = q.seg[(((size_t)sg * 2 + 1) * t + i) * L + l];
  }
  __syncthreads();
  if (tid < L) {
    long long m = 0, s = 0;
    int sg = 0;
    for (; sg < q.segments && m + seg_m[sg][tid] <= kExact; ++sg)
      m += seg_m[sg][tid];
#pragma unroll 8
    for (int u = 0; u < sg; ++u)
      s += q.seg[(((size_t)u * 2) * t + i) * L + tid];
    start[tid] = sg * kSegment;   // the first sample the chain adds in order
    lane_sum[tid] = (float)s;
    atomicAdd(&q.stats[sg < q.segments ? 1 : 0], 1);
  }
  __syncthreads();
  int lo = q.n;
  for (int l = 0; l < L; ++l) lo = start[l] < lo ? start[l] : lo;
  lo -= lo % kChainSamples;
  const int steps = (q.n - lo + kChainSamples - 1) / kChainSamples;
  constexpr int kPer = kChainSamples / kThreads;
  const float* src = q.terms + (size_t)i * q.n;
  float v[kPer];
  auto load = [&](int st) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = lo + st * kChainSamples + u * kThreads + tid;
      v[u] = k < q.n ? src[k] : 0.f;
    }
  };
  if (steps > 0) load(0);
  float acc = tid < L ? lane_sum[tid] : 0.f;
  const int my_start = tid < L ? start[tid] : q.n;
  for (int st = 0; st < steps; ++st) {
    // sample base + u * kThreads + tid lies in lane tid % L (kThreads and
    // the step are multiples of L), at position (u * kThreads + tid) / L
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      terms[st & 1][tid % L][(u * kThreads + tid) / L] = v[u];
    __syncthreads();
    if (st + 1 < steps) load(st + 1);
    if (tid < L) {
      // a term before the chain's start (in its exact prefix) adds 0
      const int skip = (my_start - (lo + st * kChainSamples) + L - 1) / L;
      const float4* row = (const float4*)terms[st & 1][tid];
      if (skip <= 0) {
#pragma unroll 8
        for (int j = 0; j < kPerLane / 4; ++j) {
          const float4 x = row[j];
          acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, x.x), x.y), x.z),
                          x.w);
        }
      } else {
        for (int j = 0; j < kPerLane; ++j)
          acc = __fadd_rn(acc, j >= skip ? terms[st & 1][tid][j] : 0.f);
      }
    }
  }
  if (tid < L) lane_sum[tid] = acc;
  __syncthreads();
  if (tid == 0) q.out[i] = combine(lane_sum, L, q.halves);
}

// OpenBLAS 0.3.30 (SkylakeX kernels) sgetrf + strsm, as alf.py solve_f32.
struct SolveParams {
  const float* gram;      // (S, n, n)
  const float* rhs;       // (S, n), before the scaling by 128
  int32_t* coef;          // (S, n)
  int systems, n;
};

__device__ float fma0(float a, float b, float c) { return __fmaf_rn(a, b, c); }

__global__ void alf_solve(SolveParams p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.systems) return;
  const int n = p.n;
  float a[kMaxT][kMaxT], x[kMaxT];
  int perm[kMaxT];
  for (int i = 0; i < n; ++i) {
    perm[i] = i;
    for (int j = 0; j < n; ++j)
      a[i][j] = __fadd_rn(p.gram[((size_t)s * n + i) * n + j],
                          i == j ? 64.f : 0.f);
  }
  // sgetf2, left-looking
  for (int j = 0; j < n; ++j) {
    for (int i = 1; i < j; ++i) {          // sdot pairs, added in float64
      double acc = 0.0;
      for (int k = 0; k + 1 < i; k += 2)
        acc = __dadd_rn(acc, (double)fma0(a[k][j], a[i][k],
                                          __fmul_rn(a[k + 1][j],
                                                    a[i][k + 1])));
      if (i & 1) acc = __dadd_rn(acc, (double)__fmul_rn(a[i - 1][j],
                                                        a[i][i - 1]));
      a[i][j] = __fsub_rn(a[i][j], __double2float_rn(acc));
    }
    if (j > 0) {                           // sgemv_n
      float xj[kMaxT];
      for (int k = 0; k < j; ++k) xj[k] = a[k][j];
      for (int r = j; r < n; ++r) {
        float acc = 0.f;
        if (j == 4 && r - j < ((n - j) & ~3)) {
          float e0 = fma0(a[r][2], xj[2], fma0(a[r][0], xj[0], 0.f));
          float e1 = fma0(a[r][3], xj[3], fma0(a[r][1], xj[1], 0.f));
          acc = __fadd_rn(e0, e1);
        } else {
          for (int k = 0; k < j; ++k) acc = fma0(a[r][k], xj[k], acc);
        }
        a[r][j] = __fsub_rn(a[r][j], acc);
      }
    }
    int jp = j;
    float best = fabsf(a[j][j]);
    for (int r = j + 1; r < n; ++r)
      if (fabsf(a[r][j]) > best) { best = fabsf(a[r][j]); jp = r; }
    if (jp != j) {
      for (int k = 0; k < n; ++k) {
        float t = a[j][k]; a[j][k] = a[jp][k]; a[jp][k] = t;
      }
      int t = perm[j]; perm[j] = perm[jp]; perm[jp] = t;
    }
    const float inv = __fdiv_rn(1.f, a[j][j]);
    for (int r = j + 1; r < n; ++r) a[r][j] = __fmul_rn(a[r][j], inv);
  }
  for (int i = 0; i < n; ++i)
    x[i] = __fmul_rn(p.rhs[(size_t)s * n + perm[i]], 128.f);
  // strsm, unit lower: forward in row blocks of 8, 4, 2, 1
  int s0 = 0;
  for (int sz = 8; sz >= 1; sz >>= 1) {
    if (!(n & sz)) continue;
    for (int r = s0; r < s0 + sz; ++r) {
      float acc = 0.f;
      for (int k = 0; k < s0; ++k) acc = fma0(a[r][k], x[k], acc);
      if (s0 > 0) x[r] = __fsub_rn(x[r], acc);
    }
    for (int i = s0; i < s0 + sz; ++i)
      for (int k = i + 1; k < s0 + sz; ++k) x[k] = fma0(-x[i], a[k][i], x[k]);
    s0 += sz;
  }
  // strsm, upper: backward in row blocks of 1, 2, 4, 8
  for (int sz = 1; sz <= 8; sz <<= 1) {
    if (!(n & sz)) continue;
    const int b0 = (n & ~(sz - 1)) - sz, b1 = b0 + sz;
    for (int r = b0; r < b1; ++r) {
      float acc = 0.f;
      for (int k = b1; k < n; ++k) acc = fma0(a[r][k], x[k], acc);
      if (b1 < n) x[r] = __fsub_rn(x[r], acc);
    }
    for (int i = b1 - 1; i >= b0; --i) {
      x[i] = __fmul_rn(x[i], __fdiv_rn(1.f, a[i][i]));
      for (int k = b0; k < i; ++k) x[k] = fma0(-x[i], a[k][i], x[k]);
    }
  }
  for (int i = 0; i < n; ++i) {
    float r = fminf(fmaxf(rintf(x[i]), -511.f), 511.f);
    p.coef[(size_t)s * n + i] = (int32_t)r;
  }
}

// The per-CTB on/off decision (alf.py _ctb_flags): the float32 SSE of the
// filtered and of the unfiltered plane against the source in XLA CPU's
// reduction order -- mode 0, a 64x64 CTB as four 32x32 windows each in
// raster order, then the windows in raster order; mode 1, a 32x32 CTB in
// raster order; mode 2, a 32x32 CTB row by row through eight lanes
// (cost.py row_vector_sum) -- then flag = (sse_f - sse_r) + lam15 < 0.
// Samples past the plane are 0; the plane's width is a multiple of 4.  A
// window whose int32 total is <= 2^24 is that total; one past it is
// summed in order from the planes.  The GATE instance (CC-ALF's 32x32
// CTBs) ends with the whole-filter gate, ccalf_gate below.
struct FlagParams {
  const int32_t* filt;
  const int32_t* recon;
  const int32_t* orig;
  int32_t* flags;         // (cy, cx)
  float* sse;             // (2, cy, cx) filtered, unfiltered, or null;
                          // GATE: the kept gains, (cy, cx)
  int* stats;             // [exact, ordered] windows
  float lam15;
  int h, w, cy, cx, mode;
  // GATE only
  unsigned long long* ticket;   // 0 between calls
  int32_t* worth;               // (1)
  float lam_gate;
};

__device__ float sq_err(const FlagParams& p, const int32_t* a, int y, int x) {
  if (y >= p.h || x >= p.w) return 0.f;
  const size_t k = (size_t)y * p.w + x;
  const int d = a[k] - p.orig[k];
  return (float)(d * d);
}

__device__ float row_vector_sum32(const FlagParams& p, const int32_t* a,
                                  int y0, int x0) {
  float tot = 0.f;
  for (int r = 0; r < 32; ++r) {
    float v[32], lane[8];
    for (int c = 0; c < 32; ++c) v[c] = sq_err(p, a, y0 + r, x0 + c);
    for (int l = 1; l < 8; ++l)
      lane[l] = __fadd_rn(__fadd_rn(__fadd_rn(v[l], v[8 + l]), v[16 + l]),
                          v[24 + l]);
    float t0 = tot;
    for (int c = 0; c < 32; c += 8) t0 = __fadd_rn(t0, v[c]);
    tot = __fadd_rn(__fadd_rn(__fadd_rn(t0, lane[4]),
                              __fadd_rn(lane[2], lane[6])),
                    __fadd_rn(__fadd_rn(lane[1], lane[5]),
                              __fadd_rn(lane[3], lane[7])));
  }
  return tot;
}

// CC-ALF's whole-filter gate (alf.py _ccalf_gate, gain_total): the sum of
// the gains of the CTBs whose flag is on, in the order of XLA CPU's fused
// reduction -- with 8 rows or more lane l adds rows l, l + 8, ... below
// the last whole group of 8, each row in order, the lanes fold in halves
// and the remaining rows follow in raster order; with 4 rows each row is a
// lane, folded in halves; otherwise raster order -- then worth = total +
// lam_gate < 0.  Run by the CTB kernel's last block, once every CTB has
// written its kept gain (the gain where its flag is on, else 0) to the
// first row of sse: its threads copy the gains into shared memory (16-byte
// loads, 8 ahead a thread) as rows of gate_pitch floats, 16-byte aligned
// and an odd number of 16-byte words apart, so that the lanes' 16-byte
// loads fall in distinct banks; one thread a lane adds its rows, thread 0
// folds the lanes, adds the remaining rows, writes worth and resets the
// ticket.  Each chain reads its next 16-byte word while it adds the last.
__host__ __device__ inline int gate_pitch(int cx) {
  const int p = (cx + 3) & ~3;
  return (p / 4) % 2 ? p : p + 4;
}

// acc plus the first m floats of row (16-byte aligned), in order: four
// 16-byte words a step, the next step's read while this one is added, so
// that the dependent adds, not the loads, set the pace.
__device__ __forceinline__ float add_row(float acc, const float* row,
                                         int m) {
  const float4* r4 = (const float4*)row;
  const int m4 = m / 4, steps = m4 / 4;
  float4 v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v[u] = u < m4 ? r4[u] : float4{0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < steps; ++i) {
    float4 next[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * (i + 1) + u;
      next[u] = k < m4 ? r4[k] : v[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v[u].x), v[u].y),
                                v[u].z), v[u].w);
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = next[u];
  }
#pragma unroll
  for (int u = 0; u < 3; ++u)          // the words after the last step
    if (4 * steps + u < m4)
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v[u].x), v[u].y),
                                v[u].z), v[u].w);
  for (int c = 4 * m4; c < m; ++c) acc = __fadd_rn(acc, row[c]);
  return acc;
}

__device__ void ccalf_gate(const FlagParams& p) {
  using Lanes = float[8];
  X266_SHARED(Lanes, lanes);
  X266_DYNAMIC_SHARED(float4, gain4);         // [cy][gate_pitch(cx) / 4]
  float* gain = (float*)gain4;
  constexpr int kAhead = 8;
  const int tid = threadIdx.x, n = p.cy * p.cx, pitch = gate_pitch(p.cx);
  const int n4 = n / 4;
  const float4* src = (const float4*)p.sse;   // 16-byte aligned
  for (int i0 = tid; i0 < n4; i0 += kAhead * blockDim.x) {
    float4 v[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int i = i0 + j * blockDim.x;
      v[j] = i < n4 ? __ldcg(src + i) : float4{0.f, 0.f, 0.f, 0.f};
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i >= n4) break;
      int r = 4 * i / p.cx, c = 4 * i - r * p.cx;
      const float g[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        gain[r * pitch + c] = g[u];
        if (++c == p.cx) {
          c = 0;
          ++r;
        }
      }
    }
  }
  for (int k = 4 * n4 + tid; k < n; k += blockDim.x)
    gain[(k / p.cx) * pitch + k % p.cx] = __ldcg(p.sse + k);
  __syncthreads();
  const int nl = p.cy == 4 ? 4 : p.cy >= 8 ? 8 : 0;     // lanes
  const int r0 = nl ? p.cy - p.cy % nl : 0;            // rows in lanes
  if (tid < nl) {
    float acc = 0.f;
    for (int r = tid; r < r0; r += nl)
      acc = add_row(acc, gain + r * pitch, p.cx);
    lanes[tid] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    float tot = nl == 8 ? combine(lanes, 8, 1)
              : nl == 4 ? combine(lanes, 4, 1) : 0.f;
    for (int r = r0; r < p.cy; ++r) tot = add_row(tot, gain + r * pitch, p.cx);
    p.worth[0] = __fadd_rn(tot, p.lam_gate) < 0.f ? 1 : 0;
    *p.ticket = 0;
  }
}

// One thread block per CTB.  GATE: thread 0 takes a ticket with an
// acquire-release atomic add once it has written the CTB's flag and kept
// gain, and the block that takes the last ticket runs ccalf_gate; the
// instance without it compiles to the decision alone.
template <bool GATE>
__global__ void __launch_bounds__(kThreads) alf_ctb_flags(FlagParams p) {
  using Tot = int[2][4];
  using WSum = float[2][4];
  X266_SHARED(Tot, tot);
  X266_SHARED(WSum, wsum);
  const int tid = threadIdx.x;
  const int ctb = p.mode == 0 ? 64 : 32, nw = p.mode == 0 ? 4 : 1;
  const int y0 = (blockIdx.x / p.cx) * ctb, x0 = (blockIdx.x % p.cx) * ctb;
  if (tid < 8) tot[tid / 4][tid % 4] = 0;
  __syncthreads();
  // thread tid reads 4 columns (one 16-byte word of each plane: the
  // plane's width is a multiple of 4) of every step-th row, 4 rows in all
  // (blockDim.x = ctb * ctb / 16)
  const int groups = ctb / 4, c = (tid % groups) * 4;
  const int step = blockDim.x / groups;
  const int x = x0 + c, wc = ctb == 64 ? c / 32 : 0;
  int f_hi = 0, f_lo = 0, r_hi = 0, r_lo = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = tid / groups + u * step, y = y0 + r;
    if (r < ctb && y < p.h && x < p.w) {
      const size_t k = (size_t)y * p.w + x;
      const int4 o = *(const int4*)(p.orig + k);
      const int4 a = *(const int4*)(p.filt + k);
      const int4 bb = *(const int4*)(p.recon + k);
      const int fa = (a.x - o.x) * (a.x - o.x) + (a.y - o.y) * (a.y - o.y) +
                     (a.z - o.z) * (a.z - o.z) + (a.w - o.w) * (a.w - o.w);
      const int fr = (bb.x - o.x) * (bb.x - o.x) +
                     (bb.y - o.y) * (bb.y - o.y) +
                     (bb.z - o.z) * (bb.z - o.z) + (bb.w - o.w) * (bb.w - o.w);
      if (r < 32) {
        f_hi += fa;
        r_hi += fr;
      } else {
        f_lo += fa;
        r_lo += fr;
      }
    }
  }
  atomicAdd(&tot[0][wc], f_hi);
  atomicAdd(&tot[1][wc], r_hi);
  if (ctb == 64) {
    atomicAdd(&tot[0][2 + wc], f_lo);
    atomicAdd(&tot[1][2 + wc], r_lo);
  }
  __syncthreads();
  if (tid < 2 * nw) {
    const int pl = tid / nw, wi = tid % nw;
    const int32_t* a = pl ? p.recon : p.filt;
    const bool exact = tot[pl][wi] <= kExact;
    float s = (float)tot[pl][wi];
    if (!exact) {
      if (p.mode == 2) {
        s = row_vector_sum32(p, a, y0, x0);
      } else {
        const int wy = y0 + 32 * (wi / 2), wx = x0 + 32 * (wi % 2);
        s = 0.f;
        for (int r = 0; r < 32; ++r)
#pragma unroll 8
          for (int cc = 0; cc < 32; ++cc)
            s = __fadd_rn(s, sq_err(p, a, wy + r, wx + cc));
      }
    }
    wsum[pl][wi] = s;
    if (p.stats) atomicAdd(&p.stats[exact ? 0 : 1], 1);
  }
  __syncthreads();
  bool last = false;
  if (tid == 0) {
    float sse[2];
    for (int pl = 0; pl < 2; ++pl) {
      float s = 0.f;
      for (int wi = 0; wi < nw; ++wi) s = __fadd_rn(s, wsum[pl][wi]);
      sse[pl] = s;
    }
    const float gain = __fsub_rn(sse[0], sse[1]);
    const int flag = __fadd_rn(gain, p.lam15) < 0.f ? 1 : 0;
    p.flags[blockIdx.x] = flag;
    if constexpr (GATE) {
      p.sse[blockIdx.x] = flag ? gain : 0.f;      // the kept gain
      last = x266_atom_add_acq_rel(p.ticket, 1) ==
             (unsigned long long)(p.cy * p.cx - 1);
    } else if (p.sse) {
      p.sse[blockIdx.x] = sse[0];
      p.sse[(size_t)p.cy * p.cx + blockIdx.x] = sse[1];
    }
  }
  if constexpr (GATE) {
    X266_SHARED(int, gate);
    if (tid == 0) gate = last;
    __syncthreads();
    if (gate) ccalf_gate(p);
  }
}

// The nonlinear luma estimator's per-class SSE of 4x4 blocks at each clip
// level (alf.py class_sse_plain; reference :451-456): per level the SSE of
// each 4x4 block of the filtered plane against the source (an integer <=
// 16 * 255^2, exact in float32 in any order), then per (level, class) the
// dot over the blocks in raster order in XLA's order: below kFusedBlocks
// blocks 16 lanes folded in halves, from there 8 lanes folded in pairs
// (halves for class 24).  A lane's chain adds nonnegative integers, so it
// is exact while its sum stays <= 2^24: alf_class_blocks sums every
// (level, class, lane) chain in integers as it forms the blocks' SSEs,
// and alf_class_chains walks only the chains whose total passes 2^24 --
// their prefix up to 2^24 as an int32 sum, the rest by float32 adds in
// order.
//
// What bounds it: the bytes.  The exact pass reads each byte once -- a
// thread forms a block's SSE at every level from one read of the source's
// rows and the class, the levels as samples of S (uint8_t at 8 bits: 4
// bytes a block row) -- and writes the blocks' SSEs (int32) for the
// ordered pass.  The ordered pass gives each (level, class) with a chain
// past 2^24 a thread block, whose warps stream the class map and the
// level's block SSEs and keep only the class's blocks, lane by lane, for
// the walks: a chain's dependent adds are its class's blocks of the lane,
// not every block of the plane.  The chain totals are 0 between calls:
// alf_class_chains, their last reader, resets them.
constexpr int kFusedBlocks = 4096;
constexpr int kClsLanes = 16;
constexpr int kClsPerThread = 4;   // blocks a thread of alf_class_blocks forms
constexpr int kMaxLevels = 4;      // the nonlinear estimator's clip levels
constexpr int kChainWarps = 8;     // compacting warps of alf_class_chains
constexpr int kChainThreads = 32 * (kChainWarps + 1);
constexpr int kChainPer = 16;      // blocks a compacting thread holds a tile
constexpr int kChainTile = 32 * kChainWarps * kChainPer;
// a lane's row of slots in a tile: its kChainTile / L blocks, padded so
// that the walkers' 16-byte loads of 8 lanes hit distinct banks
__host__ __device__ constexpr int slot_pitch(int lanes) {
  return kChainTile / lanes + 4;
}
constexpr int kSlotFloats = 2 * kClsLanes * slot_pitch(kClsLanes);

struct ClassParams {
  const void* filt;       // (levels, h, w) samples
  const int32_t* orig;    // (h, w)
  const int32_t* cls;     // (h/4, w/4), 16-byte aligned
  int32_t* dblk;          // (levels, n) scratch: the blocks' SSEs
  unsigned long long* tot;  // (kMaxLevels, 25, kClsLanes) chain totals, 0
                            // between calls
  float* out;             // (levels, 25)
  int* stats;             // [exact, ordered] lane chains
  int levels, h, w, n;
};

__device__ __forceinline__ int class_lanes(int n) {
  return n < kFusedBlocks ? 16 : 8;
}

// Four samples of a block row (4-byte aligned), widened.
template <typename S>
__device__ __forceinline__ void load_row4(const S* s, int* v) {
  if constexpr (sizeof(S) == 1) {
    const uint32_t q = __ldg((const uint32_t*)s);
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = (int)((q >> (8 * u)) & 255u);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = (int)__ldg(s + u);
  }
}

__device__ __forceinline__ int sq4(const int* a, int4 o) {
  return (a[0] - o.x) * (a[0] - o.x) + (a[1] - o.y) * (a[1] - o.y) +
         (a[2] - o.z) * (a[2] - o.z) + (a[3] - o.w) * (a[3] - o.w);
}

// One thread block per run of kThreads * kClsPerThread blocks: each thread
// forms kClsPerThread blocks' SSEs at every level, and the thread block's
// (level, class, lane) sums (int32: at most 1,024 blocks of <= 1,040,400)
// go to the chain totals.
template <typename S>
__global__ void __launch_bounds__(kThreads) alf_class_blocks(ClassParams p) {
  using Sums = int[kMaxLevels][kMaxClasses][kClsLanes];
  X266_SHARED(Sums, sums);
  constexpr int per = kThreads * kClsPerThread;
  const int tid = threadIdx.x, L = class_lanes(p.n), b0 = blockIdx.x * per;
  for (int i = tid; i < kMaxLevels * kMaxClasses * kClsLanes; i += kThreads)
    sums[i / (kMaxClasses * kClsLanes)][(i / kClsLanes) % kMaxClasses]
        [i % kClsLanes] = 0;
  __syncthreads();
  const int bw = p.w >> 2;
  const size_t plane = (size_t)p.h * p.w;
  const S* f = (const S*)p.filt;
  for (int u = 0; u < kClsPerThread; ++u) {
    const int b = b0 + u * kThreads + tid;
    if (b >= p.n) break;
    const int y0 = (b / bw) * 4, x0 = (b % bw) * 4;
    const int c = __ldg(p.cls + b);
    X266_ASSERT(c >= 0 && c < kMaxClasses);
    int4 o[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      o[r] = __ldg((const int4*)(p.orig + (size_t)(y0 + r) * p.w + x0));
#pragma unroll
    for (int lv = 0; lv < kMaxLevels; ++lv) {
      if (lv < p.levels) {
        const S* s = f + lv * plane + (size_t)y0 * p.w + x0;
        int acc = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int a[4];
          load_row4(s + (size_t)r * p.w, a);
          acc += sq4(a, o[r]);
        }
        p.dblk[(size_t)lv * p.n + b] = acc;
        if (acc) atomicAdd(&sums[lv][c][b % L], acc);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < p.levels * kMaxClasses * L; i += kThreads) {
    const int lv = i / (kMaxClasses * L), c = (i / L) % kMaxClasses;
    const int l = i % L, v = sums[lv][c][l];
    if (v)
      atomicAdd(p.tot + ((size_t)lv * kMaxClasses + c) * kClsLanes + l,
                (unsigned long long)v);
  }
}

// The ordered chains of (level lv, class c).  Tile t is kChainTile
// blocks: warp w > 0's thread q holds blocks t * kChainTile + ((w - 1) *
// 32 + q) * kChainPer + i, i < kChainPer (16-byte loads of the class map
// and the block SSEs, the next tile's issued before this one is used),
// kChainPer / L blocks of each lane.  For each lane j the compacting
// warps write the tile's blocks of class c, in raster order and as
// float32 (exact: below 2^24), into lane j's row of slots: ballots give a
// warp's blocks and their places among its own, the warps' counts (behind
// a barrier of the compacting warps alone) each warp's offset.  Warp 0's
// thread j walks lane j's row of the tile before: the chain's integer sum
// while it stays <= 2^24, then float32 adds in order (add_row).  Two
// tiles of rows alternate, one block barrier a tile.
template <int L>
__device__ float class_chain(const ClassParams& p, int lv, int c,
                             bool ordered, float* slot, int* count,
                             int (*wcount)[kClsLanes]) {
  constexpr int kVec = kChainPer / 4;
  constexpr int kHalves = kChainPer / L;
  constexpr int kPitch = slot_pitch(L);
  const int tid = threadIdx.x, warp = tid / 32, q = tid % 32;
  const int tiles = (p.n + kChainTile - 1) / kChainTile;
  const int32_t* d = p.dblk + (size_t)lv * p.n;
  auto load = [&](int t, int4* cc, int4* dd) {
    const int k0 = t * kChainTile + ((warp - 1) * 32 + q) * kChainPer;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      if (k0 + 4 * u < p.n) {    // n is a multiple of 4
        cc[u] = __ldg((const int4*)(p.cls + k0) + u);
        dd[u] = __ldg((const int4*)(d + k0) + u);
      } else {
        cc[u] = int4{-1, -1, -1, -1};
        dd[u] = int4{0, 0, 0, 0};
      }
    }
  };
  int4 cv[kVec], dv[kVec], cn[kVec], dn[kVec];
  int exact = 0;
  bool past = false;
  float acc = 0.f;
  if (warp > 0) load(0, cv, dv);
  for (int t = 0; t <= tiles; ++t) {
    const int buf = t & 1;
    if (warp > 0 && t < tiles) {
      if (t + 1 < tiles) load(t + 1, cn, dn);
      const int w = warp - 1;
      int cl[kChainPer], vl[kChainPer];
      unsigned m[kChainPer];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        cl[4 * u] = cv[u].x, cl[4 * u + 1] = cv[u].y;
        cl[4 * u + 2] = cv[u].z, cl[4 * u + 3] = cv[u].w;
        vl[4 * u] = dv[u].x, vl[4 * u + 1] = dv[u].y;
        vl[4 * u + 2] = dv[u].z, vl[4 * u + 3] = dv[u].w;
      }
#pragma unroll
      for (int j = 0; j < L; ++j) {
        int k = 0;
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          m[h * L + j] = __ballot_sync(0xffffffffu, cl[h * L + j] == c);
          k += __popc(m[h * L + j]);
        }
        if (q == j) wcount[w][j] = k;
      }
      x266_bar_sync(1, kChainWarps * 32);
      int before = 0;                  // lane q's blocks in earlier warps
      if (q < L) {
#pragma unroll
        for (int u = 0; u < kChainWarps - 1; ++u)
          before += u < w ? wcount[u][q] : 0;
      }
      const unsigned below = (1u << q) - 1u;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        int at = __shfl_sync(0xffffffffu, before, j);
#pragma unroll
        for (int h = 0; h < kHalves; ++h) at += __popc(m[h * L + j] & below);
        float* row = slot + (buf * L + j) * kPitch;
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          if (cl[h * L + j] == c) row[at++] = (float)vl[h * L + j];
      }
      if (w == kChainWarps - 1 && q < L)
        count[buf * kClsLanes + q] = before + wcount[w][q];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        cv[u] = cn[u];
        dv[u] = dn[u];
      }
    } else if (warp == 0 && t > 0 && ordered) {
      const int pb = buf ^ 1, m = count[pb * kClsLanes + q];
      const float* s = slot + (pb * L + q) * kPitch;
      int e = 0;
      for (; e < m && !past; ++e) {
        const int v = (int)s[e];
        if (exact + v <= kExact) {
          exact += v;
        } else {
          acc = __fadd_rn((float)exact, s[e]);   // an integer <= 2^24
          past = true;
        }
      }
      for (; e < m && (e & 3); ++e) acc = __fadd_rn(acc, s[e]);
      if (e < m) acc = add_row(acc, s + e, m - e);
    }
    __syncthreads();
  }
  return past ? acc : (float)exact;
}

// One thread block per (level, class): each lane's total is read and reset
// to 0; a chain whose total is <= 2^24 is that total; if any passes it,
// class_chain walks the (level, class)'s chains.  Then thread 0 folds the
// lanes.
__global__ void __launch_bounds__(kChainThreads) alf_class_chains(
    ClassParams p) {
  using Lanes = float[kClsLanes];
  // two tiles of slots, a row a lane (float4: the walkers' 16-byte loads;
  // 8 lanes' rows take as many floats as 16 lanes')
  using Slots = float4[kSlotFloats / 4];
  using Counts = int[2 * kClsLanes];
  using WCounts = int[kChainWarps][kClsLanes];
  X266_SHARED(Lanes, lane);
  X266_SHARED(int, any);
  X266_SHARED(Slots, slot);
  X266_SHARED(Counts, count);
  X266_SHARED(WCounts, wcount);
  const int lv = blockIdx.x / kMaxClasses, c = blockIdx.x % kMaxClasses;
  const int tid = threadIdx.x, L = class_lanes(p.n);
  if (tid == 0) any = 0;
  __syncthreads();
  unsigned long long total = 0;
  if (tid < L) {
    unsigned long long* t =
        p.tot + ((size_t)lv * kMaxClasses + c) * kClsLanes + tid;
    total = *t;
    *t = 0;                        // for the next call
    if (total > (unsigned long long)kExact) any = 1;
    if (p.stats) atomicAdd(&p.stats[total > kExact ? 1 : 0], 1);
  }
  __syncthreads();
  const bool ordered = tid < L && total > (unsigned long long)kExact;
  float acc = (float)total;        // exact when the chain is
  if (any) {
    float* s = (float*)slot;
    const float v = L == 8 ? class_chain<8>(p, lv, c, ordered, s, count,
                                            wcount)
                           : class_chain<16>(p, lv, c, ordered, s, count,
                                             wcount);
    if (ordered) acc = v;
  }
  if (tid < L) lane[tid] = acc;
  __syncthreads();
  if (tid == 0) {
    float v[kClsLanes];
    for (int u = 0; u < L; ++u) v[u] = lane[u];
    const bool pairs = L == 8 && c < kMaxClasses - 1;
    p.out[lv * kMaxClasses + c] = combine(v, L, !pairs);
  }
}

template <int T, bool GRAM, bool NL>
int launch_block_sums(Order& o, cudaStream_t st) {
  constexpr int E = GRAM ? T * (T + 1) / 2 : T;
  void* args[] = {&o};
  constexpr int EA = GRAM ? E : 2 * T + 1;
  const size_t part_bytes = sizeof(int) * kBlockThreads * (EA | 1);
  cudaError_t err = cudaFuncSetAttribute(
      alf_block_exact<T, GRAM, NL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)part_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(alf_block_exact<T, GRAM, NL>, dim3(o.blocks),
                         dim3(kBlockThreads), args, part_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const int len = o.block < o.n ? o.block : o.n;
  const size_t bytes = ordered_smem_bytes(T, E, o.n_classes, o.lanes, len);
  auto kernel = o.lanes == 2 ? alf_block_ordered<T, GRAM, 2, NL>
                             : alf_block_ordered<T, GRAM, 4, NL>;
  if (o.lanes != 2 && o.lanes != 4) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaLaunchKernel(kernel, dim3(o.blocks < 1024 ? o.blocks : 1024),
                               dim3(kBlockThreads), args, bytes, st);
}

int launch_blocks(Order& o, cudaStream_t st) {
  const int chunks = (o.blocks + kChunkBlocks - 1) / kChunkBlocks;
  if (chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  cudaError_t z = cudaMemsetAsync(
      o.chunk, 0, sizeof(unsigned long long) * 2 * chunks * o.n_classes *
                      o.entries, st);
  if (z != cudaSuccess) return (int)z;
  // the nonlinear kinds: clipped, or aligned by transposes
  const bool nl = o.p.clip || o.p.tmap;
  int e = o.p.t == 12
              ? (nl ? (o.gram ? launch_block_sums<12, true, true>(o, st)
                              : launch_block_sums<12, false, true>(o, st))
                    : (o.gram ? launch_block_sums<12, true, false>(o, st)
                              : launch_block_sums<12, false, false>(o, st)))
        : o.p.t == 6
              ? (nl ? (o.gram ? launch_block_sums<6, true, true>(o, st)
                              : launch_block_sums<6, false, true>(o, st))
                    : (o.gram ? launch_block_sums<6, true, false>(o, st)
                              : launch_block_sums<6, false, false>(o, st)))
        : o.p.t == 7 ? (o.gram ? launch_block_sums<7, true, false>(o, st)
                               : launch_block_sums<7, false, false>(o, st))
                     : (int)cudaErrorInvalidValue;
  if (e) return e;
  void* args[] = {&o};
  const int groups = (o.entries + kGroup - 1) / kGroup;
  return (int)cudaLaunchKernel(alf_total_sums, dim3(o.n_classes * groups),
                               dim3(kTotThreads), args, 0, st);
}

}  // namespace

extern "C" {

// The estimator's normal equations and coefficients on `stream`, from the
// post-SAO recon and the source (h x w int32) and the class map (h/4 x w/4
// int32, or null: one class) with the diamond of t taps (12: alf.py
// DIAMOND, 6: CHROMA_DIAMOND), each difference clipped to +-clip when clip
// > 0 and, for t = 12, the features permuted by the transpose map tmap
// (h/4 x w/4 int32) when it is not null; or t = 7, CC-ALF's features from
// the luma (lh x lw int32, 2h x 2w) with the error orig - base (base: the
// chroma plane, h x w).  The gram sums run in the order
// (gram_block, gram_lanes, gram_halves) and the rhs sums in (rhs_*); a
// block of 0 is the whole plane (one class, 8 lanes, t = 6 or 7 only).
// Scratch: partial_g (blocks x C x t(t+1)/2), partial_r (blocks x C x t) float, block_ordered (the
// larger count of blocks) int32, chunk (ceil(blocks / 128) x C x
// t(t+1)/2 x 2 for the gram's blocks) int64, and for a whole-plane
// rhs segments (segments x 2 x t x lanes) int32 and terms (t x h*w)
// float; outputs gram (C, t, t) and rhs (C, t) float, coef (C, t) int32,
// stats (4 int32, zeroed by the caller: chains exact, chains ordered,
// totals exact, totals ordered).  Returns cudaGetLastError().
int x266_alf_normal(int h, int w, int t, int n_classes, const void* recon,
                    const void* orig, const void* cls, const void* tmap,
                    int clip, const void* luma, const void* base, int lh,
                    int lw, int gram_block,
                    int gram_lanes, int gram_halves, int rhs_block,
                    int rhs_lanes, int rhs_halves,
                    void* partial_g, void* partial_r, void* block_ordered,
                    void* chunk, void* segments, void* terms, void* gram,
                    void* rhs, void* coef, void* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool cc = t == 7;
  if ((t != 12 && t != 6 && t != 7) || n_classes > kMaxClasses ||
      gram_lanes > kMaxLanes ||
      rhs_lanes > kMaxLanes || (w & 3) || (h & 3) || (h * w) % 8 ||
      gram_block <= 0 || clip < 0 || clip > 256 || (tmap && t != 12) ||
      (cc && (!luma || !base || lh != 2 * h || lw != 2 * w || cls || clip)))
    return (int)cudaErrorInvalidValue;
  Plane pl{cc ? (const int32_t*)luma : (const int32_t*)recon,
           cc ? (const int32_t*)base : (const int32_t*)recon,
           (const int32_t*)orig, (const int32_t*)cls, (const int32_t*)tmap,
           h, w, t, clip, cc ? lh : h, cc ? lw : w};
  const int n = h * w;
  Order o{};
  o.p = pl;
  o.block_ordered = (int*)block_ordered;
  o.chunk = (unsigned long long*)chunk;
  o.n = n;
  o.n_classes = n_classes;
  o.stats = (int*)stats;
  // the gram
  o.partial = (float*)partial_g;
  o.out = (float*)gram;
  o.entries = t * (t + 1) / 2;
  o.block = gram_block < n ? gram_block : n;
  o.lanes = gram_lanes;
  o.halves = gram_halves;
  o.gram = 1;
  o.blocks = (n + o.block - 1) / o.block;
  int e = launch_blocks(o, st);
  if (e) return e;
  // the rhs
  if (rhs_block > 0) {
    o.partial = (float*)partial_r;
    o.out = (float*)rhs;
    o.entries = t;
    o.block = rhs_block < n ? rhs_block : n;
    o.lanes = rhs_lanes;
    o.halves = rhs_halves;
    o.gram = 0;
    o.blocks = (n + o.block - 1) / o.block;
    e = launch_blocks(o, st);
    if (e) return e;
  } else {
    PlaneChains q{pl, (int*)segments, (float*)terms, (float*)rhs,
                  (int*)stats, n, rhs_lanes, rhs_halves,
                  (n + kSegment - 1) / kSegment};
    if (n_classes != 1 || rhs_lanes != kMaxLanes || t == 12 ||
        q.segments > kMaxSegments)
      return (int)cudaErrorInvalidValue;
    void* args[] = {&q};
    auto segs = t == 7 ? alf_plane_segments<7, false>
                : clip ? alf_plane_segments<6, true>
                       : alf_plane_segments<6, false>;
    cudaError_t r = cudaLaunchKernel(segs, dim3(q.segments), dim3(kThreads),
                                     args, 0, st);
    if (r != cudaSuccess) return (int)r;
    r = cudaLaunchKernel(alf_plane_chains, dim3(t), dim3(kThreads), args, 0,
                         st);
    if (r != cudaSuccess) return (int)r;
  }
  SolveParams q{(const float*)gram, (const float*)rhs, (int32_t*)coef,
                n_classes, t};
  void* args[] = {&q};
  cudaError_t r = cudaLaunchKernel(alf_solve, dim3((n_classes + 31) / 32),
                                   dim3(32), args, 0, st);
  return (int)(r != cudaSuccess ? r : cudaGetLastError());
}

// The per-CTB ALF flags of filt against recon, both against orig (int32,
// h x w), into flags (cy x cx int32) on `stream`, in the order `mode` (see
// alf_ctb_flags); sse (2 x cy x cx float, the two SSEs) and stats (2
// int32: windows exact, ordered) may be null.  With worth (1 int32; sse
// and ticket not null, mode 1 or 2) CC-ALF's whole-filter gate too, at the
// end of the same launch (ccalf_gate, lam_gate the float32 of lam * (112 +
// cy * cx)); sse (16-byte aligned) then holds the CTBs' kept gains in its
// first row instead of the SSEs; ticket (1 uint64) is 0 before the call
// and after it.
// Returns cudaGetLastError().
int x266_alf_ctb_flags(int h, int w, int mode, float lam15, const void* filt,
                       const void* recon, const void* orig, void* flags,
                       void* sse, void* stats, float lam_gate, void* worth,
                       void* ticket, void* stream) {
  const int ctb = mode == 0 ? 64 : 32;
  if (worth && (!sse || !ticket || mode == 0 || ((uintptr_t)sse & 15)))
    return (int)cudaErrorInvalidValue;
  FlagParams p{(const int32_t*)filt, (const int32_t*)recon,
               (const int32_t*)orig, (int32_t*)flags, (float*)sse,
               (int*)stats, lam15, h, w, (h + ctb - 1) / ctb,
               (w + ctb - 1) / ctb, mode, (unsigned long long*)ticket,
               (int32_t*)worth, lam_gate};
  void* args[] = {&p};
  const dim3 grid(p.cy * p.cx), block(ctb * ctb / 16);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (!worth) {
    err = cudaLaunchKernel(alf_ctb_flags<false>, grid, block, args, 0, st);
  } else {
    // the gate's kept gains, rows of gate_pitch floats
    const size_t bytes = sizeof(float) * p.cy * gate_pitch(p.cx);
    if (bytes > kMaxGateBytes) return (int)cudaErrorInvalidValue;
    if (bytes > kDefaultSharedBytes) {
      err = cudaFuncSetAttribute(alf_ctb_flags<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaLaunchKernel(alf_ctb_flags<true>, grid, block, args, bytes, st);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The per-class SSE of 4x4 blocks of `levels` (<= 4) filtered planes
// (levels x h x w uint8) against orig (h x w int32) by the class map cls
// (h/4 x w/4 int32, 16-byte aligned) into out (levels x 25 float) on
// `stream`, in XLA's order (alf_class_chains); scratch: dblk, levels x
// (h/4)(w/4) int32, and tot, 4 x 25 x 16 uint64, 0 before the call and
// after it; stats (2 int32: lane chains exact, with an ordered tail) may
// be null.  Returns cudaGetLastError().
int x266_alf_class_sse(int levels, int h, int w, const void* filt,
                       const void* orig, const void* cls, void* dblk,
                       void* tot, void* out, void* stats, void* stream) {
  const int n = (h / 4) * (w / 4);
  if ((h & 3) || (w & 3) || levels < 1 || levels > kMaxLevels ||
      (n < kFusedBlocks ? n % 16 : n % 8) || ((uintptr_t)cls & 15) ||
      ((uintptr_t)dblk & 15))
    return (int)cudaErrorInvalidValue;
  ClassParams p{filt, (const int32_t*)orig, (const int32_t*)cls,
                (int32_t*)dblk, (unsigned long long*)tot, (float*)out,
                (int*)stats, levels, h, w, n};
  void* args[] = {&p};
  cudaStream_t st = (cudaStream_t)stream;
  const int per = kThreads * kClsPerThread;
  cudaError_t err = cudaLaunchKernel(alf_class_blocks<uint8_t>,
                                     dim3((n + per - 1) / per),
                                     dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(alf_class_chains, dim3(levels * kMaxClasses),
                         dim3(kChainThreads), args, 0, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
