// ALF estimator: the per-class normal equations of the encoder's Wiener
// filters and their float32 solve, and the per-CTB on/off decision, as the
// reference computes them on XLA's CPU backend (port-only kernels; ROADMAP
// queue 3, F9).
//
// Replaces no Pallas kernel: the reference runs the sums as XLA dots
// (x266_tpu/kernels/alf.py:367-370 luma, :278-280 chroma), the solve as
// jnp.linalg.solve and the decision's per-CTB SSE as an XLA reduction
// (:335-338, :379-382).  The plain PyTorch versions are kernels/alf.py
// (normal_solve_plain: _diff_planes, normal_sums, coefficients;
// _ctb_flags: ctb_sse_plain); the kernels agree with them bit for bit.
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
//      is the CTB's flag.
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

// The estimator's inputs and one order of its sums.
struct Plane {
  const int32_t* recon;   // (h, w) post-SAO
  const int32_t* orig;    // (h, w) source
  const int32_t* cls;     // (h/4, w/4) classes, or null: one class
  int h, w, t;            // t: the diamond's taps, 12 (luma) or 6 (chroma)
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

__device__ float combine(const float* v, int lanes, int halves) {
  float t[kMaxLanes];
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

// Sample (y, x)'s T features and its error, with the plane's wrap.
template <int T>
__device__ void features(const Plane& p, int y, int x, int* f) {
  const int32_t* r = p.recon;
  const int ctr = __ldg(r + y * p.w + x);
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int dy = tap_dy<T>(i), dx = tap_dx<T>(i);
    const int y0 = wrap(y + dy, p.h), x0 = wrap(x + dx, p.w);
    const int y1 = wrap(y - dy, p.h), x1 = wrap(x - dx, p.w);
    f[i] = __ldg(r + y0 * p.w + x0) + __ldg(r + y1 * p.w + x1) - 2 * ctr;
  }
  f[T] = __ldg(p.orig + y * p.w + x) - ctr;
}

// The T features and the error of the 4 samples of the cell at (y, x) (x
// a multiple of 4): each of the diamond's rows read as three 16-byte words
// (columns x - 4 .. x + 7), wrapped like jnp.roll at the plane's edges.
template <int T>
__device__ __forceinline__ void cell_features(const Plane& p, int y, int x,
                                              int (*f)[T + 1]) {
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
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int ctr = row[R][u + 4];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int dy = tap_dy<T>(i), dx = tap_dx<T>(i);
      f[u][i] = row[R + dy][u + 4 + dx] + row[R - dy][u + 4 - dx] - 2 * ctr;
    }
    f[u][T] = ov[u] - ctr;
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
template <int T, bool GRAM>
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
      cell_features<T>(p, y, x, f);
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
template <int T, bool GRAM, int L>
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
    cell_features<T>(p, y, x, f);
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
template <int T, bool GRAM, int L>
__global__ void __launch_bounds__(kBlockThreads) alf_block_ordered(Order o) {
  for (int b = blockIdx.x; b < o.blocks; b += gridDim.x)
    if (o.block_ordered[b]) ordered_block<T, GRAM, L>(o, b);
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

template <int T>
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
    features<T>(q.p, k / q.p.w, k % q.p.w, f);
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
// summed in order from the planes.
struct FlagParams {
  const int32_t* filt;
  const int32_t* recon;
  const int32_t* orig;
  int32_t* flags;         // (cy, cx)
  float* sse;             // (2, cy, cx) filtered, unfiltered, or null
  int* stats;             // [exact, ordered] windows
  float lam15;
  int h, w, cy, cx, mode;
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
  if (tid == 0) {
    float sse[2];
    for (int pl = 0; pl < 2; ++pl) {
      float s = 0.f;
      for (int wi = 0; wi < nw; ++wi) s = __fadd_rn(s, wsum[pl][wi]);
      sse[pl] = s;
    }
    const float gain = __fsub_rn(sse[0], sse[1]);
    p.flags[blockIdx.x] = __fadd_rn(gain, p.lam15) < 0.f ? 1 : 0;
    if (p.sse) {
      p.sse[blockIdx.x] = sse[0];
      p.sse[(size_t)p.cy * p.cx + blockIdx.x] = sse[1];
    }
  }
}

template <int T, bool GRAM>
int launch_block_sums(Order& o, cudaStream_t st) {
  constexpr int E = GRAM ? T * (T + 1) / 2 : T;
  void* args[] = {&o};
  constexpr int EA = GRAM ? E : 2 * T + 1;
  const size_t part_bytes = sizeof(int) * kBlockThreads * (EA | 1);
  cudaError_t err = cudaFuncSetAttribute(
      alf_block_exact<T, GRAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)part_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(alf_block_exact<T, GRAM>, dim3(o.blocks),
                         dim3(kBlockThreads), args, part_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const int len = o.block < o.n ? o.block : o.n;
  const size_t bytes = ordered_smem_bytes(T, E, o.n_classes, o.lanes, len);
  auto kernel = o.lanes == 2 ? alf_block_ordered<T, GRAM, 2>
                             : alf_block_ordered<T, GRAM, 4>;
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
  int e = o.p.t == 12 ? (o.gram ? launch_block_sums<12, true>(o, st)
                                : launch_block_sums<12, false>(o, st))
        : o.p.t == 6 ? (o.gram ? launch_block_sums<6, true>(o, st)
                               : launch_block_sums<6, false>(o, st))
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
// DIAMOND, 6: CHROMA_DIAMOND).  The gram sums run in the order
// (gram_block, gram_lanes, gram_halves) and the rhs sums in (rhs_*); a
// block of 0 is the whole plane (one class, 8 lanes, t = 6 only).
// Scratch: partial_g (blocks x C x t(t+1)/2), partial_r (blocks x C x t) float, block_ordered (the
// larger count of blocks) int32, chunk (ceil(blocks / 128) x C x
// t(t+1)/2 x 2 for the gram's blocks) int64, and for a whole-plane
// rhs segments (segments x 2 x t x lanes) int32 and terms (t x h*w)
// float; outputs gram (C, t, t) and rhs (C, t) float, coef (C, t) int32,
// stats (4 int32, zeroed by the caller: chains exact, chains ordered,
// totals exact, totals ordered).  Returns cudaGetLastError().
int x266_alf_normal(int h, int w, int t, int n_classes, const void* recon,
                    const void* orig, const void* cls, int gram_block,
                    int gram_lanes, int gram_halves, int rhs_block,
                    int rhs_lanes, int rhs_halves,
                    void* partial_g, void* partial_r, void* block_ordered,
                    void* chunk, void* segments, void* terms, void* gram,
                    void* rhs, void* coef, void* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((t != 12 && t != 6) || n_classes > kMaxClasses ||
      gram_lanes > kMaxLanes ||
      rhs_lanes > kMaxLanes || (w & 3) || (h & 3) || (h * w) % 8 ||
      gram_block <= 0)
    return (int)cudaErrorInvalidValue;
  Plane pl{(const int32_t*)recon, (const int32_t*)orig, (const int32_t*)cls,
           h, w, t};
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
    if (n_classes != 1 || rhs_lanes != kMaxLanes || t != 6 ||
        q.segments > kMaxSegments)
      return (int)cudaErrorInvalidValue;
    void* args[] = {&q};
    cudaError_t r = cudaLaunchKernel(alf_plane_segments<6>, dim3(q.segments),
                                     dim3(kThreads), args, 0, st);
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
// int32: windows exact, ordered) may be null.  Returns cudaGetLastError().
int x266_alf_ctb_flags(int h, int w, int mode, float lam15, const void* filt,
                       const void* recon, const void* orig, void* flags,
                       void* sse, void* stats, void* stream) {
  const int ctb = mode == 0 ? 64 : 32;
  FlagParams p{(const int32_t*)filt, (const int32_t*)recon,
               (const int32_t*)orig, (int32_t*)flags, (float*)sse,
               (int*)stats, lam15, h, w, (h + ctb - 1) / ctb,
               (w + ctb - 1) / ctb, mode};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchKernel(alf_ctb_flags, dim3(p.cy * p.cx),
                                     dim3(ctb * ctb / 16), args, 0,
                                     (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
