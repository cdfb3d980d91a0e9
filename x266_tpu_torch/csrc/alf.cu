// ALF estimator: the per-class normal equations of the encoder's Wiener
// filters and their float32 solve, as the reference computes them on XLA's
// CPU backend (port-only kernel; ROADMAP queue 3, F9).
//
// Replaces no Pallas kernel: the reference runs these sums as XLA dots
// (x266_tpu/kernels/alf.py:367-370 luma, :278-280 chroma) and the solve as
// jnp.linalg.solve.  The plain PyTorch version is kernels/alf.py
// (ordered_sums, solve_f32, coefficients); the two agree bit for bit.
//
// What the result is fixed by: float32 rounding in XLA's order.  Per
// (class, entry) the samples run in blocks of `block` in raster order;
// inside a block lane l adds the samples at offsets l, l + lanes, ... one
// after another; the lanes combine in pairs or halves, and the block sums
// add up in order (alf.py SUM_ORDERS).  So the design is two passes:
//   1. one thread block per block of samples; each thread owns one
//      (entry, lane) and adds its samples in order into a per-class
//      accumulator in shared memory (a sample outside a class adds 0 to
//      it, which changes no float32 sum); then one thread per (class,
//      entry) combines the lanes into the block's sum.  With one class
//      (chroma), whose rhs lanes run the whole plane, one block per
//      (block of samples, entry) instead: its threads stage tiles of the
//      entry's two planes and the lanes' owners add from shared memory;
//   2. one thread per (class, entry) adds the block sums in order.
// A third kernel solves each (class) system in one thread, repeating the
// float32 operations of OpenBLAS's sgetrf and strsm that jaxlib calls,
// with __fmaf_rn where they fuse and __fmul_rn/__fadd_rn elsewhere (the
// library is built with -fmad=false).  Products of features and errors are
// integers below 2^24, so float32 holds them exactly.  A fourth kernel
// sums the per-CTB SSE of the on/off decision (alf.py:335-338, :379-382)
// in XLA's reduction order, one thread per CTB.
//
// What bounds it on the H100: bytes and the lanes' dependent adds.  A 4K
// luma plane has 8.3M samples; the 144 gram entries read 12 feature planes
// (int32) and the class plane once per block, and the partial sums write
// (blocks x classes x entries) floats.  It is CUDA, not Triton, because
// the result is fixed by a per-thread sequential order with a per-class
// scatter, which is neither an elementwise pass nor a reduction of free
// order.  Nothing is read back to the host.

#include <cstdint>
#include <cuda_runtime.h>

#include "x266_device.cuh"

namespace {

constexpr int kMaxLanes = 8;
constexpr int kMaxT = 12;
constexpr int kTile = 4096;       // samples staged per tile, one class
constexpr int kEntryThreads = 256;

struct SumParams {
  const int32_t* feats;   // (T, N) features
  const int32_t* err;     // (N) errors
  const int32_t* cls;     // (N) classes, or null: one class
  float* partial;         // (blocks, C, E) block sums
  float* out;             // (C, E) sums
  int t, n, n_classes, entries, block, lanes, halves, gram, blocks;
};

__device__ float combine(float* v, int lanes, int halves) {
  float t[kMaxLanes];
  for (int l = 0; l < lanes; ++l) t[l] = v[l];
  for (int m = lanes; m > 1; m >>= 1)
    for (int q = 0; q < m / 2; ++q)
      t[q] = halves ? __fadd_rn(t[q], t[q + m / 2])
                    : __fadd_rn(t[2 * q], t[2 * q + 1]);
  return t[0];
}

__global__ void alf_block_sums(SumParams p) {
  X266_DYNAMIC_SHARED(float, acc);          // [n_classes][entries * lanes]
  const int el = p.entries * p.lanes;
  const int tid = threadIdx.x;
  const size_t k0 = (size_t)blockIdx.x * p.block;
  const long long rest = (long long)p.n - (long long)k0;
  const int len = rest < p.block ? (int)rest : p.block;
  for (int i = tid; i < p.n_classes * el; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  if (tid < el) {
    const int e = tid / p.lanes, l = tid % p.lanes;
    const int fi = p.gram ? e / p.t : e;
    const int32_t* a = p.feats + (size_t)fi * p.n;
    const int32_t* b = p.gram ? p.feats + (size_t)(e % p.t) * p.n : p.err;
    for (int k = l; k < len; k += p.lanes) {
      const size_t kk = k0 + k;
      const int c = p.cls[kk];
      const float v = (float)(a[kk] * b[kk]);
      acc[c * el + tid] = __fadd_rn(acc[c * el + tid], v);
    }
  }
  __syncthreads();
  for (int i = tid; i < p.n_classes * p.entries; i += blockDim.x) {
    const int c = i / p.entries, e = i % p.entries;
    p.partial[((size_t)blockIdx.x * p.n_classes + c) * p.entries + e] =
        combine(acc + c * el + e * p.lanes, p.lanes, p.halves);
  }
}

// One class (chroma): the rhs's lanes each run one chain over the whole
// plane, so one block per (block of samples, entry): its threads stage
// tiles of the entry's two planes in shared memory, many loads in flight,
// and the lanes' owners add from there in order, each chain in a register.
__global__ void __launch_bounds__(kEntryThreads) alf_entry_sums(SumParams p) {
  using Tile = int32_t[kTile];
  using Lanes = float[kMaxLanes];
  X266_SHARED(Tile, sx);
  X266_SHARED(Tile, sy);
  X266_SHARED(Lanes, lane);
  const int tid = threadIdx.x;
  const int blk = blockIdx.x / p.entries, e = blockIdx.x % p.entries;
  const int32_t* a = p.feats + (size_t)(p.gram ? e / p.t : e) * p.n;
  const int32_t* b = p.gram ? p.feats + (size_t)(e % p.t) * p.n : p.err;
  const size_t k0 = (size_t)blk * p.block;
  const long long rest = (long long)p.n - (long long)k0;
  const int len = rest < p.block ? (int)rest : p.block;
  const int step = p.lanes;
  float r = 0.f;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int tl = len - t0 < kTile ? len - t0 : kTile;
#pragma unroll
    for (int q = 0; q < kTile / kEntryThreads; ++q) {
      const int k = tid + q * kEntryThreads;
      if (k < tl) {
        sx[k] = a[k0 + t0 + k];
        sy[k] = b[k0 + t0 + k];
      }
    }
    __syncthreads();
    if (tid < step) {
      int k = tid;
      for (; k + 7 * step < tl; k += 8 * step) {  // read ahead, add in order
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = (float)(sx[k + u * step] * sy[k + u * step]);
#pragma unroll
        for (int u = 0; u < 8; ++u) r = __fadd_rn(r, v[u]);
      }
      for (; k < tl; k += step) r = __fadd_rn(r, (float)(sx[k] * sy[k]));
      lane[tid] = r;
    }
    __syncthreads();
  }
  if (tid == 0)
    p.partial[(size_t)blk * p.entries + e] = combine(lane, step, p.halves);
}

__global__ void alf_total_sums(SumParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_classes * p.entries) return;
  float tot = 0.f;
  for (int b = 0; b < p.blocks; ++b)
    tot = __fadd_rn(tot, p.partial[(size_t)b * p.n_classes * p.entries + i]);
  p.out[i] = tot;
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

// The per-CTB float32 SSE of (a - o)^2 in XLA CPU's reduction order, as
// alf.py ctb_sse: mode 0, a 64x64 CTB as four 32x32 windows each in
// raster order, then the windows in raster order; mode 1, a 32x32 CTB in
// raster order; mode 2, a 32x32 CTB row by row through eight lanes
// (cost.py _row_sum32).  One thread per CTB; samples past the plane are 0.
struct SseParams {
  const int32_t* a;
  const int32_t* o;
  float* out;             // (cy, cx)
  int h, w, cy, cx, mode;
};

__device__ float sq_err(const SseParams& p, int y, int x) {
  if (y >= p.h || x >= p.w) return 0.f;
  const float d = (float)(p.a[(size_t)y * p.w + x] - p.o[(size_t)y * p.w + x]);
  return __fmul_rn(d, d);
}

__global__ void alf_ctb_sse(SseParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.cy * p.cx) return;
  const int ctb = p.mode == 0 ? 64 : 32;
  const int y0 = (i / p.cx) * ctb, x0 = (i % p.cx) * ctb;
  float tot = 0.f;
  if (p.mode == 0) {
    for (int q = 0; q < 4; ++q) {
      float s = 0.f;
      for (int r = 0; r < 32; ++r)
        for (int c = 0; c < 32; ++c)
          s = __fadd_rn(s, sq_err(p, y0 + 32 * (q / 2) + r,
                                  x0 + 32 * (q % 2) + c));
      tot = __fadd_rn(tot, s);
    }
  } else if (p.mode == 1) {
    for (int r = 0; r < 32; ++r)
      for (int c = 0; c < 32; ++c)
        tot = __fadd_rn(tot, sq_err(p, y0 + r, x0 + c));
  } else {
    for (int r = 0; r < 32; ++r) {
      float v[32], lane[8];
      for (int c = 0; c < 32; ++c) v[c] = sq_err(p, y0 + r, x0 + c);
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
  }
  p.out[i] = tot;
}

int launch_sums(SumParams& p, int block, int lanes, int halves, int gram,
                cudaStream_t st) {
  p.block = block > 0 && block < p.n ? block : p.n;
  p.lanes = lanes; p.halves = halves; p.gram = gram;
  p.entries = gram ? p.t * p.t : p.t;
  p.blocks = (p.n + p.block - 1) / p.block;
  void* args[] = {&p};
  const int el = p.entries * p.lanes;
  cudaError_t err =
      p.cls ? cudaLaunchKernel(alf_block_sums, dim3(p.blocks),
                               dim3(el < 64 ? 64 : el), args,
                               sizeof(float) * p.n_classes * el, st)
            : cudaLaunchKernel(alf_entry_sums, dim3(p.blocks * p.entries),
                               dim3(kEntryThreads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  const int total = p.n_classes * p.entries;
  err = cudaLaunchKernel(alf_total_sums, dim3((total + 127) / 128),
                         dim3(128), args, 0, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// The estimator's normal equations and coefficients on `stream`: feats
// (T, N), err (N), cls (N) or null (one class) int32; the gram sums in
// the order (gram_block, gram_lanes, gram_halves), the rhs sums in the
// order (rhs_*); scratch partial_g (blocks x C x T*T) and partial_r
// (blocks x C x T) float; outputs gram (C, T, T) and rhs (C, T) float
// and coef (C, T) int32.  Returns cudaGetLastError().
int x266_alf_normal(int t, int n, int n_classes, const void* feats,
                    const void* err, const void* cls, int gram_block,
                    int gram_lanes, int gram_halves, int rhs_block,
                    int rhs_lanes, int rhs_halves, void* partial_g,
                    void* partial_r, void* gram, void* rhs, void* coef,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (t > kMaxT || gram_lanes > kMaxLanes || rhs_lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  SumParams p{};
  p.feats = (const int32_t*)feats; p.err = (const int32_t*)err;
  p.cls = (const int32_t*)cls; p.t = t; p.n = n; p.n_classes = n_classes;
  p.partial = (float*)partial_g; p.out = (float*)gram;
  int e = launch_sums(p, gram_block, gram_lanes, gram_halves, 1, st);
  if (e) return e;
  p.partial = (float*)partial_r; p.out = (float*)rhs;
  e = launch_sums(p, rhs_block, rhs_lanes, rhs_halves, 0, st);
  if (e) return e;
  SolveParams q{(const float*)gram, (const float*)rhs, (int32_t*)coef,
                n_classes, t};
  void* args[] = {&q};
  cudaError_t r = cudaLaunchKernel(alf_solve, dim3((n_classes + 31) / 32),
                                   dim3(32), args, 0, st);
  return (int)(r != cudaSuccess ? r : cudaGetLastError());
}

// The per-CTB SSE of a against o (int32, h x w) into out (cy x cx float)
// on `stream`, in the order `mode` (see alf_ctb_sse).  Returns
// cudaGetLastError().
int x266_alf_ctb_sse(int h, int w, int mode, const void* a, const void* o,
                     void* out, void* stream) {
  const int ctb = mode == 0 ? 64 : 32;
  SseParams p{(const int32_t*)a, (const int32_t*)o, (float*)out, h, w,
              (h + ctb - 1) / ctb, (w + ctb - 1) / ctb, mode};
  void* args[] = {&p};
  const int n = p.cy * p.cx;
  cudaError_t err = cudaLaunchKernel(alf_ctb_sse, dim3((n + 63) / 64),
                                     dim3(64), args, 0, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
