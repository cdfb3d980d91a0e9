// Motion kernels K4 (MC warp) and K5 (ME refine).
//
// K4 replaces the Pallas TPU kernel x266_tpu/kernels/me_pallas.py:
// _build_warp (pl.pallas_call at :91).  For each of T motion fields and
// each 16x16 ME block it copies the quarter-pel MC prediction out of the
// 16-plane luma pyramid:
//   out[t, y, x] = pyr[(mvy&3)*4 + (mvx&3), y + REF_PAD + (mvy>>2),
//                                           x + REF_PAD + (mvx>>2)]
// with (mvx, mvy) = mvs[t, y/16, x/16], as int32 frames (T, 16*By, 16*Bx)
// that P Pass A cuts into per-CU predictions.  Plain version:
// kernels/me_cuda.py warp_frames_ref (interp.mc_block per block).
// What bounds it on the H100: bytes.  It moves T*16By*16Bx samples (one
// byte read, four written each; at T=6 and 1080p about 63 MB written)
// and does no arithmetic.  Design: one thread block per ME block, one
// thread per sample, so a warp reads two 16-byte pyramid rows and writes
// two 64-byte output rows; nothing is staged.
//
// K5 replaces _build_refine2 (pl.pallas_call at :285), the combined
// refinement of hierarchical ME: per ME block around a full-pel base MV,
// the 9 stride-2 full-pel SADs, then the 9 stride-1 SADs around that
// winner, then the 25 quarter-pel SADs around that; each step keeps the
// first minimum in candidate order (strict <, kernels/me.py:_REF_DELTAS_A,
// _REF_DELTAS_B, _QP_DELTAS).  Plain version: kernels/me.py
// refine_search_ref.  What bounds it: neither bytes nor operations at
// 1080p (8,160 blocks x 43 candidates x 256 absolute differences, ~90 M
// integer operations, and ~11 MB of pyramid reads that mostly hit L2);
// the three dependent steps are the latency.  Design: one thread block
// per ME block, one thread per sample; each step evaluates all its
// candidates at once into shared memory and reduces them together in
// one 8-level tree, so a block pays 3 x 9 barriers.
//
// Both launch through cudaLaunchKernel, so tests/test_torch_kernel_host.py
// can compile this file with g++ against tests/cuda_host/cuda_runtime.h.

#include <cstdint>
#include <cuda_runtime.h>

#include "x266_device.cuh"

namespace {

constexpr int kBlk = 16;            // ME block side
constexpr int kPad = 80;            // interp.REF_PAD
constexpr int kThreads = kBlk * kBlk;
constexpr int kMaxCands = 25;

struct WarpParams {
  int by, bx;                       // ME grid
  int hp, wp;                       // pyramid plane size
  const int32_t* mvs;               // (T, By, Bx, 2)
  const uint8_t* pyr;               // (16, Hp, Wp)
  int32_t* out;                     // (T, 16By, 16Bx)
};

__global__ void __launch_bounds__(kThreads) warp_kernel(WarpParams p) {
  const int b = blockIdx.x;                     // (t, i, j) ME block
  const int j = b % p.bx, i = (b / p.bx) % p.by, t = b / (p.bx * p.by);
  const int r = threadIdx.x / kBlk, c = threadIdx.x % kBlk;
  const int32_t* mv = p.mvs + 2 * (size_t)b;
  const int mvx = mv[0], mvy = mv[1];
  const int f = (mvy & 3) * 4 + (mvx & 3);
  const int y = i * kBlk + r, x = j * kBlk + c;
  const int py = y + kPad + (mvy >> 2), px = x + kPad + (mvx >> 2);
  X266_ASSERT(py >= 0 && py < p.hp && px >= 0 && px < p.wp);
  const uint8_t v = __ldg(p.pyr + ((size_t)f * p.hp + py) * p.wp + px);
  p.out[((size_t)t * p.by * kBlk + y) * (p.bx * kBlk) + x] = v;
}

struct RefineParams {
  int by, bx;                       // ME grid
  int cur_w;                        // cur row pitch (16 * Bx)
  int hp, wp;                       // pyramid plane size
  const int32_t* cur;               // (16By, 16Bx)
  const uint8_t* pyr;               // (16, Hp, Wp)
  const int32_t* base;              // (By, Bx, 2) full-pel
  int32_t* out;                     // (By, Bx, 2) quarter-pel
};

// The n candidates' SADs of this block at quarter-pel MVs
// (mx0 + dx[k], my0 + dy[k]) (dx, dy in quarter-pel), reduced in shared
// memory; returns the index of the first minimum.  All threads call it.
__device__ int best_candidate(const RefineParams& p, int (*part)[kThreads],
                              int* best, int gx, int gy, int mx0, int my0,
                              const int* dx, const int* dy, int n) {
  const int tid = threadIdx.x;
  const int r = tid / kBlk, c = tid % kBlk;
  const int cur = p.cur[(size_t)(gy + r) * p.cur_w + gx + c];
  for (int k = 0; k < n; ++k) {
    const int mx = mx0 + dx[k], my = my0 + dy[k];
    const int f = (my & 3) * 4 + (mx & 3);
    const int py = gy + r + kPad + (my >> 2), px = gx + c + kPad + (mx >> 2);
    X266_ASSERT(py >= 0 && py < p.hp && px >= 0 && px < p.wp);
    const int v = __ldg(p.pyr + ((size_t)f * p.hp + py) * p.wp + px);
    const int d = cur - v;
    part[k][tid] = d < 0 ? -d : d;
  }
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int k = 0; k < n; ++k) part[k][tid] += part[k][tid + s];
    __syncthreads();
  }
  if (tid == 0) {
    int bk = 0;
    for (int k = 1; k < n; ++k)
      if (part[k][0] < part[bk][0]) bk = k;
    *best = bk;
  }
  __syncthreads();
  const int bk = *best;
  __syncthreads();                  // *best is rewritten by the next call
  return bk;
}

__global__ void __launch_bounds__(kThreads) refine_kernel(RefineParams p) {
  using Part = int[kMaxCands][kThreads];
  X266_SHARED(Part, part);
  X266_SHARED(int, best);
  // kernels/me.py candidate lists, in order
  const int ax[9] = {-2, 0, 2, -2, 0, 2, -2, 0, 2};
  const int ay[9] = {-2, -2, -2, 0, 0, 0, 2, 2, 2};
  const int bxd[9] = {-1, 0, 1, -1, 0, 1, -1, 0, 1};
  const int byd[9] = {-1, -1, -1, 0, 0, 0, 1, 1, 1};
  int qx[kMaxCands], qy[kMaxCands], sx[9], sy[9];
  for (int k = 0; k < kMaxCands; ++k) {
    qx[k] = k % 5 - 2;
    qy[k] = k / 5 - 2;
  }
  const int b = blockIdx.x;
  const int j = b % p.bx, i = b / p.bx;
  const int gx = j * kBlk, gy = i * kBlk;
  int basex = p.base[2 * (size_t)b], basey = p.base[2 * (size_t)b + 1];

  // stage 1a: stride-2 3x3 on the integer plane (full-pel * 4)
  for (int k = 0; k < 9; ++k) { sx[k] = 4 * ax[k]; sy[k] = 4 * ay[k]; }
  int k = best_candidate(p, part, &best, gx, gy, 4 * basex, 4 * basey, sx,
                         sy, 9);
  basex += ax[k];
  basey += ay[k];
  // stage 1b: stride-1 3x3 around the winner
  for (int m = 0; m < 9; ++m) { sx[m] = 4 * bxd[m]; sy[m] = 4 * byd[m]; }
  k = best_candidate(p, part, &best, gx, gy, 4 * basex, 4 * basey, sx, sy,
                     9);
  const int ibx = 4 * (basex + bxd[k]), iby = 4 * (basey + byd[k]);
  // stage 2: +-2 quarter-pel around it
  k = best_candidate(p, part, &best, gx, gy, ibx, iby, qx, qy, kMaxCands);
  if (threadIdx.x == 0) {
    p.out[2 * (size_t)b] = ibx + qx[k];
    p.out[2 * (size_t)b + 1] = iby + qy[k];
  }
}

}  // namespace

extern "C" {

// K4: launches on `stream`; returns the CUDA error of the launch.
int x266_warp_frames(int t, int by, int bx, int hp, int wp, const void* mvs,
                     const void* pyr, void* out, void* stream) {
  WarpParams p{by, bx, hp, wp, (const int32_t*)mvs, (const uint8_t*)pyr,
               (int32_t*)out};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchKernel(warp_kernel, dim3(t * by * bx),
                                     dim3(kThreads), args, 0,
                                     (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// K5: launches on `stream`; returns the CUDA error of the launch.
int x266_refine_search(int by, int bx, int hp, int wp, const void* cur,
                       const void* pyr, const void* base, void* out,
                       void* stream) {
  RefineParams p{by, bx, bx * kBlk, hp, wp, (const int32_t*)cur,
                 (const uint8_t*)pyr, (const int32_t*)base, (int32_t*)out};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchKernel(refine_kernel, dim3(by * bx),
                                     dim3(kThreads), args, 0,
                                     (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
