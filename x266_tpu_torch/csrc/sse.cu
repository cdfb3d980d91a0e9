// The picture SSE in the reference's float32 order: kernel SSE.
//
// Port-only (ROADMAP queue 3, F4): no Pallas kernel computes it.  The
// reference sums each plane's squared error in float32 inside its jitted
// step (x266_tpu/engine/fused.py:483-486), and XLA CPU rewrites that
// reduction into a tree: 32x32 windows, each added in raster order from
// 0, over the plane padded evenly with zeros to whole windows, level after
// level until both dimensions are at most 32; the last (a x b) reduction
// is fused into the loop that stacks the three planes' sums, where LLVM
// vectorizes it across rows when there are 2 or 4 (each lane adds its row
// in order, the lanes fold in halves) and adds in raster order otherwise.
// The plain version is kernels/cost.py (plane_sse_f32_plain); the two
// agree bit for bit.
//
// What bounds it on the H100: the bytes, two planes read once (~4 MB for
// the three planes of a 1080p frame).  The window sums are sequential
// chains of 1024 float adds; one thread owns a window, so a 1080p luma
// plane runs 2,040 chains side by side and the chain length, not the
// memory, sets the time.  The torch version of the same order needs one
// launch per element of a window (~2,000 per plane); this is one launch
// per tree level.  Adds are __fadd_rn and the library is built with
// -fmad=false, so nothing is contracted or reordered.

#include <cstdint>
#include <cuda_runtime.h>

#include "x266_device.cuh"

namespace {

constexpr int kWin = 32;          // XLA CPU's tree window
constexpr int kThreads = 128;

// One tree level over an (h, w) plane: windows of wh x ww, the plane
// padded by (ph, pw) before its first row and column, nh x nw windows.
struct Level {
  int h, w, wh, ww, ph, pw, nh, nw;
};

void dim_geom(int d, int* win, int* pad, int* cnt) {
  if (d <= kWin) {
    *win = d; *pad = 0; *cnt = 1;
    return;
  }
  const int m = (d + kWin - 1) / kWin;
  *win = kWin; *pad = (m * kWin - d) / 2; *cnt = m;
}

Level make_level(int h, int w) {
  Level l{h, w, 0, 0, 0, 0, 0, 0};
  dim_geom(h, &l.wh, &l.ph, &l.nh);
  dim_geom(w, &l.ww, &l.pw, &l.nw);
  return l;
}

// A launch's arguments: n frames of the level's input (two uint8 planes
// a and b, or one float plane a), its geometry, its output.
struct SseParams {
  const void* a;
  const void* b;
  Level l;                        // a window level (sse_windows)
  int rows, cols;                 // the last reduction (sse_final)
  int n;
  float* out;
};

// Sample k of the input: the squared difference of two uint8 planes, or a
// float plane's value.
template <bool kU8>
__device__ __forceinline__ float sample(const SseParams& p, size_t k) {
  if (kU8) {
    const int d = (int)((const uint8_t*)p.a)[k] - (int)((const uint8_t*)p.b)[k];
    return (float)(d * d);
  }
  return ((const float*)p.a)[k];
}

// One thread per window of one level: its samples in raster order from 0
// (padding adds nothing and is skipped).
template <bool kU8>
__global__ void __launch_bounds__(kThreads) sse_windows(SseParams p) {
  const Level& l = p.l;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int per = l.nh * l.nw;
  if (t >= p.n * per) return;
  const int f = t / per, i = (t % per) / l.nw, j = t % l.nw;
  const size_t base = (size_t)f * l.h * l.w;
  float acc = 0.0f;
  for (int y = 0; y < l.wh; ++y) {
    const int py = i * l.wh + y - l.ph;
    if (py < 0 || py >= l.h) continue;
    for (int x = 0; x < l.ww; ++x) {
      const int px = j * l.ww + x - l.pw;
      if (px < 0 || px >= l.w) continue;
      acc = __fadd_rn(acc, sample<kU8>(p, base + (size_t)py * l.w + px));
    }
  }
  p.out[t] = acc;
}

// One thread per frame: the last (rows x cols) reduction, both at most 32.
template <bool kU8>
__global__ void __launch_bounds__(kThreads) sse_final(SseParams p) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= p.n) return;
  const int rows = p.rows, cols = p.cols;
  const size_t base = (size_t)f * rows * cols;
  float acc = 0.0f;
  if (rows == 2 || rows == 4) {
    float lane[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < cols; ++c)
      for (int r = 0; r < rows; ++r)
        lane[r] = __fadd_rn(lane[r], sample<kU8>(p, base + (size_t)r * cols + c));
    if (rows == 4) {
      lane[0] = __fadd_rn(lane[0], lane[2]);
      lane[1] = __fadd_rn(lane[1], lane[3]);
    }
    acc = __fadd_rn(lane[0], lane[1]);
  } else {
    for (int k = 0; k < rows * cols; ++k)
      acc = __fadd_rn(acc, sample<kU8>(p, base + k));
  }
  p.out[f] = acc;
}

cudaError_t launch(void (*kernel)(SseParams), SseParams& p, int threads,
                   cudaStream_t st) {
  void* args[] = {&p};
  return cudaLaunchKernel(kernel, dim3((threads + kThreads - 1) / kThreads),
                          dim3(kThreads), args, 0, st);
}

}  // namespace

extern "C" {

// The float32 SSE of n frames of two (h, w) uint8 planes a and b, in XLA
// CPU's order, into out (n float), on `stream`: one launch per tree level
// and one for the last reduction.  s0 and s1 are scratch of n x
// ceil(h/32) x ceil(w/32) floats each.  Returns cudaGetLastError().
int x266_plane_sse(int n, int h, int w, const void* a, const void* b,
                   void* s0, void* s1, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  SseParams p{a, b, make_level(h, w), h, w, n, (float*)out};
  if (h <= kWin && w <= kWin) {
    const cudaError_t err = launch(sse_final<true>, p, n, st);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  float* cur = (float*)s0;
  float* next = (float*)s1;
  p.out = cur;
  cudaError_t err = launch(sse_windows<true>, p, n * p.l.nh * p.l.nw, st);
  int rows = p.l.nh, cols = p.l.nw;
  while (err == cudaSuccess && (rows > kWin || cols > kWin)) {
    SseParams q{cur, nullptr, make_level(rows, cols), 0, 0, n, next};
    err = launch(sse_windows<false>, q, n * q.l.nh * q.l.nw, st);
    rows = q.l.nh;
    cols = q.l.nw;
    float* t = cur;
    cur = next;
    next = t;
  }
  if (err == cudaSuccess) {
    SseParams q{cur, nullptr, Level{}, rows, cols, n, (float*)out};
    err = launch(sse_final<false>, q, n, st);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
