// Motion kernels K4 (MC warp) and K5 (ME refine).
//
// K4 replaces the Pallas TPU kernel x266_tpu/kernels/me_pallas.py:
// _build_warp (pl.pallas_call at :91).  For each of T motion fields and
// each 16x16 ME block it copies the quarter-pel MC prediction out of the
// 16-plane luma pyramid:
//   out[t, y, x] = pyr[(mvy&3)*4 + (mvx&3), y + REF_PAD + (mvy>>2),
//                                           x + REF_PAD + (mvx>>2)]
// with (mvx, mvy) = mvs[t, y/16, x/16], as int32 frames (T, 16*By, 16*Bx)
// that Pass A cuts into per-CU predictions.  Plain version:
// kernels/me_cuda.py warp_frames_ref (interp.mc_block per block).
// What bounds it on the H100: bytes.  It writes four bytes for each byte
// it reads (T*16By*16Bx int32 samples: 50 MB at T=6 and 1080p, 199 MB at
// 4K) and does no arithmetic, so the stores must be wide and the pyramid
// bytes read once from device memory.  Design: a thread makes four
// samples of four rows of one ME block (one MV): it reads each row's
// four pyramid bytes as two aligned 32-bit words, shifts them into place
// (__funnelshift_r), widens them (__byte_perm) and writes each row with
// one 16-byte store; the 32 lanes of a warp write 512 contiguous bytes
// of an output row (8 ME blocks), a 256-thread CTA 16 KB.  The T fields
// of a row group are neighbours in the grid: the fields (an ME grid and
// its left and above neighbours' MVs) read nearby pyramid bytes, which
// stay in L2 from one field to the next instead of being evicted by the
// output stream (on an H100 this took K4 at 4K from 0.122 to 0.092 ms,
// tools/profile_me.py).  Streaming stores (__stcs) measured within
// noise.
//
// K5 replaces _build_refine2 (pl.pallas_call at :285), the combined
// refinement of hierarchical ME: per ME block around a full-pel base MV,
// the 9 stride-2 full-pel SADs, then the 9 stride-1 SADs around that
// winner, then the 25 quarter-pel SADs around that; each step keeps the
// first minimum in candidate order (strict <, kernels/me.py:_REF_DELTAS_A,
// _REF_DELTAS_B, _QP_DELTAS).  Plain version: kernels/me.py
// refine_search_ref.  What bounds it: neither device-memory bytes (the
// pyramid bytes the candidates address, 40 MB at 1080p) nor operations
// (43 candidates x 256 absolute differences a block) but the gather of
// each block's windows, about 290 short rows from 16 planes, through L2
// (~14 KB of sectors a block), and the three dependent searches behind
// it.  Design: one warp per ME block, eight side by side per CTA, no
// CTA barrier.
//  - The block's reach is copied into the warp's shared memory with
//    cp.async before a search needs it: stage 1's window (plane 0, base
//    +-3 full-pel: 22 x 22 bytes) at the start, under the load of the
//    block's samples; stage 2's (the 16 planes' 17 x 17 bytes around the
//    stride-1 winner, which the 25 candidates read) once that winner is
//    known.  A lane reads rows as aligned words and shifts them into
//    place (__funnelshift_r).  Neighbouring blocks of a CTA share their
//    windows' edge sectors through L1.
//  - A lane holds 8 of the block's 256 samples (row lane/2, columns
//    8*(lane%2) .. +7) packed as two words, so a candidate costs it two
//    __vsadu4; __reduce_add_sync sums the candidate over the warp, and
//    one __reduce_min_sync over (sad << 6) | k (lane k holding candidate
//    k's) picks the winner: a SAD is at most 256 * 255 < 2^16 and
//    k < 25 < 64, so the least packed word is the first minimum in
//    candidate order, the plain version's rule.  Candidate deltas are
//    compile-time constants (unrolled loops); no stack.
// X266_ME_PHASES (never set by the package's build; tools/profile_me.py
// sets it) adds a clock64() split of K5's stages.
//
// Both launch through cudaLaunchKernel, so tests/test_torch_kernel_host.py
// can compile this file with g++ against tests/cuda_host/cuda_runtime.h.

#include <cstdint>
#include <cuda_runtime.h>

#include "x266_device.cuh"

namespace {

constexpr int kBlk = 16;            // ME block side
constexpr int kPad = 80;            // interp.REF_PAD

// ---- K4 ----

constexpr int kWarpRows = 4;        // output rows a thread makes
constexpr int kWarpCols = 32;       // 4-sample columns a CTA row spans
constexpr int kWarpGroups = 8;      // 4-row groups a CTA spans
constexpr int kWarpThreads = kWarpCols * kWarpGroups;

struct WarpParams {
  int t, by, bx;                    // fields, ME grid
  int hp, wp;                       // pyramid plane size (wp % 4 == 0)
  int ctas_x;                       // CTAs across a row of 4-sample columns
  const int32_t* mvs;               // (T, By, Bx, 2)
  const uint8_t* pyr;               // (16, Hp, Wp)
  int32_t* out;                     // (T, 16By, 16Bx)
};

__global__ void __launch_bounds__(kWarpThreads) warp_kernel(WarpParams p) {
  const int cx = blockIdx.x % p.ctas_x, cy = blockIdx.x / p.ctas_x;
  const int xq = cx * kWarpCols + threadIdx.x % kWarpCols;
  const int g = cy * kWarpGroups + threadIdx.x / kWarpCols;
  const int groups = kBlk / kWarpRows * p.by;         // 4-row groups a field
  if (xq >= 4 * p.bx || g >= p.t * groups) return;
  // the T fields of a row group side by side: they read nearby pyramid
  // bytes, which then stay in the caches from one field to the next
  const int t = g % p.t, y0 = g / p.t * kWarpRows;
  const int32_t* mv = p.mvs + 2 * (((size_t)t * p.by + y0 / kBlk) * p.bx +
                                   xq / 4);
  const int mvx = __ldg(mv), mvy = __ldg(mv + 1);
  const int f = (mvy & 3) * 4 + (mvx & 3);
  const int px = 4 * xq + kPad + (mvx >> 2);
  const int py0 = y0 + kPad + (mvy >> 2);
  const int s = 8 * (px & 3);
  const uint32_t* plane = reinterpret_cast<const uint32_t*>(
      p.pyr + (size_t)f * p.hp * p.wp);
  uint32_t v[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int py = py0 + r;
    const bool ok = py >= 0 && py < p.hp && px >= 0 && px + 3 < p.wp;
    X266_ASSERT(ok);
    const uint32_t* q = plane + ((size_t)py * p.wp + px - (px & 3)) / 4;
    const uint32_t lo = ok ? __ldg(q) : 0u;
    const uint32_t hi = ok ? __ldg(q + (s != 0)) : 0u;
    v[r] = __funnelshift_r(lo, hi, s);
  }
  const int w16 = p.bx * kBlk;
  int32_t* o = p.out + ((size_t)t * p.by * kBlk + y0) * w16 + 4 * xq;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int4 x = {(int)__byte_perm(v[r], 0, 0x4440),
                    (int)__byte_perm(v[r], 0, 0x4441),
                    (int)__byte_perm(v[r], 0, 0x4442),
                    (int)__byte_perm(v[r], 0, 0x4443)};
    *reinterpret_cast<int4*>(o + (size_t)r * w16) = x;
  }
}

// ---- K5 ----

constexpr int kRefineWarps = 8;     // ME blocks (a warp each) per CTA
constexpr int kWin1 = 22;           // stage 1: base -3 .. +18, rows and bytes
constexpr int kWin1Words = 7;       // words a stage-1 row spans (align <= 3)
constexpr int kWin2 = 17;           // stage 2: winner -1 .. +15, per plane
constexpr int kWin2Words = 5;
constexpr int kWin1Size = kWin1 * kWin1Words;
constexpr int kWin2Size = 16 * kWin2 * kWin2Words;
// + a word that a read of a window's last row may touch and not use
constexpr int kWinSize = kWin1Size + kWin2Size + 1;

struct RefineParams {
  int by, bx;                       // ME grid
  int cur_w;                        // cur row pitch (16 * Bx)
  int hp, wp;                       // pyramid plane size (wp % 4 == 0)
  const int32_t* cur;               // (16By, 16Bx), 8-bit samples
  const uint8_t* pyr;               // (16, Hp, Wp)
  const int32_t* base;              // (By, Bx, 2) full-pel
  int32_t* out;                     // (By, Bx, 2) quarter-pel
};

#ifdef X266_ME_PHASES
// K5's cycles by stage, per ME block (lane 0 of its warp), for
// tools/profile_me.py --split; blocks past kPhaseBlocks are not kept.
constexpr int kPhases = 6;
constexpr int kPhaseBlocks = 1 << 16;
__device__ unsigned long long me_phase_cycles[kPhaseBlocks][kPhases];
// Waits for dep (so the stage's work has landed), then adds the cycles
// since the last stamp to the stage's slot.
#define ME_STAMP(slot, dep)                                            \
  do {                                                                 \
    uint32_t d_ = (dep);                                               \
    asm volatile("mov.b32 %0, %0;" : "+r"(d_));                        \
    const long long now_ = clock64();                                  \
    phase[slot] += now_ - stamp;                                       \
    stamp = now_;                                                      \
  } while (0)
#else
#define ME_STAMP(slot, dep) ((void)0)
#endif

// Copies a window of `planes` planes x `rows` rows x `words` 32-bit words
// of the pyramid, from row y0 and word x0 of each plane, into dst (that
// order, packed), with cp.async; the lanes share the words.  Words
// outside the pyramid are not copied: no candidate that stays inside it
// reads them.
template <int planes, int rows, int words>
__device__ __forceinline__ void load_window(const RefineParams& p,
                                            uint32_t* dst, int y0, int x0,
                                            int lane) {
  const int wpw = p.wp / 4;
  for (int e = lane; e < planes * rows * words; e += 32) {
    const int f = e / (rows * words), j = e / words % rows, w = e % words;
    const int y = y0 + j, x = x0 + w;
    if (y >= 0 && y < p.hp && x >= 0 && x < wpw)
      x266_cp_async4(dst + e, reinterpret_cast<const uint32_t*>(
                                  p.pyr + ((size_t)f * p.hp + y) * p.wp) + x);
  }
}

// This lane's SAD over its 8 samples (c0, c1) against bytes [o, o + 8)
// of the window row starting at `row`.
__device__ __forceinline__ uint32_t sad8(const uint32_t* row, int o,
                                         uint32_t c0, uint32_t c1) {
  const uint32_t* q = row + (o >> 2);
  const int s = 8 * (o & 3);
  const uint32_t a = q[0], b = q[1], c = q[2];
  return __vsadu4(c0, __funnelshift_r(a, b, s)) +
         __vsadu4(c1, __funnelshift_r(b, c, s));
}

// The first minimum of the warp's SADs (part: this lane's share of each
// of the n candidates), in candidate order.
template <int n>
__device__ __forceinline__ int first_min(const uint32_t (&part)[n],
                                         int lane) {
  uint32_t mine = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const uint32_t sad = __reduce_add_sync(0xffffffffu, part[k]);
    if (lane == k) mine = sad << 6 | k;
  }
  return (int)(__reduce_min_sync(0xffffffffu, mine) & 63);
}

// The range check of one lane's read (8 samples) at quarter-pel MV
// (mx, my): the plain version asserts every read inside the pyramid.
__device__ __forceinline__ bool read_inside(const RefineParams& p, int x,
                                            int y, int mx, int my) {
  const int py = y + kPad + (my >> 2), px = x + kPad + (mx >> 2);
  return py >= 0 && py < p.hp && px >= 0 && px + 7 < p.wp;
}

__device__ __forceinline__ uint32_t pack4(int4 v) {
  return (uint32_t)v.x | (uint32_t)v.y << 8 | (uint32_t)v.z << 16 |
         (uint32_t)v.w << 24;
}

__global__ void __launch_bounds__(32 * kRefineWarps)
    refine_kernel(RefineParams p) {
  using Windows = uint32_t[kRefineWarps][kWinSize];
  X266_SHARED(Windows, win);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // a CTA's ME blocks: kRefineWarps side by side in a row of the grid
  const int ctas_x = (p.bx + kRefineWarps - 1) / kRefineWarps;
  const int bi = blockIdx.x / ctas_x;
  const int bj = blockIdx.x % ctas_x * kRefineWarps + warp;
  if (bj >= p.bx) return;                       // the whole warp
  const int b = bi * p.bx + bj;
#ifdef X266_ME_PHASES
  long long stamp = clock64(), phase[kPhases] = {};
#endif
  uint32_t* w1 = win[warp];
  uint32_t* w2 = w1 + kWin1Size;
  const int gx = bj * kBlk, gy = bi * kBlk;
  const int basex = __ldg(p.base + 2 * b), basey = __ldg(p.base + 2 * b + 1);

  // stage 1's window, under the load of this lane's samples: row
  // lane/2, columns 8*(lane%2) .. +7
  const int x1 = gx + kPad + basex - 3, y1 = gy + kPad + basey - 3;
  load_window<1, kWin1, kWin1Words>(p, w1, y1, x1 >> 2, lane);
  const int r = lane >> 1, h = lane & 1, x = gx + 8 * h, y = gy + r;
  const int4* cp = reinterpret_cast<const int4*>(p.cur + (size_t)y * p.cur_w
                                                 + x);
  const int4 ca = __ldg(cp), cb = __ldg(cp + 1);
  X266_ASSERT(((ca.x | ca.y | ca.z | ca.w | cb.x | cb.y | cb.z | cb.w) &
               ~255) == 0);
  const uint32_t c0 = pack4(ca), c1 = pack4(cb);
  x266_cp_async_wait_all();
  __syncwarp();
  ME_STAMP(0, w1[lane]);

  // stage 1a: stride-2 3x3 on the integer plane; stage 1b: stride-1 3x3
  // around its winner.  Full-pel (dx, dy) from base is byte 3 + dx + 8h
  // (after the alignment sh1) of row r + 3 + dy.
  const uint32_t* row1 = w1 + (r + 3) * kWin1Words;
  const int o1 = (x1 & 3) + 3 + 8 * h;
  uint32_t part[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int dx = 2 * (k % 3) - 2, dy = 2 * (k / 3) - 2;
    X266_ASSERT(read_inside(p, x, y, 4 * (basex + dx), 4 * (basey + dy)));
    part[k] = sad8(row1 + dy * kWin1Words, o1 + dx, c0, c1);
  }
  ME_STAMP(1, part[8]);
  const int ka = first_min(part, lane);
  ME_STAMP(2, ka);
  const int ax = 2 * (ka % 3) - 2, ay = 2 * (ka / 3) - 2;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int dx = ax + k % 3 - 1, dy = ay + k / 3 - 1;
    X266_ASSERT(read_inside(p, x, y, 4 * (basex + dx), 4 * (basey + dy)));
    part[k] = sad8(row1 + dy * kWin1Words, o1 + dx, c0, c1);
  }
  ME_STAMP(1, part[8]);
  const int kb = first_min(part, lane);
  ME_STAMP(2, kb);
  const int wx = basex + ax + kb % 3 - 1, wy = basey + ay + kb / 3 - 1;

  // stage 2: +-2 quarter-pel around the full-pel winner (wx, wy); the
  // window holds each plane's rows and bytes wx-1 .. wx+15 (wy likewise)
  const int x2 = gx + kPad + wx - 1, y2 = gy + kPad + wy - 1;
  load_window<16, kWin2, kWin2Words>(p, w2, y2, x2 >> 2, lane);
  x266_cp_async_wait_all();
  __syncwarp();
  ME_STAMP(3, w2[lane]);
  const uint32_t* row2 = w2 + r * kWin2Words;
  const int o2 = (x2 & 3) + 8 * h;
  uint32_t part2[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const int dx = k % 5 - 2, dy = k / 5 - 2;   // quarter-pel
    const int f = (dy & 3) * 4 + (dx & 3);
    X266_ASSERT(read_inside(p, x, y, 4 * wx + dx, 4 * wy + dy));
    part2[k] = sad8(row2 + (f * kWin2 + (dy >> 2) + 1) * kWin2Words,
                    o2 + (dx >> 2) + 1, c0, c1);
  }
  ME_STAMP(4, part2[24]);
  const int kq = first_min(part2, lane);
  if (lane == 0) {
    p.out[2 * (size_t)b] = 4 * wx + kq % 5 - 2;
    p.out[2 * (size_t)b + 1] = 4 * wy + kq / 5 - 2;
  }
  ME_STAMP(5, kq);
#ifdef X266_ME_PHASES
  if (lane == 0 && b < kPhaseBlocks)
    for (int k = 0; k < kPhases; ++k) me_phase_cycles[b][k] = phase[k];
#endif
}

// The pyramid is read as aligned 32-bit words.
bool words_aligned(int wp, const void* pyr) {
  return wp % 4 == 0 && (uintptr_t)pyr % 4 == 0;
}

}  // namespace

extern "C" {

// K4: launches on `stream`; returns the CUDA error of the launch
// (cudaErrorInvalidValue for a pyramid whose rows are not word-aligned
// or output rows that are not 16-byte aligned).
int x266_warp_frames(int t, int by, int bx, int hp, int wp, const void* mvs,
                     const void* pyr, void* out, void* stream) {
  if (!words_aligned(wp, pyr) || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int ctas_x = (4 * bx + kWarpCols - 1) / kWarpCols;
  const int ctas_y = (t * by * (kBlk / kWarpRows) + kWarpGroups - 1) /
                     kWarpGroups;
  WarpParams p{t, by, bx, hp, wp, ctas_x, (const int32_t*)mvs,
               (const uint8_t*)pyr, (int32_t*)out};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchKernel(warp_kernel, dim3(ctas_x * ctas_y),
                                     dim3(kWarpThreads), args, 0,
                                     (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// K5: launches on `stream`; returns the CUDA error of the launch
// (cudaErrorInvalidValue for a pyramid whose rows are not word-aligned
// or a cur that is not 16-byte aligned).
int x266_refine_search(int by, int bx, int hp, int wp, const void* cur,
                       const void* pyr, const void* base, void* out,
                       void* stream) {
  if (!words_aligned(wp, pyr) || (uintptr_t)cur % 16 != 0)
    return (int)cudaErrorInvalidValue;
  RefineParams p{by, bx, bx * kBlk, hp, wp, (const int32_t*)cur,
                 (const uint8_t*)pyr, (const int32_t*)base, (int32_t*)out};
  void* args[] = {&p};
  const int ctas = (bx + kRefineWarps - 1) / kRefineWarps * by;
  cudaError_t err = cudaLaunchKernel(refine_kernel, dim3(ctas),
                                     dim3(32 * kRefineWarps), args, 0,
                                     (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef X266_ME_PHASES
// K5's stage cycles summed over the last launch's first n ME blocks
// (kPhases uint64) into host memory.
int x266_me_phases(void* host, int n) {
  static unsigned long long all[kPhaseBlocks][kPhases];
  if (n > kPhaseBlocks) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyFromSymbol(all, me_phase_cycles,
                                         sizeof(all[0]) * n);
  unsigned long long* out = (unsigned long long*)host;
  for (int k = 0; k < kPhases; ++k) {
    out[k] = 0;
    for (int b = 0; b < n; ++b) out[k] += all[b][k];
  }
  return (int)err;
}
#endif

}  // extern "C"
