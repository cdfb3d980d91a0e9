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
// agree bit for bit.  Padding adds +0.0 to a sum that is never negative,
// so it may be added or skipped alike.
//
// One launch per call (x266_picture_sse) covers the three planes of F
// frames, every tree level, the last reduction and the exact int64 SSE
// (fused.frame_sse's result).  What bounds it on the H100: the bytes, two
// uint8 planes read once (24.9 MB for a 3840x2160 picture or four 1080p
// frames: 7.4 us at 3.35 TB/s); and the chains: each window is up to
// 1,024 dependent float adds that no order but the reference's may
// split, and the window above it cannot start before the last of its
// 1,024 windows is done.  The design:
//
// - Level 1: a tile is one warp, a lane per window, the warp 32 adjacent
//   windows of one window row.  Each of the window row's sample rows is,
//   for those 32 windows, one contiguous run of up to 1,024 bytes of each
//   plane, which a producer warp beside the tile copies with two bulk
//   copies (cp.async.bulk, the copy engine), 4 rows to a group and a full
//   mbarrier, into a ring of 4 group slots in shared memory, as the tile
//   empties them (an empty mbarrier a slot): 12 rows ahead of the adds.
//   A lane reads its window's 32 bytes of each row.  A CTA is 4 tiles and
//   their 4 producers; its 129 KB of shared memory keeps it alone on its
//   SM, so each tile has a scheduler of its own.  Where the plane's width
//   is not a multiple of 32 (cfg5's 112x80, lossless_ra's 208x120 chroma)
//   or a plane is not 16-byte aligned, a lane reads its bytes one by one
//   with the bounds checked instead, and the producer has nothing to do.
//   Measured on an H100 (tools/profile_me.py --sse-split): issuing a bulk
//   copy holds its warp ~70 cycles, a quarter of a tile's level 1 when
//   the tile issued its own copies; with the producers the last tile
//   ends its level 1 at ~7.7 us, 3.2 TB/s of the 24.9 MB.  Each lane's
//   own 16-byte cp.async in place of the bulk copies made level 1 ~40 %
//   longer.
// - A square is formed exactly: |a - b| of four bytes at once
//   (__vabsdiffu4), each byte placed under the exponent of 2^23 and 2^23
//   taken off (exact); its square (at most 65,025) is exact in float, so
//   a fused multiply-add onto the sum rounds once, as the plain version's
//   add of its float32 square does.  __dp4a adds the four squares into
//   the lane's integer sum (at most 1,024 x 65,025 < 2^31).
// - The exact SSE: the warp adds its lanes' integer sums (< 2^32) and
//   adds that to the (frame, plane)'s int64 with one atomicAdd.
// - The upper levels: a window sum goes to the scratch where the next
//   level reads it, blocked by the next level's windows (each block
//   row-major, rows padded to 4 floats, at most 4 KB); the padding is
//   never written and stays 0 from the wrapper's first zeroing.  Each
//   block has a ticket: a tile that has written its sums takes one, with
//   an acquire-release atomic add (no fence), for each block its windows
//   fall in (one or two), and the tile that takes a block's last ticket
//   copies the block into shared memory in one bulk copy and adds it on
//   a lane of its own (two blocks side by side): the level-2 window's sum,
//   or, where the level-1 sums are at most 32 x 32 and so one block, the
//   last reduction itself.  So a level-2 window is added while other
//   tiles still read the plane, and only the last one waits for the end
//   of level 1.  A level-2 sum takes the plane's ticket, and the tile
//   that takes its last adds the level-2 sums in the last reduction.  The
//   tile that writes a plane's outputs resets the plane's tickets and
//   int64 to 0 for the next call, so no memset launch is needed.  Two
//   window levels cover planes of up to 32,768 a side.
//
// Adds are __fadd_rn and the library is built with -fmad=false, so
// nothing is contracted or reordered.  X266_SSE_PHASES (never set by the
// package's build; tools/profile_me.py --sse-split sets it) adds a
// clock64() split of each tile's level-1 loop (its waits on copies and
// its slot releases), the blocks it adds, and a globaltimer timeline.  It
// launches through cudaLaunchKernel, so tests/test_torch_kernel_host.py
// compiles this file with g++ against tests/cuda_host/cuda_runtime.h.

#include <cstdint>
#include <cuda_runtime.h>

#include "x266_device.cuh"

namespace {

constexpr int kWin = 32;          // XLA CPU's tree window
constexpr int kMaxPlanes = 3;
constexpr int kCtaWarps = 4;      // independent tiles a CTA
constexpr int kGroup = 4;         // level-1 rows a copy group
constexpr int kRing = 4;          // group slots a tile (3 groups ahead)
constexpr int kRowVecs = 128;     // a row: 1,024 bytes of rec, of orig
constexpr int kRingVecs = kRing * kGroup * kRowVecs;
// a slot's full and empty mbarriers, a block's
constexpr int kBars = 2 * kRing + 1;
constexpr int kWarpVecs = kRingVecs + (kBars * 8 + 15) / 16;
constexpr int kMaxSide = kWin * kWin * kWin;

// One dimension of a window level: window length, leading padding, count.
struct Dim {
  int win, pad, cnt;
};

Dim dim_geom(int d) {
  if (d <= kWin) return {d, 0, 1};
  const int m = (d + kWin - 1) / kWin;
  return {kWin, (m * kWin - d) / 2, m};
}

struct Plane {
  const uint8_t* rec;     // frame 0; frames h * w bytes apart
  const uint8_t* orig;
  int h, w;
  int small;              // h, w <= 32: the last reduction over samples
  int vec;                // bulk copies (w % 32 == 0, aligned planes)
  Dim y1, x1;             // level 1: windows over the plane
  int chunks;             // tiles a window row: ceil(x1.cnt / 32)
  int tiles;              // tiles a frame
  int level2;             // the level-1 sums take another window level
  Dim y2, x2;             // the blocks over the level-1 sums
  int pitch;              // floats a block row: x2.win rounded up to 4
  int blocks;             // y2.cnt * x2.cnt
  long long off;          // the plane's scratch (floats, frame 0)
  long long l2;           // its level-2 sums, after the blocks
};

struct SseParams {
  Plane pl[kMaxPlanes];
  int planes, frames, tiles;      // tiles: a frame's
  float* scratch;                 // frames scratch_frame floats apart
  long long scratch_frame;
  // (frame, plane) rows of tstride: the plane's ticket, its int SSE so
  // far, and a ticket a block
  unsigned long long* tickets;
  int tstride;
  float* out_f32;                 // (frame, plane)
  long long* out_i64;
};

#ifdef X266_SSE_PHASES
// Per tile (lane 0 of its warp): level-1 cycles, of them waiting on
// copies and releasing slots, the cycles of the blocks it added (0 unless it
// took a block's last ticket), globaltimer ns at its start, at the end of
// level 1 and at its end, its SM | %warpid << 16, and of its blocks'
// cycles those waiting on their copies, adding a level-2 window, and
// taking the plane's ticket; tiles past kPhaseTiles are not kept.
constexpr int kPhases = 11;
constexpr int kPhaseTiles = 1 << 16;
__device__ unsigned long long sse_phase[kPhaseTiles][kPhases];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned sm_warp() {
  unsigned s, w;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(w));
  return s | w << 16;
}
#define X266_SSE_STAMP(...) __VA_ARGS__
#else
#define X266_SSE_STAMP(...)
#endif

// The squares of four byte differences d (|a - b| per byte) added in
// order to acc, and into isum.
__device__ __forceinline__ void add_word(uint32_t a, uint32_t b, float& acc,
                                         unsigned& isum) {
  const uint32_t d = __vabsdiffu4(a, b);
  isum = __dp4a(d, d, isum);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // 0x4B0000dd is 2^23 + d; taking 2^23 off is exact, and so is v * v,
    // so the fused multiply-add rounds acc + v * v once, as the plain
    // version's add of the float32 square does
    const float v = __fsub_rn(
        __int_as_float((int)__byte_perm(d, 0x4B000000u, 0x7440u + k)),
        8388608.0f);
    acc = __fmaf_rn(v, v, acc);
  }
}

__device__ __forceinline__ void add_chunk(const uint4& a, const uint4& b,
                                          float& acc, unsigned& isum) {
  add_word(a.x, b.x, acc, isum);
  add_word(a.y, b.y, acc, isum);
  add_word(a.z, b.z, acc, isum);
  add_word(a.w, b.w, acc, isum);
}

// The position of level-1 window (i, j)'s sum in its plane's scratch.
__device__ __forceinline__ int block_index(const Plane& P, int i, int j) {
  const int yy = i + P.y2.pad, xx = j + P.x2.pad;
  const int t = (yy / P.y2.win) * P.x2.cnt + xx / P.x2.win;
  return (t * P.y2.win + yy % P.y2.win) * P.pitch + xx % P.x2.win;
}

// The range [lo, hi) of the n elements below that window b of dimension
// d covers (rows of samples, or of level-1 sums).
__device__ __forceinline__ void block_span(const Dim& d, int n, int b,
                                           int& lo, int& hi) {
  const int top = b * d.win - d.pad;
  lo = top < 0 ? 0 : top;
  hi = top + d.win < n ? top + d.win : n;
}

// The tiles whose windows fall in block (bi, bj).
__device__ __forceinline__ int block_tiles(const Plane& P, int bi, int bj) {
  int r0, r1, c0, c1;
  block_span(P.y2, P.y1.cnt, bi, r0, r1);
  block_span(P.x2, P.x1.cnt, bj, c0, c1);
  return (r1 - r0) * ((c1 - 1) / 32 - c0 / 32 + 1);
}

// The row lanes of the last reduction (2 or 4 rows) folded in halves.
__device__ __forceinline__ float fold(const float* lane, int rows) {
  if (rows == 4)
    return __fadd_rn(__fadd_rn(lane[0], lane[2]), __fadd_rn(lane[1], lane[3]));
  return __fadd_rn(lane[0], lane[1]);
}

// Keeps acc as rows[r] (r < 4) without indexing the array at run time.
__device__ __forceinline__ void keep_row(float* rows, int r, float acc) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k == r) rows[k] = acc;
}

// Rows r0..r1 of a row-major grid in shared memory (pitch floats a row,
// a multiple of 4; columns past the grid's hold 0) added to acc in
// raster order.
__device__ __forceinline__ float add_rows(const float* g, int pitch, int r0,
                                          int r1, float acc) {
  for (int r = r0; r < r1; ++r) {
    const float4* row = reinterpret_cast<const float4*>(g + r * pitch);
    float4 v[kWin / 4];                // the row's loads before its adds
#pragma unroll
    for (int c = 0; c < kWin / 4; ++c)
      if (c < pitch / 4) v[c] = row[c];
#pragma unroll
    for (int c = 0; c < kWin / 4; ++c)
      if (c < pitch / 4)
        acc = __fadd_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(acc, v[c].x), v[c].y), v[c].z),
            v[c].w);
  }
  return acc;
}

// The last reduction of a row-major grid of `rows` rows (pitch floats
// each, past its columns 0), at most 32 x 32, in shared memory: each row
// in order from 0, folded in halves, for 2 or 4 rows; raster otherwise.
__device__ __forceinline__ float final_grid(const float* g, int rows,
                                            int pitch) {
  if (rows != 2 && rows != 4) return add_rows(g, pitch, 0, rows, 0.0f);
  float lane[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int r = 0; r < rows; ++r)
    keep_row(lane, r, add_rows(g, pitch, r, r + 1, 0.0f));
  return fold(lane, rows);
}

// Level 1 for lane's window j of window row i: its float sum in raster
// order from 0 and its integer sum.  ring: kRing slots of kGroup rows of
// 1,024 bytes of rec then 1,024 of orig (a lane's window at 32 x lane),
// bars their mbarriers.
__device__ __forceinline__ void window_row(
    const Plane& P, const uint8_t* rec, const uint8_t* orig, int i, int j,
    uint4* ring, uint64_t* bars, float& acc, unsigned& isum
    X266_SSE_STAMP(, long long& wait, long long& iss)) {
  const int lane = threadIdx.x % 32;
  int y0, y1;
  block_span(P.y1, P.h, i, y0, y1);
  const int n = y1 - y0;                   // the same for the whole warp
  const bool active = j < P.x1.cnt;
  acc = 0.0f;
  isum = 0;
  if (P.vec) {
    for (int G = 0; G * kGroup < n; ++G) {
      X266_SSE_STAMP(const long long t0 = clock64());
      x266_mbar_wait(bars + G % kRing, (G / kRing) & 1);
      X266_SSE_STAMP(const long long t1 = clock64(); wait += t1 - t0);
      const uint4* s = ring + (G % kRing) * kGroup * kRowVecs + 2 * lane;
      const int rows = n - G * kGroup < kGroup ? n - G * kGroup : kGroup;
      for (int r = 0; r < rows; ++r, s += kRowVecs) {
        const uint4 a0 = s[0], a1 = s[1], b0 = s[kRowVecs / 2],
                    b1 = s[kRowVecs / 2 + 1];
        if (active) {
          add_chunk(a0, b0, acc, isum);
          add_chunk(a1, b1, acc, isum);
        }
      }
      X266_SSE_STAMP(const long long t2 = clock64());
      __syncwarp();                  // every lane has read the slot
      if (lane == 0) x266_mbar_arrive(bars + kRing + G % kRing);
      X266_SSE_STAMP(iss += clock64() - t2);
    }
    return;
  }
  if (!active) return;
  for (int y = y0; y < y1; ++y) {
    const uint8_t* ra = rec + (size_t)y * P.w;
    const uint8_t* rb = orig + (size_t)y * P.w;
    for (int q = 0; q < 8; ++q) {
      uint32_t va = 0, vb = 0;
      for (int t = 0; t < 4; ++t) {
        const int x = 4 * q + t, px = j * P.x1.win + x - P.x1.pad;
        if (x < P.x1.win && px >= 0 && px < P.w) {
          X266_ASSERT((size_t)y * P.w + px < (size_t)P.h * P.w);
          va |= (uint32_t)ra[px] << (8 * t);
          vb |= (uint32_t)rb[px] << (8 * t);
        }
      }
      add_word(va, vb, acc, isum);
    }
  }
}

// The producer warp's lane 0 of a tile (window row i, windows from j0):
// each group of kGroup rows of rec and orig into its slot with bulk
// copies, once the tile has emptied the slot's previous group.
__device__ __forceinline__ void produce(const Plane& P, const uint8_t* rec,
                                        const uint8_t* orig, int i, int j0,
                                        uint4* ring, uint64_t* bars) {
  int y0, y1;
  block_span(P.y1, P.h, i, y0, y1);
  const int n = y1 - y0;
  const int bytes = (P.x1.cnt - j0 < 32 ? P.x1.cnt - j0 : 32) * kWin;
  const uint8_t* a = rec + (size_t)y0 * P.w + j0 * kWin;
  const uint8_t* b = orig + (size_t)y0 * P.w + j0 * kWin;
  for (int G = 0; G * kGroup < n; ++G) {
    const int k0 = G * kGroup, rows = n - k0 < kGroup ? n - k0 : kGroup;
    if (G >= kRing)
      x266_mbar_wait(bars + kRing + G % kRing, (G / kRing - 1) & 1);
    uint4* s = ring + (G % kRing) * kGroup * kRowVecs;
    uint64_t* bar = bars + G % kRing;
    x266_mbar_expect_tx(bar, 2 * bytes * rows);
    for (int r = 0; r < rows; ++r) {
      const size_t o = (size_t)(k0 + r) * P.w;
      x266_bulk_copy(s + r * kRowVecs, a + o, bytes, bar);
      x266_bulk_copy(s + r * kRowVecs + kRowVecs / 2, b + o, bytes, bar);
    }
  }
}

// A plane of at most 32 x 32 (no window level): the last reduction over
// its squares, and its integer sum, on one thread.
__device__ __forceinline__ void small_plane(const Plane& P,
                                            const uint8_t* rec,
                                            const uint8_t* orig, float* out_f,
                                            long long* out_i) {
  float lane[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc = 0.0f;
  unsigned isum = 0;
  const bool lanes = P.h == 2 || P.h == 4;
  for (int y = 0; y < P.h; ++y) {
    if (lanes) acc = 0.0f;
    for (int x = 0; x < P.w; ++x) {
      const int d = (int)rec[y * P.w + x] - (int)orig[y * P.w + x];
      isum += (unsigned)(d * d);
      acc = __fadd_rn(acc, (float)(d * d));
    }
    if (lanes) keep_row(lane, y, acc);
  }
  *out_f = lanes ? fold(lane, P.h) : acc;
  *out_i = (long long)isum;
}

// The plane's outputs, its last reduction s and its exact SSE, and its
// tickets and int64 reset for the next call.
__device__ __forceinline__ void plane_done(unsigned long long* tk, float s,
                                           long long exact, float* out_f,
                                           long long* out_i) {
  *out_f = s;
  *out_i = exact;
  tk[0] = 0;
  tk[1] = 0;
}

// The warp that took the last tickets of blocks b0 + k of block row bi
// (k < 2, bit k of last): the blocks into shared memory (ring) in one bulk
// copy each, then without level 2 the last reduction on lane 0, or each
// block's level-2 window's sum on lane k; a level-2 sum takes the plane's
// ticket, and with its last the warp adds the level-2 sums in the last
// reduction.
__device__ __forceinline__ void blocks_done(const Plane& P, float* scr,
                                            unsigned long long* tk, int bi,
                                            int b0, int last, uint4* ring,
                                            uint64_t* bar, float* out_f,
                                            long long* out_i
                                            X266_SSE_STAMP(, long long* bst)) {
  const int lane = threadIdx.x % 32;
  const int blk = P.y2.win * P.pitch;             // floats a block
  float* g = reinterpret_cast<float*>(ring);
  X266_SSE_STAMP(long long t0 = clock64());
  if (lane == 0) {
    x266_fence_proxy_async();          // the others' sums, for the copies
    x266_mbar_expect_tx(bar, blk * (int)sizeof(float) * __popc(last));
    for (int k = 0; k < 2; ++k) {
      if (!(last >> k & 1)) continue;
      const int t = bi * P.x2.cnt + b0 + k;
      tk[2 + t] = 0;
      x266_bulk_copy(g + k * blk, scr + (size_t)t * blk,
                     blk * (int)sizeof(float), bar);
    }
  }
  // one block: the plane's, whose ticket ordered every tile's int64 add
  const long long exact = P.level2 ? 0 : (long long)__ldcg(tk + 1);
  x266_mbar_wait(bar, 0);
  X266_SSE_STAMP(long long t1 = clock64(); bst[0] += t1 - t0);
  if (!P.level2) {
    if (lane == 0)
      plane_done(tk, final_grid(g, P.y1.cnt, P.pitch), exact, out_f, out_i);
    return;
  }
  int r0, r1;
  block_span(P.y2, P.y1.cnt, bi, r0, r1);
  const int top = bi * P.y2.win - P.y2.pad;
  int got = 0;
  if (lane < 2 && (last >> lane & 1)) {
    const int t = bi * P.x2.cnt + b0 + lane;
    scr[P.l2 + t] = add_rows(g + lane * blk, P.pitch, r0 - top, r1 - top,
                             0.0f);
    X266_SSE_STAMP(t0 = clock64(); bst[1] += t0 - t1);
    got = x266_atom_add_acq_rel(tk, 1) == (unsigned long long)(P.blocks - 1);
    X266_SSE_STAMP(t1 = clock64(); bst[2] += t1 - t0);
  }
  // every lane is past its reads of g; the lane that took the last ticket
  const unsigned who = __ballot_sync(0xffffffffu, got);
  if (!who) return;
  const int pitch = (P.x2.cnt + 3) / 4 * 4;    // the level-2 sums' rows
  for (int k = lane; k < P.y2.cnt * pitch; k += 32) {
    const int c = k % pitch;
    g[k] = c < P.x2.cnt ? __ldcg(scr + P.l2 + k / pitch * P.x2.cnt + c)
                        : 0.0f;
  }
  const long long sum = (long long)__ldcg(tk + 1);      // with the sums
  __syncwarp();
  if (lane == __ffs(who) - 1)
    plane_done(tk, final_grid(g, P.y2.cnt, pitch), sum, out_f, out_i);
}

__global__ void __launch_bounds__(64 * kCtaWarps)
    sse_kernel(SseParams p) {
  X266_DYNAMIC_SHARED(uint4, smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool producer = warp >= kCtaWarps;
  const int tw = producer ? warp - kCtaWarps : warp;
  const int g = blockIdx.x * kCtaWarps + tw;       // this warp's tile
  const bool valid = g < p.frames * p.tiles;
  uint4* ring = smem + tw * kWarpVecs;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kRingVecs);
  X266_SSE_STAMP(const long long c0 = clock64();
                 const unsigned long long g0 = globaltimer();
                 long long wait = 0; long long iss = 0;
                 long long bst[3] = {0, 0, 0});
  const int f = valid ? g / p.tiles : 0;
  int r = valid ? g % p.tiles : 0, q = 0;
  while (r >= p.pl[q].tiles) r -= p.pl[q++].tiles;
  const Plane P = p.pl[q];
  const size_t frame = (size_t)f * P.h * P.w;
  const uint8_t* rec = P.rec + frame;
  const uint8_t* orig = P.orig + frame;
  float* out_f = p.out_f32 + f * p.planes + q;
  long long* out_i = p.out_i64 + f * p.planes + q;
  if (!producer && valid && !P.small && lane == 0) {
    for (int k = 0; k < kBars; ++k) x266_mbar_init(bars + k, 1);
    x266_mbar_init_fence();
  }
  __syncthreads();                       // the producers see the barriers
  if (!valid) return;
  if (producer) {
    if (lane == 0 && !P.small && P.vec)
      produce(P, rec, orig, r / P.chunks, (r % P.chunks) * 32, ring, bars);
    return;
  }
  if (P.small) {
    if (lane == 0) small_plane(P, rec, orig, out_f, out_i);
    return;
  }
  __syncwarp();
  const int i = r / P.chunks, j0 = (r % P.chunks) * 32, j = j0 + lane;
  float acc;
  unsigned isum;
  window_row(P, rec, orig, i, j, ring, bars, acc, isum
             X266_SSE_STAMP(, wait, iss));
  float* scr = p.scratch + (size_t)f * p.scratch_frame + P.off;
  if (j < P.x1.cnt) scr[block_index(P, i, j)] = acc;
  const unsigned warp_sum = __reduce_add_sync(0xffffffffu, isum);
  unsigned long long* tk =
      p.tickets + (size_t)(f * p.planes + q) * p.tstride;
  X266_SSE_STAMP(const long long c1 = clock64();
                 const unsigned long long g1 = globaltimer());
  __syncwarp();                    // every lane's sum, before the tickets
  // the blocks the tile's windows fall in: block row bi, columns b0..b1
  const int jl = (j0 + 32 < P.x1.cnt ? j0 + 32 : P.x1.cnt) - 1;
  const int bi = (i + P.y2.pad) / P.y2.win;
  const int b0 = (j0 + P.x2.pad) / P.x2.win, b1 = (jl + P.x2.pad) / P.x2.win;
  int last = 0;
  if (lane == 0) {
    atomicAdd(tk + 1, (unsigned long long)warp_sum);
    for (int b = b0; b <= b1; ++b) {
      const int t = bi * P.x2.cnt + b;
      if (x266_atom_add_acq_rel(tk + 2 + t, 1) ==
          (unsigned long long)(block_tiles(P, bi, b) - 1))
        last |= 1 << (b - b0);
    }
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  if (last)
    blocks_done(P, scr, tk, bi, b0, last, ring, bars + 2 * kRing, out_f, out_i
                X266_SSE_STAMP(, bst));
#ifdef X266_SSE_PHASES
  if (lane == 0 && g < kPhaseTiles) {
    unsigned long long* ph = sse_phase[g];
    ph[0] = c1 - c0;
    ph[1] = wait;
    ph[2] = iss;
    ph[3] = last ? clock64() - c1 : 0;
    ph[4] = g0;
    ph[5] = g1;
    ph[6] = globaltimer();
    ph[7] = sm_warp();
    for (int k = 0; k < 3; ++k) ph[8 + k] = bst[k];
  }
#endif
}

Plane make_plane(int h, int w, const void* rec, const void* orig) {
  Plane P{};
  P.rec = (const uint8_t*)rec;
  P.orig = (const uint8_t*)orig;
  P.h = h;
  P.w = w;
  P.small = h <= kWin && w <= kWin;
  P.vec = w % kWin == 0 && (uintptr_t)rec % 16 == 0 &&
          (uintptr_t)orig % 16 == 0;
  P.y1 = dim_geom(h);
  P.x1 = dim_geom(w);
  P.chunks = (P.x1.cnt + 31) / 32;
  P.tiles = P.small ? 1 : P.y1.cnt * P.chunks;
  P.level2 = P.y1.cnt > kWin || P.x1.cnt > kWin;
  P.y2 = dim_geom(P.y1.cnt);
  P.x2 = dim_geom(P.x1.cnt);
  P.pitch = (P.x2.win + 3) / 4 * 4;
  P.blocks = P.y2.cnt * P.x2.cnt;
  P.l2 = (long long)P.blocks * P.y2.win * P.pitch;
  return P;
}

// A plane's scratch: its blocks and its level-2 sums (rounded up to 4).
long long scratch_floats(const Plane& P) {
  return P.small ? 0 : P.l2 + (P.blocks + 3) / 4 * 4;
}

}  // namespace

extern "C" {

// The float32 SSE in XLA CPU's order (out_f32) and the exact int64 SSE
// (out_i64) of F frames of `planes` (1 to 3) pairs of uint8 planes, each
// (F, h, w) of its own size, rec and orig, both (F, planes) row-major, on
// `stream`, in one launch.  scratch: scratch_len floats, at least F x the
// planes' scratch_floats, zero where no window sum lands and kept so
// between calls; tickets: tickets_len uint64, at least F x planes x (2 +
// the planes' most blocks), zero, and left zero by the launch.  Returns
// cudaGetLastError().
int x266_picture_sse(int frames, int planes, int h0, int w0,
                     const void* rec0, const void* orig0, int h1, int w1,
                     const void* rec1, const void* orig1, int h2, int w2,
                     const void* rec2, const void* orig2, void* scratch,
                     long long scratch_len, void* tickets,
                     long long tickets_len, void* out_f32, void* out_i64,
                     void* stream) {
  const int hs[] = {h0, h1, h2}, ws[] = {w0, w1, w2};
  const void* recs[] = {rec0, rec1, rec2};
  const void* origs[] = {orig0, orig1, orig2};
  if (frames < 1 || planes < 1 || planes > kMaxPlanes)
    return (int)cudaErrorInvalidValue;
  SseParams p{};
  p.planes = planes;
  p.frames = frames;
  long long off = 0;
  int blocks = 1;
  for (int q = 0; q < planes; ++q) {
    if (hs[q] < 1 || ws[q] < 1 || hs[q] > kMaxSide || ws[q] > kMaxSide)
      return (int)cudaErrorInvalidValue;
    p.pl[q] = make_plane(hs[q], ws[q], recs[q], origs[q]);
    p.pl[q].off = off;
    off += scratch_floats(p.pl[q]);
    p.tiles += p.pl[q].tiles;
    if (p.pl[q].blocks > blocks) blocks = p.pl[q].blocks;
  }
  p.tstride = 2 + blocks;
  if (off * frames > scratch_len ||
      (long long)frames * planes * p.tstride > tickets_len)
    return (int)cudaErrorInvalidValue;
  p.scratch = (float*)scratch;
  p.scratch_frame = off;
  p.tickets = (unsigned long long*)tickets;
  p.out_f32 = (float*)out_f32;
  p.out_i64 = (long long*)out_i64;
  const int smem = kCtaWarps * kWarpVecs * (int)sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      sse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchKernel(sse_kernel,
                         dim3((frames * p.tiles + kCtaWarps - 1) / kCtaWarps),
                         dim3(64 * kCtaWarps), args, smem,
                         (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef X266_SSE_PHASES
// The last launch's split for its first n tiles (kPhases uint64 each)
// into host memory.
int x266_sse_phases(void* host, int n) {
  if (n > kPhaseTiles) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, sse_phase,
                                   sizeof(unsigned long long) * kPhases * n);
}
#endif

}  // extern "C"
