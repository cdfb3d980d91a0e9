// Host stand-in for the CUDA runtime, for compiling the port's kernel
// sources with g++ on a machine without a GPU (tests only).
//
// A launch runs each thread block as blockDim.x std::threads that meet at
// a std::barrier for __syncthreads().  X266_HOST_BLOCKS (an environment
// variable, default 1) blocks run at once, so a kernel whose blocks wait
// on each other (the recon kernels' row wavefront) runs its tickets,
// progress waits and fences concurrently under g++; the threads of one
// slot run its blocks one after another.  Shared memory (X266_SHARED,
// X266_DYNAMIC_SHARED) is a per-block arena.  Warp shuffles and ballots
// meet at a barrier of the warp's threads.
// Float intrinsics round as their CUDA namesakes do (build with
// -ffp-contract=off).  This checks a kernel's logic and arithmetic; it
// says nothing about speed or occupancy.
//
// X266_ASSERT(cond), a no-op in the card build, records a failed check
// here (an out-of-range read, say); the launch then returns an error.

#pragma once

#include <math.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(16) float4 {
  float x, y, z, w;
};

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

inline thread_local dim3 threadIdx{0, 0, 0};
inline thread_local dim3 blockIdx{0, 0, 0};
inline thread_local dim3 blockDim{1, 1, 1};
inline thread_local dim3 gridDim{1, 1, 1};
inline thread_local std::barrier<>* host_block_barrier = nullptr;

// The block's shared-memory arena: static variables first, in the order
// each thread declares them, then the dynamic array.
constexpr size_t kHostStaticShared = 1 << 17;
inline thread_local unsigned char* host_block_arena = nullptr;
inline thread_local size_t host_block_cursor = 0;

template <class T>
T& host_block_shared() {
  size_t off = (host_block_cursor + alignof(T) - 1) & ~(alignof(T) - 1);
  host_block_cursor = off + sizeof(T);
  return *reinterpret_cast<T*>(host_block_arena + off);
}

#define X266_HOST_SHIM 1
#define X266_SHARED(T, name) T& name = host_block_shared<T>()
#define X266_DYNAMIC_SHARED(T, name) \
  T* name = reinterpret_cast<T*>(host_block_arena + kHostStaticShared)

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(n)

inline std::atomic<bool> host_check_failed{false};
#define X266_ASSERT(cond)                          \
  do {                                             \
    if (!(cond)) host_check_failed = true;         \
  } while (0)

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

// Warp primitives (whole warps only: every lane of the warp calls them, as
// the kernels here do): the lanes meet at their warp's barrier around an
// exchange of 8-byte slots.
struct HostWarp {
  std::barrier<>* bar;
  unsigned long long* slot;   // [32]
  unsigned size;              // lanes in this warp
};
inline thread_local HostWarp host_warp{nullptr, nullptr, 0};

template <class V>
V host_shuffle(V v, int from) {
  const unsigned lane = threadIdx.x % 32;
  std::memcpy(&host_warp.slot[lane], &v, sizeof(V));
  host_warp.bar->arrive_and_wait();
  V r = v;
  if (from >= 0 && (unsigned)from < host_warp.size)
    std::memcpy(&r, &host_warp.slot[from], sizeof(V));
  host_warp.bar->arrive_and_wait();
  return r;
}
template <class V>
V __shfl_down_sync(unsigned, V v, int d) {
  return host_shuffle(v, (int)(threadIdx.x % 32) + d);
}
template <class V>
V __shfl_up_sync(unsigned, V v, int d) {
  return host_shuffle(v, (int)(threadIdx.x % 32) - d);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned lane = threadIdx.x % 32;
  host_warp.slot[lane] = pred ? 1 : 0;
  host_warp.bar->arrive_and_wait();
  unsigned m = 0;
  for (unsigned l = 0; l < host_warp.size; ++l)
    if (host_warp.slot[l]) m |= 1u << l;
  host_warp.bar->arrive_and_wait();
  return m;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline int x266_ld_acquire(const int* p) {
  int v = std::atomic_ref<int>(*const_cast<int*>(p)).load(
      std::memory_order_acquire);
  std::this_thread::yield();
  return v;
}
inline void x266_st_release(int* p, int v) {
  std::atomic_ref<int>(*p).store(v, std::memory_order_release);
}
inline void __nanosleep(unsigned) {}
template <class T>
inline T __ldg(const T* p) { return *p; }
template <class T>
inline T __ldcg(const T* p) { return *p; }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float __fdiv_rn(float a, float b) {
  volatile float r = a / b;
  return r;
}
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __dadd_rn(double a, double b) {
  volatile double r = a + b;
  return r;
}
inline float __double2float_rn(double a) {
  volatile float r = (float)a;
  return r;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorHostCheck = 1;
constexpr cudaError_t cudaErrorInvalidValue = 2;
constexpr cudaError_t cudaErrorInvalidConfiguration = 9;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;
  return cudaSuccess;
}
// Every size is allowed here: the arena grows to the launch's request.
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = 8;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}

// Runs the grid's blocks (x only) on X266_HOST_BLOCKS slots at once, each
// slot's blockDim.x threads running block after block (slot i: blocks i,
// i + slots, ...), each block's threads concurrently; a slot starts its
// next block when all its threads have left the last one.
template <class P>
cudaError_t cudaLaunchKernel(void (*kernel)(P), dim3 grid, dim3 block,
                             void** args, size_t dynamic_shared,
                             cudaStream_t) {
  P params = *static_cast<P*>(args[0]);
  const char* env = std::getenv("X266_HOST_BLOCKS");
  const unsigned slots =
      std::min(grid.x, env ? (unsigned)std::max(1, std::atoi(env)) : 1u);
  std::vector<std::unique_ptr<std::barrier<>>> bars, warp_bars;
  std::vector<std::vector<unsigned char>> arenas;
  const unsigned warps = (block.x + 31) / 32;
  std::vector<unsigned long long> slots_mem(slots * warps * 32);
  for (unsigned i = 0; i < slots; ++i) {
    bars.emplace_back(new std::barrier<>(block.x));
    arenas.emplace_back(kHostStaticShared + dynamic_shared);
    for (unsigned wi = 0; wi < warps; ++wi)
      warp_bars.emplace_back(
          new std::barrier<>(std::min(32u, block.x - 32 * wi)));
  }
  std::vector<std::thread> threads;
  for (unsigned i = 0; i < slots; ++i)
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([=, &bars, &arenas, &warp_bars, &slots_mem] {
        threadIdx = dim3(t, 0, 0);
        blockDim = block;
        gridDim = grid;
        host_block_barrier = bars[i].get();
        host_block_arena = arenas[i].data();
        const unsigned wi = t / 32;
        host_warp = {warp_bars[i * warps + wi].get(),
                     &slots_mem[(i * warps + wi) * 32],
                     std::min(32u, block.x - 32 * wi)};
        for (unsigned b = i; b < grid.x; b += slots) {
          blockIdx = dim3(b, 0, 0);
          host_block_cursor = 0;
          kernel(params);
          host_block_barrier->arrive_and_wait();
        }
      });
  for (auto& th : threads) th.join();
  return host_check_failed.exchange(false) ? cudaErrorHostCheck
                                           : cudaSuccess;
}
