// Host stand-in for the CUDA runtime, for compiling the port's kernel
// sources with g++ on a machine without a GPU (tests only).
//
// A launch runs each thread block as blockDim.x std::threads that meet at
// a std::barrier for __syncthreads().  The blocks run in waves of
// X266_HOST_BLOCKS (an environment variable, default 1) at once, so a
// kernel whose blocks wait on each other (the recon kernels' row
// wavefront) runs its tickets, progress waits and fences concurrently
// under g++.  Shared memory (X266_SHARED, X266_DYNAMIC_SHARED) is a
// per-block arena.
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
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
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

// Runs the grid's blocks (x only) in waves of X266_HOST_BLOCKS, each
// block's threads concurrently.
template <class P>
cudaError_t cudaLaunchKernel(void (*kernel)(P), dim3 grid, dim3 block,
                             void** args, size_t dynamic_shared,
                             cudaStream_t) {
  P params = *static_cast<P*>(args[0]);
  const char* env = std::getenv("X266_HOST_BLOCKS");
  const unsigned wave = env ? std::max(1, std::atoi(env)) : 1;
  for (unsigned b0 = 0; b0 < grid.x; b0 += wave) {
    const unsigned nb = std::min(wave, grid.x - b0);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::vector<unsigned char>> arenas;
    for (unsigned i = 0; i < nb; ++i) {
      bars.emplace_back(new std::barrier<>(block.x));
      arenas.emplace_back(kHostStaticShared + dynamic_shared);
    }
    std::vector<std::thread> threads;
    for (unsigned i = 0; i < nb; ++i)
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([=, &bars, &arenas] {
          threadIdx = dim3(t, 0, 0);
          blockIdx = dim3(b0 + i, 0, 0);
          blockDim = block;
          gridDim = grid;
          host_block_barrier = bars[i].get();
          host_block_arena = arenas[i].data();
          host_block_cursor = 0;
          kernel(params);
        });
    for (auto& th : threads) th.join();
  }
  return host_check_failed.exchange(false) ? cudaErrorHostCheck
                                           : cudaSuccess;
}
