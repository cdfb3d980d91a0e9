// Host stand-in for the CUDA runtime, for compiling the port's kernel
// sources with g++ on a machine without a GPU (tests only).
//
// A launch runs each thread block in turn as kThreads std::threads that
// share the block's __shared__ variables (function-local statics) and
// meet at a std::barrier for __syncthreads().  Float intrinsics round as
// their CUDA namesakes do (build with -ffp-contract=off).  This checks a
// kernel's logic and arithmetic; it says nothing about speed, occupancy
// or races that the block-wide barriers do not already order.
//
// X266_ASSERT(cond), a no-op in the card build, records a failed check
// here (an out-of-range read, say); the launch then returns an error.

#pragma once

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

inline thread_local dim3 threadIdx{0, 0, 0};
inline thread_local dim3 blockIdx{0, 0, 0};
inline std::barrier<>* host_block_barrier = nullptr;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __constant__
#define __launch_bounds__(n)

inline std::atomic<bool> host_check_failed{false};
#define X266_ASSERT(cond)                          \
  do {                                             \
    if (!(cond)) host_check_failed = true;         \
  } while (0)

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
template <class T>
inline T __ldg(const T* p) { return *p; }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorHostCheck = 1;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }

// Runs the grid's blocks one after another (x only), each block's
// threads concurrently.
template <class P>
cudaError_t cudaLaunchKernel(void (*kernel)(P), dim3 grid, dim3 block,
                             void** args, size_t, cudaStream_t) {
  P params = *static_cast<P*>(args[0]);
  for (unsigned b = 0; b < grid.x; ++b) {
    std::barrier<> bar(block.x);
    host_block_barrier = &bar;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([=] {
        threadIdx = dim3(t, 0, 0);
        blockIdx = dim3(b, 0, 0);
        kernel(params);
      });
    for (auto& th : threads) th.join();
  }
  return host_check_failed.exchange(false) ? cudaErrorHostCheck
                                           : cudaSuccess;
}
