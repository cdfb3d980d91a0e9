// Device-side definitions shared by the port's kernels.  Under the host
// stand-in (tests/cuda_host/cuda_runtime.h, which defines X266_HOST_SHIM)
// the stand-in supplies each of these instead.
#pragma once

#ifndef X266_HOST_SHIM

// A range check, recorded by the host stand-in only.
#define X266_ASSERT(cond) ((void)0)

// A block's shared variable and its dynamic shared array.
#define X266_SHARED(T, name) __shared__ T name
#define X266_DYNAMIC_SHARED(T, name) extern __shared__ T name[]

// Device-scope acquire load and release store (the recon kernels' row
// progress counters).
__device__ __forceinline__ int x266_ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void x266_st_release(int* p, int v) {
  asm volatile("st.release.gpu.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

#endif
