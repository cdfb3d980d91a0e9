// Device-side definitions shared by the port's kernels.  Under the host
// stand-in (tests/cuda_host/cuda_runtime.h, which defines X266_HOST_SHIM)
// the stand-in supplies each of these instead.
#pragma once

#ifndef X266_HOST_SHIM

// A range check, recorded by the host stand-in only (unevaluated here).
#define X266_ASSERT(cond) ((void)sizeof(cond))

// A block's shared variable and its dynamic shared array.
#define X266_SHARED(T, name) __shared__ T name
#define X266_DYNAMIC_SHARED(T, name) extern __shared__ T name[]

// A device function kept out of line (its registers are its own).
#define X266_NOINLINE __noinline__

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

// A read-only 16-byte load issued where it stands (the compiler may not
// sink it to its first use): its latency runs under the work after it.
__device__ __forceinline__ int4 x266_ldg_early(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// An asynchronous 4-byte copy from global to shared memory (cp.async;
// both addresses 4-byte aligned), and the wait until every copy this
// thread has issued has landed (__syncwarp() after it makes a warp's
// copies visible to all its lanes).
__device__ __forceinline__ void x266_cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void x266_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A shared-memory mbarrier (8 bytes): its initialization for `count`
// arrivals, the fence that makes it visible to the copy engine, an
// arrival, an arrival that expects `bytes` more of transfer, a bulk copy of `bytes`
// (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory that completes on it, and the wait for the phase of
// parity `parity` to complete.
__device__ __forceinline__ void x266_mbar_init(uint64_t* bar, int count) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(b), "r"(count) : "memory");
}
__device__ __forceinline__ void x266_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// A device-scope atomic add with acquire-release order: the writes this
// thread has made or seen before it are visible to a thread that sees
// its result, and the writes before any add it sees are visible to this
// thread after it (the tickets of kernel SSE).  Returns the old value.
__device__ __forceinline__ unsigned long long x266_atom_add_acq_rel(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.add.acq_rel.gpu.global.u64 %0, [%1], %2;"
               : "=l"(old) : "l"(p), "l"(v) : "memory");
  return old;
}

// Orders this thread's (and, after the fences and atomics that made them
// visible, other threads') ordinary accesses before its later bulk
// copies, which run in the async proxy.
__device__ __forceinline__ void x266_fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}
__device__ __forceinline__ void x266_mbar_arrive(uint64_t* bar) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(b) : "memory");
}
__device__ __forceinline__ void x266_mbar_expect_tx(uint64_t* bar,
                                                    int bytes) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
}
__device__ __forceinline__ void x266_bulk_copy(void* dst, const void* src,
                                               int bytes, uint64_t* bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
}
__device__ __forceinline__ void x266_mbar_wait(uint64_t* bar, int parity) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
}

// A named barrier (bar.sync id, n: the n threads that use barrier id,
// a multiple of 32; 0 is __syncthreads's), and the same barrier ORing a
// predicate over those threads (bar.red.or.pred).
__device__ __forceinline__ void x266_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ int x266_bar_red_or(int id, int n, int pred) {
  int r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 p, %3, 0;\n\t"
      "bar.red.or.pred q, %1, %2, p;\n\t"
      "selp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(r) : "r"(id), "r"(n), "r"(pred) : "memory");
  return r;
}

#endif
