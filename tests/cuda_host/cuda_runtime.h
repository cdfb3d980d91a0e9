// Host stand-in for the CUDA runtime, for compiling the port's kernel
// sources with g++ on a machine without a GPU (tests only).
//
// A launch runs each thread block as blockDim.x fibers (ucontext) on one
// OS thread; __syncthreads(), the named barriers (x266_bar_sync,
// x266_bar_red_or) and the warp primitives are barriers between the
// fibers, so a fiber that reaches one hands the thread to the next fiber
// that can run, and the last to arrive releases the others.  A named
// barrier id (1-15) takes, in each block, the thread count of its first
// arrival and the fibers that completed its first round: a later arrival
// with another count, or by a fiber outside that set, is a launch error.
// X266_HOST_BLOCKS (an environment variable, default 1) slots, each an OS
// thread, run blocks at once, so a kernel whose blocks wait on each other
// (the recon kernels' row wavefront) runs its tickets, progress waits and
// fences concurrently under g++; a slot runs its blocks one after
// another.  Shared memory (X266_SHARED, X266_DYNAMIC_SHARED) is a
// per-block arena.  Float intrinsics round as their CUDA namesakes do
// (build with -ffp-contract=off).  This checks a kernel's logic and
// arithmetic; it says nothing about speed or occupancy.
//
// The warp reductions (__reduce_add_sync, __reduce_min_sync) meet at the
// warp's barrier like the shuffles; byte SIMD (__vsadu4, __vabsdiffu4,
// __dp4a), funnel shifts and __byte_perm compute what the CUDA math API
// defines; cp.async (x266_cp_async4) and the bulk copy (x266_bulk_copy)
// copy at once, and an mbarrier wait yields until its phase completes.
//
// X266_ASSERT(cond), a no-op in the card build, records a failed check
// here (an out-of-range read, say); the launch then returns an error.

#pragma once

#include <math.h>

#include <ucontext.h>

#include <algorithm>
#include <atomic>
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
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) int2 {
  int x, y;
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

// A slot's fibers and their scheduler.  A barrier counts arrivals; a
// fiber that arrives before the last waits on it, and the scheduler
// resumes the next fiber in round-robin order that is not waiting.
struct HostBarrier {
  unsigned expected, arrived = 0, generation = 0;
};
struct HostFiber;
struct HostSlot {
  std::vector<HostFiber>* fibers;
  unsigned current;
  ucontext_t main;
};
inline thread_local HostSlot* host_slot = nullptr;

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
#define X266_NOINLINE __attribute__((noinline))
#define __launch_bounds__(n)

#define X266_ASSERT(cond)                          \
  do {                                             \
    if (!(cond)) host_check_failed = true;         \
  } while (0)

// Warp primitives (whole warps only: every lane of the warp calls them, as
// the kernels here do): the lanes meet at their warp's barrier around an
// exchange of 8-byte slots.
struct HostWarp {
  HostBarrier* bar;
  unsigned long long* slot;   // [32]
  unsigned size;              // lanes in this warp
};
inline thread_local HostWarp host_warp{nullptr, nullptr, 0};

struct HostFiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  dim3 tid;
  HostWarp warp;
  size_t cursor;                // its X266_SHARED declarations so far
  HostBarrier* waiting = nullptr;
  unsigned generation = 0;
  bool done = false;
};
inline thread_local HostBarrier* host_block_barrier = nullptr;

// Switch from the current fiber to the next one that can run (round
// robin), saving and restoring the per-thread state.
inline void host_switch() {
  HostSlot& sl = *host_slot;
  std::vector<HostFiber>& fs = *sl.fibers;
  HostFiber& me = fs[sl.current];
  me.cursor = host_block_cursor;
  unsigned n = (unsigned)fs.size(), next = sl.current;
  for (unsigned k = 1; k <= n; ++k) {
    HostFiber& f = fs[(sl.current + k) % n];
    if (!f.done && (f.waiting == nullptr ||
                    f.waiting->generation != f.generation)) {
      next = (sl.current + k) % n;
      break;
    }
  }
  HostFiber& nx = fs[next];
  if (nx.done || (nx.waiting != nullptr &&
                  nx.waiting->generation == nx.generation))
    std::abort();   // every fiber waits: a barrier not all threads reach
  nx.waiting = nullptr;
  sl.current = next;
  threadIdx = nx.tid;
  host_warp = nx.warp;
  host_block_cursor = nx.cursor;
  if (&nx != &me) swapcontext(&me.ctx, &nx.ctx);
}

inline void host_arrive(HostBarrier* b) {
  HostFiber& me = (*host_slot->fibers)[host_slot->current];
  if (++b->arrived == b->expected) {
    b->arrived = 0;
    ++b->generation;
    return;
  }
  me.waiting = b;
  me.generation = b->generation;
  host_switch();
}

inline void __syncthreads() { host_arrive(host_block_barrier); }

// Named barriers 1-15 of the running block (per slot): the count and the
// member fibers fixed by the first round, the OR of a bar.red round.
struct HostNamed {
  HostBarrier bar{0};
  std::vector<char> member;
  bool fixed = false;
  int acc = 0, result[2] = {0, 0};
};
inline thread_local HostNamed* host_named = nullptr;   // [16]
inline std::atomic<bool> host_check_failed{false};

inline HostNamed& host_named_arrive(int id, int n) {
  static HostNamed bad;
  if (id <= 0 || id >= 16 || n <= 0 || n % 32 != 0 ||
      (unsigned)n > blockDim.x) {
    host_check_failed = true;
    return bad;
  }
  HostNamed& nb = host_named[id];
  const unsigned t = threadIdx.x;
  if (nb.bar.expected == 0) nb.bar.expected = (unsigned)n;
  if (nb.bar.expected != (unsigned)n) host_check_failed = true;
  if (nb.fixed && !nb.member[t]) host_check_failed = true;
  if (!nb.fixed) nb.member[t] = 1;
  return nb;
}

inline void host_named_done(HostNamed& nb, unsigned generation) {
  if (nb.bar.generation != generation) nb.fixed = true;
}

inline void x266_bar_sync(int id, int n) {
  HostNamed& nb = host_named_arrive(id, n);
  if (nb.bar.expected == 0) return;
  const unsigned g = nb.bar.generation;
  host_arrive(&nb.bar);
  host_named_done(nb, g);
}

inline int x266_bar_red_or(int id, int n, int pred) {
  HostNamed& nb = host_named_arrive(id, n);
  if (nb.bar.expected == 0) return pred != 0;
  const unsigned g = nb.bar.generation;
  nb.acc |= pred != 0;
  if (nb.bar.arrived + 1 == nb.bar.expected) {
    nb.result[g & 1] = nb.acc;
    nb.acc = 0;
  }
  host_arrive(&nb.bar);
  host_named_done(nb, g);
  return nb.result[g & 1];
}

template <class V>
V host_shuffle(V v, int from) {
  const unsigned lane = threadIdx.x % 32;
  std::memcpy(&host_warp.slot[lane], &v, sizeof(V));
  host_arrive(host_warp.bar);
  V r = v;
  if (from >= 0 && (unsigned)from < host_warp.size)
    std::memcpy(&r, &host_warp.slot[from], sizeof(V));
  host_arrive(host_warp.bar);
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) { host_arrive(host_warp.bar); }
template <class V>
V __shfl_sync(unsigned, V v, int from) {
  return host_shuffle(v, from);
}
template <class V>
V __shfl_xor_sync(unsigned, V v, int m) {
  return host_shuffle(v, (int)(threadIdx.x % 32) ^ m);
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
  host_arrive(host_warp.bar);
  unsigned m = 0;
  for (unsigned l = 0; l < host_warp.size; ++l)
    if (host_warp.slot[l]) m |= 1u << l;
  host_arrive(host_warp.bar);
  return m;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
// __reduce_add_sync / __reduce_min_sync (sm_80 redux.sync): every lane
// gets the sum (wrapping) or the minimum of the warp's values.
template <class V, class Op>
V host_reduce(V v, Op op) {
  const unsigned lane = threadIdx.x % 32;
  std::memcpy(&host_warp.slot[lane], &v, sizeof(V));
  host_arrive(host_warp.bar);
  V r;
  std::memcpy(&r, &host_warp.slot[0], sizeof(V));
  for (unsigned l = 1; l < host_warp.size; ++l) {
    V x;
    std::memcpy(&x, &host_warp.slot[l], sizeof(V));
    r = op(r, x);
  }
  host_arrive(host_warp.bar);
  return r;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return host_reduce(v, [](unsigned a, unsigned b) { return a + b; });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return host_reduce(v, [](unsigned a, unsigned b) { return b < a ? b : a; });
}
// Byte SIMD and funnel shifts, as the CUDA math API defines them.
inline unsigned __vsadu4(unsigned a, unsigned b) {
  unsigned s = 0;
  for (int i = 0; i < 32; i += 8) {
    const int x = (int)((a >> i) & 255u), y = (int)((b >> i) & 255u);
    s += (unsigned)(x > y ? x - y : y - x);
  }
  return s;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return (unsigned)((((unsigned long long)hi << 32) | lo) >> (shift & 31));
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long in = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned)((in >> (8 * ((s >> (4 * n)) & 7))) & 255u) << (8 * n);
  return r;
}
inline unsigned __vabsdiffu4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 32; i += 8) {
    const int x = (int)((a >> i) & 255u), y = (int)((b >> i) & 255u);
    r |= (unsigned)(x > y ? x - y : y - x) << i;
  }
  return r;
}
// the unsigned overload: four byte products added to c (wrapping)
inline unsigned __dp4a(unsigned a, unsigned b, unsigned c) {
  for (int i = 0; i < 32; i += 8) c += ((a >> i) & 255u) * ((b >> i) & 255u);
  return c;
}
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}
inline float __uint_as_float(unsigned x) {
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline int atomicOr(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_or(v);
}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline unsigned long long x266_atom_add_acq_rel(unsigned long long* p,
                                                unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(
      v, std::memory_order_acq_rel);
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
inline int4 x266_ldg_early(const int4* p) { return *p; }
// cp.async lands at once here; the wait has nothing to wait for.
inline void x266_cp_async4(void* dst, const void* src) {
  std::memcpy(dst, src, 4);
}
inline void x266_cp_async_wait_all() {}
// An mbarrier counts its completed phases; the bulk copy lands at once,
// so a phase completes at its arrival (one arrival a phase, as the
// kernels use it), and a wait yields to the block's other fibers until
// the phase of its parity has completed: a read that does not wait for
// its copy sees what was there before.  A wait that never ends is a
// launch error.
inline void x266_mbar_init(uint64_t* bar, int) { *bar = 0; }
inline void x266_mbar_init_fence() {}
inline void x266_fence_proxy_async() {}
inline void x266_mbar_arrive(uint64_t* bar) { ++*bar; }
inline void x266_mbar_expect_tx(uint64_t* bar, int) { ++*bar; }
inline void x266_bulk_copy(void* dst, const void* src, int bytes,
                           uint64_t*) {
  std::memcpy(dst, src, bytes);
}
inline void x266_mbar_wait(uint64_t* bar, int parity) {
  // a phase that never completes (a lost arrival, a parity two phases
  // behind) is a launch error, not a hang
  for (long spins = 0; (int)(*bar & 1) == parity; ++spins) {
    if (spins == (1L << 16) || host_check_failed) {
      host_check_failed = true;
      return;
    }
    host_switch();
  }
}
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
inline cudaError_t cudaDeviceSynchronize() { return cudaSuccess; }
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
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice = 3 };
inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t n,
                                   cudaMemcpyKind, cudaStream_t) {
  std::memcpy(dst, src, n);
  return cudaSuccess;
}

// Runs the grid's blocks (x only) on X266_HOST_BLOCKS slots at once, each
// an OS thread (slot i: blocks i, i + slots, ...), each block's
// blockDim.x threads as fibers of its slot's thread.
constexpr size_t kHostStack = 1 << 18;

template <class P>
struct HostLaunch {
  void (*kernel)(P);
  P params;
  static void entry(unsigned lo, unsigned hi) {
    auto* self = reinterpret_cast<HostLaunch*>(
        ((uintptr_t)hi << 32) | (uintptr_t)lo);
    self->kernel(self->params);
    HostSlot& sl = *host_slot;
    (*sl.fibers)[sl.current].done = true;
    // the last fiber of the block returns to the slot's thread
    bool all = true;
    for (auto& f : *sl.fibers) all = all && f.done;
    if (all) {
      setcontext(&sl.main);
    }
    host_switch();
  }
};

template <class P>
cudaError_t cudaLaunchKernel(void (*kernel)(P), dim3 grid, dim3 block,
                             void** args, size_t dynamic_shared,
                             cudaStream_t) {
  HostLaunch<P> launch{kernel, *static_cast<P*>(args[0])};
  const char* env = std::getenv("X266_HOST_BLOCKS");
  const unsigned slots =
      std::min(grid.x, env ? (unsigned)std::max(1, std::atoi(env)) : 1u);
  const unsigned warps = (block.x + 31) / 32;
  std::vector<std::thread> threads;
  for (unsigned i = 0; i < slots; ++i)
    threads.emplace_back([=, &launch] {
      std::vector<unsigned char> arena(kHostStaticShared + dynamic_shared);
      std::vector<unsigned long long> warp_mem(warps * 32);
      std::vector<HostBarrier> warp_bars;
      for (unsigned wi = 0; wi < warps; ++wi)
        warp_bars.push_back({std::min(32u, block.x - 32 * wi)});
      HostBarrier bar{block.x};
      std::vector<HostNamed> named(16);
      std::vector<HostFiber> fibers(block.x);
      HostSlot sl{&fibers, 0, {}};
      host_slot = &sl;
      host_block_barrier = &bar;
      host_named = named.data();
      host_block_arena = arena.data();
      blockDim = block;
      gridDim = grid;
      for (auto& f : fibers) f.stack.reset(new char[kHostStack]);
      const uintptr_t self = (uintptr_t)&launch;
      for (unsigned b = i; b < grid.x; b += slots) {
        blockIdx = dim3(b, 0, 0);
        for (auto& nb : named) {
          nb = HostNamed{};
          nb.member.assign(block.x, 0);
        }
        for (unsigned t = 0; t < block.x; ++t) {
          HostFiber& f = fibers[t];
          const unsigned wi = t / 32;
          f.tid = dim3(t, 0, 0);
          f.warp = {&warp_bars[wi], &warp_mem[wi * 32],
                    std::min(32u, block.x - 32 * wi)};
          f.cursor = 0;
          f.waiting = nullptr;
          f.done = false;
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = f.stack.get();
          f.ctx.uc_stack.ss_size = kHostStack;
          f.ctx.uc_link = nullptr;
          makecontext(&f.ctx, (void (*)())HostLaunch<P>::entry, 2,
                      (unsigned)(self & 0xffffffffu), (unsigned)(self >> 32));
        }
        sl.current = 0;
        threadIdx = fibers[0].tid;
        host_warp = fibers[0].warp;
        host_block_cursor = 0;
        swapcontext(&sl.main, &fibers[0].ctx);
      }
    });
  for (auto& th : threads) th.join();
  return host_check_failed.exchange(false) ? cudaErrorHostCheck
                                           : cudaSuccess;
}
