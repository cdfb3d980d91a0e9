// The device functions the motion and SSE kernels
// (x266_tpu_torch/csrc/me.cu, sse.cu) build on, one launch per function
// over arrays of words, so a test can hold each to its definition: under
// g++ the host stand-in's versions (tests/test_torch_kernel_host.py), on
// the card the hardware's (tests/test_torch_gpu.py).
//
//   op 0  out = __vsadu4(a, b)
//   op 1  out = __funnelshift_r(a, b, c)
//   op 2  out = __byte_perm(a, b, c)
//   op 3  out = __reduce_add_sync over each warp's a
//   op 4  out = __reduce_min_sync over each warp's a
//   op 5  out = a, copied through shared memory with x266_cp_async4 and
//         read back, after x266_cp_async_wait_all and __syncwarp, by the
//         lane 7 places on in the warp
//   op 6  out = __vabsdiffu4(a, b)
//   op 7  out = __dp4a(a, b, c), unsigned
//   op 8  out = a, copied through shared memory by one x266_bulk_copy
//         (lane 0, the warp's 32 words, on an mbarrier it initialized
//         and armed with x266_mbar_expect_tx) and read back after
//         x266_mbar_wait by the lane 7 places on
//
// n is a multiple of 32: one warp per 32 words.

#include <cstdint>
#include <cuda_runtime.h>

#include "x266_device.cuh"

namespace {

struct PrimParams {
  int op;
  const uint32_t* a;
  const uint32_t* b;
  const uint32_t* c;
  uint32_t* out;
};

__global__ void primitives_kernel(PrimParams p) {
  using Buf = uint32_t[32];
  using VecBuf = uint4[8];
  X266_SHARED(Buf, buf);
  X266_SHARED(VecBuf, vbuf);
  X266_SHARED(uint64_t, bar);
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  const uint32_t a = p.a[i], b = p.b[i], c = p.c[i];
  uint32_t r = 0;
  switch (p.op) {
    case 0: r = __vsadu4(a, b); break;
    case 1: r = __funnelshift_r(a, b, c); break;
    case 2: r = __byte_perm(a, b, c); break;
    case 3: r = __reduce_add_sync(0xffffffffu, a); break;
    case 4: r = __reduce_min_sync(0xffffffffu, a); break;
    case 5:
      x266_cp_async4(&buf[lane], p.a + i);
      x266_cp_async_wait_all();
      __syncwarp();
      r = buf[(lane + 7) % 32];
      break;
    case 6: r = __vabsdiffu4(a, b); break;
    case 7: r = __dp4a(a, b, c); break;
    case 8:
      // lane 0 copies the warp's 32 words in one bulk copy
      if (lane == 0) {
        x266_mbar_init(&bar, 1);
        x266_mbar_init_fence();
      }
      __syncwarp();
      if (lane == 0) {
        x266_mbar_expect_tx(&bar, 128);
        x266_bulk_copy(vbuf, p.a + blockIdx.x * 32, 128, &bar);
      }
      x266_mbar_wait(&bar, 0);
      r = reinterpret_cast<const uint32_t*>(vbuf)[(lane + 7) % 32];
      break;
  }
  p.out[i] = r;
}

}  // namespace

extern "C" int x266_primitives(int op, int n, const void* a, const void* b,
                               const void* c, void* out) {
  PrimParams p{op, (const uint32_t*)a, (const uint32_t*)b,
               (const uint32_t*)c, (uint32_t*)out};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchKernel(primitives_kernel, dim3(n / 32),
                                     dim3(32), args, 0, nullptr);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}
