// The latency of a dependent float32 add on the card: one thread adds b
// to a n times, each add waiting for the last (__fadd_rn; the library is
// built with -fmad=false, so nothing is contracted or reassociated), and
// clock64() around the chain.  chip_smoke.py and tools/profile_alf.py
// price the ALF kernels' ordered chains (CC-ALF's gate, ALFCLS's lane
// chains) with it: their dependent-add floors.
//
//     x266_add_latency(n, in, out, cycles, stream)
//
// in: 2 float32 (a, b); out: 1 float32 (the sum, so that the chain is
// kept); cycles: 1 int64.  Returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void add_chain(const float* in, float* out, long long* cycles,
                          int n) {
  float a = in[0];
  const float b = in[1];
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) a = __fadd_rn(a, b);
  const long long t1 = clock64();
  out[0] = a;
  cycles[0] = t1 - t0;
}

}  // namespace

extern "C" int x266_add_latency(int n, const void* in, void* out,
                                void* cycles, void* stream) {
  add_chain<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (long long*)cycles, n);
  return (int)cudaGetLastError();
}
