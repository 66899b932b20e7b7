// The tensor cores' TF32 mma.sync on this card, for chip_smoke.py's device
// phase: its sustained rate and one instruction's latency, the ceiling
// that the 3xTF32 kernels (ssd_chunk.cu, ssd_chunk_bwd.cu, which issue
// mma.sync.m16n8k8 and not wgmma) meet before the data sheet's dense TF32
// peak.  No TPU kernel corresponds: it is a measurement, not a port.
//
// Each warp runs `iters` rounds of `chains` independent m16n8k8 products
// on constant operands (one accumulator a chain), so the time is the
// tensor pipe's alone: with enough chains and warps an SM it is the rate,
// with one chain and one warp a sub-partition it is the latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"  // mma_tf32

namespace {

template <int NA>
__global__ void mma_probe_kernel(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  float acc[NA][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NA; ++j) ssd::mma_tf32(acc[j], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NA; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// out: blocks * warps * 32 floats.  chains: 1 or 4.
extern "C" int mma_tf32_probe(void* out, int blocks, int warps, int chains,
                              int iters, void* stream) {
  if (blocks < 1 || warps < 1 || warps > 32 || iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (chains == 1)
    mma_probe_kernel<1><<<blocks, 32 * warps, 0, st>>>(o, iters);
  else if (chains == 4)
    mma_probe_kernel<4><<<blocks, 32 * warps, 0, st>>>(o, iters);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
