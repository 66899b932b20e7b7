// Helpers shared by the SSD chunk scan's forward (ssd_chunk.cu) and its
// backward (ssd_chunk_bwd.cu), sm_90a: the 3xTF32 split and tensor-core
// product, conflict-free shared-memory strides, operand staging by
// cp.async, paired output stores and the running sum of dA over a chunk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_mainloop.cuh"  // cp.async helpers, to_f32

namespace ssd {

using sgemm::cp_async16;
using sgemm::cp_async4;
using sgemm::to_f32;

constexpr int LMAX = 128, PMAX = 64, NMAX = 128;  // chunk, head dim, state

enum { VEC_X = 1, VEC_B = 2, VEC_C = 4, VEC_G = 8, VEC_S = 16 };

__host__ __device__ constexpr int up(int a, int b) { return (a + b - 1) / b * b; }
// Row strides (floats) for conflict-free fragment reads: an A fragment reads
// row g, column t (g < 8, t < 4) of a row-major tile, g * S + t, distinct
// banks when S = 4 mod 8; a B fragment reads row t, column g, t * S + g,
// distinct when S = 8 mod 16.  Both keep rows 16-byte aligned.
__host__ __device__ constexpr int stride_a(int n) { return up(n, 8) + 4; }
__host__ __device__ constexpr int stride_b(int n) { return up(n, 16) + 8; }

// ---- tensor-core helpers ---------------------------------------------------

// hi = v rounded to TF32's 10 mantissa bits (to nearest, ties away from
// zero, by integer add and mask), lo = v - hi exactly; the tensor core reads
// lo's top 19 bits, which keeps 10 of its bits: |v - hi - tf32(lo)| <=
// 2^-21 |v|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d + e += a b in 3xTF32: the product of the high parts into d, the two
// small cross terms into e, so that the three products of a step do not
// wait on each other (the caller adds e to d at the end)
__device__ __forceinline__ void mma3(float (&d)[4], float (&e)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float b0,
                                     const float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(e, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
  mma_tf32(e, ah, bl0, bl1);
}
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g)
//   D (16 x 8): d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1)
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

// ---- staging ----------------------------------------------------------------

// dst[r * ds + k] = src[r * gs + k] for r < rows, k < cols, and 0 elsewhere
// in [0, rows_pad) x [0, cols_pad) (cols_pad % 4 == 0, ds % 4 == 0).  f32
// rows go by cp.async (the caller commits and waits); `quad` says that every
// row starts 4-element aligned and cols % 4 == 0.  bf16 rows are read and
// widened synchronously.
__device__ __forceinline__ void quad_f32(float* d, const float* s, int n,
                                         bool quad) {
  if (n >= 4 && quad) {
    cp_async16(d, s, 16);
  } else if (n <= 0) {
    *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n)
        cp_async4(d + j, s + j, true);
      else
        d[j] = 0.f;
    }
  }
}
__device__ __forceinline__ void quad_f32(float* d, const __nv_bfloat16* s,
                                         int n, bool quad) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n >= 4 && quad) {
    const uint2 r = *reinterpret_cast<const uint2*>(s);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
    v = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                    __high2float(hi));
  } else if (n > 0) {
    v.x = to_f32(s[0]);
    if (n > 1) v.y = to_f32(s[1]);
    if (n > 2) v.z = to_f32(s[2]);
    if (n > 3) v.w = to_f32(s[3]);
  }
  *reinterpret_cast<float4*>(d) = v;
}
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ds, const T* src,
                                      long long gs, int rows, int cols,
                                      int rows_pad, int cols_pad, bool quad) {
  // a warp takes 32 / qpr rows at a time, qpr lanes a row (a power of two
  // <= the row's quads), so no thread divides
  const int q = cols_pad / 4;
  const int qpr = q >= 32 ? 32 : q >= 16 ? 16 : q >= 8 ? 8 : q >= 4 ? 4
                                                    : q >= 2 ? 2 : 1;
  const int lane = threadIdx.x & 31, rpw = 32 / qpr;
  const int step = (blockDim.x >> 5) * rpw;
  for (int r = (threadIdx.x >> 5) * rpw + lane / qpr; r < rows_pad;
       r += step) {
    for (int k = 4 * (lane % qpr); k < cols_pad; k += 4 * qpr) {
      const int n = r < rows ? cols - k : 0;
      quad_f32(dst + r * ds + k, n > 0 ? src + r * gs + k : src, n, quad);
    }
  }
}

// Two neighbouring outputs: a at p[0] and, when `has_b`, b at p[1], as one
// store when `even` says that p is aligned for the pair.
__device__ __forceinline__ void store2(float* p, float a, float b, bool has_b,
                                       bool even) {
  if (has_b && even) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (has_b) p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b,
                                       bool has_b, bool even) {
  if (has_b && even) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (has_b) p[1] = __float2bfloat16_rn(b);
  }
}

// The running sum of dA over a chunk, by warp 0: lane i owns rows 4i..4i+3.
// Writes dts[l] (dt, 0 past len) and cum[l] for every l < LMAX.
__device__ __forceinline__ void chunk_scan(const float* dtg, long long sdt,
                                           int len, float a, float* cum,
                                           float* dts) {
  const int lane = threadIdx.x & 31;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = 4 * lane + i;
    const float d = l < len ? dtg[l * sdt] : 0.f;
    dts[l] = d;
    v[i] = d * a;
  }
  v[1] += v[0];
  v[2] += v[1];
  v[3] += v[2];
  float incl = v[3];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) cum[4 * lane + i] = excl + v[i];
}

}  // namespace ssd
