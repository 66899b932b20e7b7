// Direct VALID 2-D convolution for sm_90a, plain C interface:
//   x (N, C_I, H_I, W_I) * w (C_O, C_I, K, K), stride s -> (N, C_O, H_O, W_O)
//
// Replaces the Pallas kernel src/repro/kernels/conv2d.py::conv2d_pallas
// (body _conv_kernel), the worker's conv subtask.  That kernel takes one
// image and tiles output channels only; here the batch axis is part of the
// kernel, because coded pieces are as narrow as W_O = 2 and a tile over the
// width alone would leave the card empty.
//
// Design: implicit GEMM, nothing is materialised.  With R = C_I * K * K and
// P = N * H_O * W_O the convolution is  out (C_O, P) = w (C_O, R) @ patch (R, P),
// where w is the OIHW tensor read as a row-major matrix and
// patch[(ci, kh, kw), (n, ho, wo)] = x[n, ci, ho * s + kh, wo * s + kw] is
// gathered on the fly.  A block owns a 64 (C_O) x 64 (pixels) tile, loops
// over R in steps of 16, stages the weight tile and the gathered patch tile
// in shared memory as f32, and each of its 256 threads accumulates a 4 x 4
// block of outputs in f32 registers.  Every edge (C_O, P, R) is masked, so
// any C_O, any K and any stride work.
//
// x is addressed through its element strides, so a width slice x[..., a:b]
// of a larger tensor is read in place; w and the output are contiguous.
//
// Bound: compute.  At VGG16 widths the arithmetic intensity is far above
// the card's f32 ridge, so the ceiling is the f32 FMA rate (no tensor cores
// here: plain fmaf in ascending (ci, kh, kw) order, inputs upcast to f32,
// one rounding to the input type at the end).
//
// Launches on the given stream, allocates nothing, does not synchronise.
// The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

struct ConvShape {
  int N, C_I, C_O, H_O, W_O, K, stride;
  long long sxn, sxc, sxh, sxw;  // element strides of x
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_igemm(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ out, const ConvShape s) {
  // +4 keeps rows 16-byte aligned and spreads the transposed stores over banks
  __shared__ __align__(16) float Ws[BK][BM + 4];
  __shared__ __align__(16) float Xs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int KK = s.K * s.K;
  const int R = s.C_I * KK;
  const long long HW = (long long)s.H_O * s.W_O;
  const long long P = (long long)s.N * HW;
  const int m0 = blockIdx.y * BM;
  const long long p0 = (long long)blockIdx.x * BN;

  // the pixel this thread gathers for the patch tile: fixed over the R loop
  const int pp = tid % BN;
  const int kk_base = tid / BN;  // 0 .. THREADS / BN - 1
  const long long p_load = p0 + pp;
  const bool p_ok = p_load < P;
  long long x_base = 0;
  if (p_ok) {
    const long long n = p_load / HW;
    const long long q = p_load - n * HW;
    const long long ho = q / s.W_O;
    const long long wo = q - ho * s.W_O;
    x_base = n * s.sxn + ho * s.stride * s.sxh + wo * s.stride * s.sxw;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < R; r0 += BK) {
    // weight tile: w is (C_O, R) row-major, consecutive threads along R
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e % BK, mm = e / BK;
      const int co = m0 + mm, r = r0 + kk;
      Ws[kk][mm] =
          (co < s.C_O && r < R) ? to_f32(w[(long long)co * R + r]) : 0.f;
    }
    // patch tile: consecutive threads along output pixels
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int kk = kk_base + i * (THREADS / BN);
      const int r = r0 + kk;
      float v = 0.f;
      if (p_ok && r < R) {
        const int ci = r / KK;
        const int rem = r - ci * KK;
        const int kh = rem / s.K;
        const int kw = rem - kh * s.K;
        v = to_f32(x[x_base + ci * s.sxc + kh * s.sxh + kw * s.sxw]);
      }
      Xs[kk][pp] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&Ws[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Xs[kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // out is contiguous NCHW: ((n * C_O + co) * H_O + ho) * W_O + wo
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const long long p = p0 + tx * TN + j;
    if (p >= P) continue;
    const long long n = p / HW;
    const long long q = p - n * HW;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int co = m0 + ty * TM + i;
      if (co < s.C_O)
        out[(n * s.C_O + co) * HW + q] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, const ConvShape& s,
            cudaStream_t stream) {
  const long long P = (long long)s.N * s.H_O * s.W_O;
  const dim3 grid((unsigned)((P + BN - 1) / BN),
                  (unsigned)((s.C_O + BM - 1) / BM));
  conv2d_igemm<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() (0 = launched).
extern "C" int conv2d_launch(const void* x, const void* w, void* out, int N,
                             int C_I, int C_O, int H_O, int W_O, int K,
                             int stride, long long sxn, long long sxc,
                             long long sxh, long long sxw, int dtype,
                             void* stream) {
  const ConvShape s = {N, C_I, C_O, H_O, W_O, K, stride, sxn, sxc, sxh, sxw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, out, s, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, out, s, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
