// Direct VALID 2-D convolution for sm_90a, plain C interface:
//   x (N, C_I, H_I, W_I) * w (C_O, C_I, K, K), stride s -> (N, C_O, H_O, W_O)
//
// Replaces the Pallas kernel src/repro/kernels/conv2d.py::conv2d_pallas
// (body _conv_kernel), the worker's conv subtask.  That kernel takes one
// image and tiles output channels only; here the batch axis is part of the
// kernel, because coded pieces are as narrow as W_O = 2 and a tile over the
// width alone would leave the card empty.
//
// Bound: the f32 FMA rate.  At VGG16 widths every byte moved feeds hundreds
// of multiply-adds (no tensor cores: plain fmaf, inputs upcast to f32, one
// rounding to the input type at the end).
//
// Design: implicit GEMM, nothing is materialised.  With R = C_I * K * K and
// P = N * H_O * W_O the convolution is  out (C_O, P) = w (C_O, R) @ patch (R, P),
// where w is the OIHW tensor read as a row-major matrix and
// patch[(ci, kh, kw), (n, ho, wo)] = x[n, ci, ho * s + kh, wo * s + kw] is
// gathered on the fly.  The mainloop is sgemm_mainloop.cuh's (shared with
// the skinny GEMM's tiled regime): a 4-stage cp.async ring, the weight tile
// staged K-major, the patch tile gathered by 4-byte cp.async with zero fill
// at every masked edge (C_O, P, R), register-blocked 8 x 8 or 4 x 4 outputs
// per thread.  x is addressed through its element strides, so a width slice
// x[..., a:b] of a larger tensor is read in place; w and the output are
// contiguous.  The offset of each contraction row (ci, kh, kw) in x is
// computed once per block into a table in shared memory, so the gather does
// no division.
//
// R-split: VGG16's coded pieces are narrow, so the (C_O, P) tile grid alone
// leaves most of the 132 SMs idle at the deep layers (conv5_x: P = 28).  R
// is split into `splits` ascending ranges of `chunk` rows over a
// (splits, 1, 1) thread-block cluster; each rank runs its range as one
// ascending fmaf chain and the partials are summed through distributed
// shared memory in ascending rank.  The Python plan
// (kernels/conv2d.py::conv_plan) makes the split a function of the weight's
// shape and dtype only, so every output element has one reduction order
// whatever N, H, W or the tile: a conv of n stacked pieces gives each piece
// the bits of its own launch.
//
// Launches on the given stream, allocates nothing, does not synchronise.
// The entry point returns the launch's error; a plan this file cannot take
// returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_mainloop.cuh"

namespace {

using sgemm::BK;
using sgemm::from_f32;
using sgemm::to_f32;

struct ConvShape {
  int N, C_I, C_O, H_O, W_O, K, stride;
  long long sxn, sxc, sxh, sxw;  // element strides of x
};

// The patch tile: each thread gathers one fixed output pixel (column) of the
// tile for PER contraction rows, so its pixel's base offset is computed once;
// the offset of contraction row r = (ci, kh, kw) comes from `tab`, built once
// per block for its range of R (tab[r - k_begin]).
template <typename T, class Tl>
struct PatchB {
  static constexpr int PER = Tl::BN * BK / Tl::THREADS;
  static constexpr int ROWS = Tl::THREADS / Tl::BN;  // row stride between them
  const T* x;
  const int* tab;
  int k_begin;
  int pp, kk0;
  bool p_ok;
  long long x_base;
  float reg[PER];  // bf16: the tile in flight

  __device__ void init(const ConvShape& s, long long p0) {
    pp = threadIdx.x % Tl::BN;
    kk0 = threadIdx.x / Tl::BN;
    const long long HW = (long long)s.H_O * s.W_O;
    const long long p = p0 + pp;
    p_ok = p < (long long)s.N * HW;
    x_base = 0;
    if (p_ok) {
      const long long n = p / HW;
      const long long q = p - n * HW;
      const long long ho = q / s.W_O;
      const long long wo = q - ho * s.W_O;
      x_base = n * s.sxn + ho * s.stride * s.sxh + wo * s.stride * s.sxw;
    }
  }
  __device__ void fetch(float* Bs, int k0, int k_end) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int kk = kk0 + i * ROWS;
      const int r = k0 + kk;
      const bool ok = p_ok && r < k_end;
      const long long off = ok ? x_base + tab[r - k_begin] : 0;
      if constexpr (sizeof(T) == 4) {
        sgemm::cp_async4(&Bs[kk * Tl::BN + pp],
                         reinterpret_cast<const float*>(x + off), ok);
      } else {
        reg[i] = ok ? to_f32(x[off]) : 0.f;
      }
    }
  }
  __device__ void store(float* Bs) {
    if constexpr (sizeof(T) != 4) {
#pragma unroll
      for (int i = 0; i < PER; ++i) Bs[(kk0 + i * ROWS) * Tl::BN + pp] = reg[i];
    }
  }
};

template <typename T, class Tl>
__global__ void __launch_bounds__(Tl::THREADS)
conv2d_implicit_gemm(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, const ConvShape s, int splits,
                     int chunk) {
  extern __shared__ __align__(16) float smem[];
  int* tab = reinterpret_cast<int*>(smem + Tl::SMEM_BYTES / 4);
  const int R = s.C_I * s.K * s.K;
  const long long HW = (long long)s.H_O * s.W_O;
  const long long P = (long long)s.N * HW;
  // a (splits, 1, 1) cluster: consecutive blocks along x are its ranks
  const int rank = (int)(blockIdx.x % splits);
  const long long p0 = (long long)(blockIdx.x / splits) * Tl::BN;
  const int m0 = blockIdx.y * Tl::BM;
  const int k_begin = rank * chunk;
  const int k_end = min(R, k_begin + chunk);

  // the offsets of this block's contraction rows, ascending r
  const int KK = s.K * s.K;
  for (int i = threadIdx.x; i < k_end - k_begin; i += Tl::THREADS) {
    const int r = k_begin + i;
    const int ci = r / KK;
    const int rem = r - ci * KK;
    const int kh = rem / s.K;
    tab[i] = (int)(ci * s.sxc + kh * s.sxh + (rem - kh * s.K) * s.sxw);
  }
  __syncthreads();
  sgemm::RowMajorA<T, Tl> la{w, s.C_O, R, m0};
  PatchB<T, Tl> lb{x, tab, k_begin};
  lb.init(s, p0);
  float acc[Tl::TM][Tl::TN];
#pragma unroll
  for (int i = 0; i < Tl::TM; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TN; ++j) acc[i][j] = 0.f;
  sgemm::mainloop<Tl>(smem, la, lb, k_begin, k_end, acc);
  // out is contiguous NCHW: ((n * C_O + co) * H_O + ho) * W_O + wo
  auto store = [&](int r, int c, float v) {
    const int co = m0 + r;
    const long long p = p0 + c;
    if (co < s.C_O && p < P) {
      const long long n = p / HW;
      out[(n * s.C_O + co) * HW + (p - n * HW)] = from_f32<T>(v);
    }
  };
  sgemm::split_reduce_store<Tl>(smem, acc, splits, store);
}

template <typename T, class Tl>
int launch(const void* x, const void* w, void* out, const ConvShape& s,
           int splits, int chunk, int smem, cudaStream_t stream) {
  // the ring, then one int offset per contraction row of a split
  if (smem != Tl::SMEM_BYTES + 4 * chunk) return (int)cudaErrorInvalidValue;
  const long long P = (long long)s.N * s.H_O * s.W_O;
  const long long gx = (P + Tl::BN - 1) / Tl::BN * splits;
  const long long gy = (s.C_O + Tl::BM - 1) / Tl::BM;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  return (int)sgemm::launch_cluster(
      &conv2d_implicit_gemm<T, Tl>, dim3((unsigned)gx, (unsigned)gy),
      Tl::THREADS, smem, splits, stream, static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<T*>(out), s, splits, chunk);
}

template <typename T>
int launch_plan(const void* x, const void* w, void* out, const ConvShape& s,
                int config, int splits, int chunk, int smem,
                cudaStream_t stream) {
  const long long R = (long long)s.C_I * s.K * s.K;
  // the splits are `splits` ascending ranges of `chunk` rows, none empty
  if (splits < 1 || splits > sgemm::MAX_SPLIT || chunk < 1 ||
      (long long)(splits - 1) * chunk >= R || (long long)splits * chunk < R)
    return (int)cudaErrorInvalidValue;
  switch (config) {
#define TILE_CASE(ID, BM, BN, TM, TN) \
  case ID:                            \
    return launch<T, sgemm::Tile<BM, BN, TM, TN>>(x, w, out, s, splits, chunk, smem, stream);
    SGEMM_FOR_EACH_TILE(TILE_CASE)
#undef TILE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  config: the tile index of
// SGEMM_FOR_EACH_TILE; splits / chunk: the R-split; smem: dynamic shared
// bytes (the tile's ring + 4 * chunk).  The offsets of x's channel, row and
// column steps within one image must fit an int (the wrapper checks).  Returns the launch's error (0 = launched).
extern "C" int conv2d_launch(const void* x, const void* w, void* out, int N,
                             int C_I, int C_O, int H_O, int W_O, int K,
                             int stride, long long sxn, long long sxc,
                             long long sxh, long long sxw, int dtype,
                             int config, int splits, int chunk, int smem,
                             void* stream) {
  const ConvShape s = {N, C_I, C_O, H_O, W_O, K, stride, sxn, sxc, sxh, sxw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_plan<float>(x, w, out, s, config, splits, chunk, smem, st);
  if (dtype == 1)
    return launch_plan<__nv_bfloat16>(x, w, out, s, config, splits, chunk,
                                      smem, st);
  return (int)cudaErrorInvalidValue;
}
