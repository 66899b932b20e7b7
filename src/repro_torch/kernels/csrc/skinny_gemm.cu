// Skinny GEMM  A (m, b) @ X (b, F) -> (m, F)  for sm_90a, plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/mds_encode.py::skinny_gemm_pallas
// (body _gemm_kernel), which is every MDS/LT encode (eq. 3), every decode
// (eq. 4) and the worker-pool piece GEMM.
//
// Two regimes, one entry point:
//
//  * coding (m, b <= 16): memory-bound, (b + m) * F elements moved.  A sits
//    in shared memory as f32.  Each thread owns one 16-byte group of
//    neighbouring columns of F, reads its b inputs once into registers and
//    writes m outputs.  When F is not a multiple of the group (or a pointer
//    is not 16-byte aligned) rows are not aligned, and a scalar kernel with
//    one column per thread takes over; the ragged end is masked, never
//    padded.
//  * piece GEMM (anything larger): a shared-memory tiled GEMM, 64 x 64
//    output tile, depth 16, 4 x 4 outputs per thread.
//
// Numerics, all kernels: inputs are upcast to f32, every output element is
// acc = 0; for i = 0 .. b-1: acc = fmaf(A[r, i], X[i, c], acc); the result
// is rounded once to X's type.  No TF32, no tensor cores: decode matrices at
// k >= 12 carry entries of 1e4-1e5 and results are judged at f32 roundoff.
// Because the reduction order of one output element never depends on where
// the element sits in F, a decode tiled over column blocks is bit-identical
// to the one-shot decode.
//
// Kernels launch on the stream they are given, allocate nothing and do not
// synchronise.  The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMALL = 16;   // coding regime: m, b <= 16
constexpr int CODING_THREADS = 256;

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

// 16-byte groups: 4 f32 or 8 bf16.
template <typename T> struct Group;
template <> struct Group<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Group<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the upper half of an f32: widening is a shift, exactly
  __device__ static void unpack(const uint4& r, float (&f)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * j]));
      const uint32_t hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * j + 1]));
      w[j] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
__device__ __forceinline__ void stage_a(const T* __restrict__ A, float* sA,
                                        int m, int b) {
  for (int i = threadIdx.x; i < m * b; i += blockDim.x) sA[i] = to_f32(A[i]);
  __syncthreads();
}

// Coding regime, aligned rows: one 16-byte column group per thread.
template <typename T>
__global__ void __launch_bounds__(CODING_THREADS)
coding_gemm_vec(const T* __restrict__ A, const T* __restrict__ X,
                T* __restrict__ out, int m, int b, long long F) {
  constexpr int V = Group<T>::N;
  __shared__ float sA[MAX_SMALL * MAX_SMALL];
  stage_a(A, sA, m, b);
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= F / V) return;
  const long long col = g * V;
  uint4 raw[MAX_SMALL];
#pragma unroll
  for (int i = 0; i < MAX_SMALL; ++i)
    if (i < b)
      raw[i] = *reinterpret_cast<const uint4*>(X + (long long)i * F + col);
  for (int r = 0; r < m; ++r) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_SMALL; ++i) {
      if (i < b) {
        const float a = sA[r * b + i];
        float xs[V];
        Group<T>::unpack(raw[i], xs);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fmaf(a, xs[j], acc[j]);
      }
    }
    *reinterpret_cast<uint4*>(out + (long long)r * F + col) =
        Group<T>::pack(acc);
  }
}

// Coding regime, ragged or unaligned F: one column per thread, grid-stride.
template <typename T>
__global__ void __launch_bounds__(CODING_THREADS)
coding_gemm_scalar(const T* __restrict__ A, const T* __restrict__ X,
                   T* __restrict__ out, int m, int b, long long F) {
  __shared__ float sA[MAX_SMALL * MAX_SMALL];
  stage_a(A, sA, m, b);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       col < F; col += step) {
    float xs[MAX_SMALL];
#pragma unroll
    for (int i = 0; i < MAX_SMALL; ++i)
      if (i < b) xs[i] = to_f32(X[(long long)i * F + col]);
    for (int r = 0; r < m; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_SMALL; ++i)
        if (i < b) acc = fmaf(sA[r * b + i], xs[i], acc);
      out[(long long)r * F + col] = from_f32<T>(acc);
    }
  }
}

// Piece GEMM: C (M, N) = A (M, K) @ B (K, N), all row-major.
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);  // 256

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
tiled_gemm(const T* __restrict__ A, const T* __restrict__ B,
           T* __restrict__ C, int M, int N, int K) {
  // +4 keeps rows 16-byte aligned and spreads the transposed stores over banks
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / GEMM_THREADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      const int kk = e % BK, mm = e / BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] =
          (gm < M && gk < K) ? to_f32(A[(long long)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / GEMM_THREADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      const int nn = e % BN, kk = e / BN;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] =
          (gk < K && gn < N) ? to_f32(B[(long long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) C[(long long)gm * N + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* A, const void* X, void* out, int m, int b, long long F,
            cudaStream_t stream) {
  const T* a = static_cast<const T*>(A);
  const T* x = static_cast<const T*>(X);
  T* o = static_cast<T*>(out);
  if (m <= MAX_SMALL && b <= MAX_SMALL) {
    constexpr int V = Group<T>::N;
    const bool aligned = (F % V == 0) &&
                         (reinterpret_cast<uintptr_t>(X) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    if (aligned) {
      const long long groups = F / V;
      const unsigned blocks =
          (unsigned)((groups + CODING_THREADS - 1) / CODING_THREADS);
      coding_gemm_vec<T><<<blocks, CODING_THREADS, 0, stream>>>(a, x, o, m, b,
                                                                F);
    } else {
      long long blocks = (F + CODING_THREADS - 1) / CODING_THREADS;
      if (blocks > 65536) blocks = 65536;  // grid-stride covers the rest
      coding_gemm_scalar<T><<<(unsigned)blocks, CODING_THREADS, 0, stream>>>(
          a, x, o, m, b, F);
    }
  } else {
    const dim3 grid((unsigned)((F + BN - 1) / BN), (unsigned)((m + BM - 1) / BM));
    tiled_gemm<T><<<grid, GEMM_THREADS, 0, stream>>>(a, x, o, m, (int)F, b);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() (0 = launched).
extern "C" int skinny_gemm_launch(const void* A, const void* X, void* out,
                                  int m, int b, long long F, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(A, X, out, m, b, F, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(A, X, out, m, b, F, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
