// Pipelined, register-blocked SIMT GEMM mainloop for sm_90a, shared by the
// skinny GEMM's tiled regime (skinny_gemm.cu) and the direct convolution
// (conv2d.cu):  C (M, N) = A (M, K) @ B (K, N), f32 accumulation.
//
// A is row-major in device memory and is staged K-major (As[k][m]) so that
// the inner loop reads both operands as float4.  B is staged as it lies
// (Bs[k][n]); where it comes from is the caller's B loader: a dense
// row-major matrix for the GEMM, an on-the-fly patch gather for the conv.
//
// Pipeline: a ring of STAGES = 4 tiles of depth BK = 16 in dynamic shared
// memory.  For f32 inputs the loaders issue cp.async copies (16 bytes where
// the rows allow it, else 4 bytes with zero fill for masked elements), so
// the loads of tile t + 3 are in flight while tile t is multiplied, with
// one __syncthreads per tile.  bf16 inputs cannot be widened by cp.async:
// their loaders read the next tile into registers before the multiply and
// store it widened to f32 after it, one tile ahead.
//
// Register blocking: a thread owns TM x TN outputs (8 x 8 or 4 x 4) as
// (TM/4) x (TN/4) sub-tiles of 4 x 4 spread over the block tile, so every
// shared-memory read is a conflict-free float4 and feeds TM + TN operands
// to TM * TN FMAs.
//
// Numerics: every output element is one chain
//   acc = 0; for k ascending in [k_begin, k_end): acc = fmaf(A[m,k], B[k,n], acc)
// whatever the tile shape, so tile shapes may follow the problem without
// changing a bit.  A split of the contraction (the conv's cluster R-split)
// sums the chains of fixed ranges in ascending rank (split_reduce_store).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace sgemm {

namespace cg = cooperative_groups;

constexpr int BK = 16;      // depth of one pipeline stage
constexpr int STAGES = 4;   // ring depth
constexpr int APAD = 4;     // keeps As rows 16-byte aligned, spreads banks
constexpr int MAX_SPLIT = 8;  // the portable cluster size

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4-byte async copy; a masked element is filled with zero (src-size 0)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
// 16-byte async copy of `bytes` (0..16) valid bytes, the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A block tile of BM x BN outputs, TM x TN per thread.
template <int BM_, int BN_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int TY = BM / TM, TX = BN / TN;
  static constexpr int THREADS = TX * TY;
  static constexpr int AS = BM + APAD;  // row stride of the K-major A tile
  static constexpr int STAGE_FLOATS = BK * AS + BK * BN;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "4 x 4 sub-tiles");
  static_assert(THREADS % BN == 0, "each thread gathers one fixed column");
  static_assert(STAGES * STAGE_FLOATS >= BM * BN,
                "the ring holds a partial tile for the split reduction");
  // row of sub-tile s, element i of this thread; column likewise
  __device__ static int row(int ty, int s, int i) {
    return s * (4 * TY) + ty * 4 + i;
  }
  __device__ static int col(int tx, int s, int j) {
    return s * (4 * TX) + tx * 4 + j;
  }
};

// A (M, K) row-major, rows [m0, m0 + BM) of the block, staged K-major.
template <typename T, class Tl>
struct RowMajorA {
  static constexpr int PER = Tl::BM * BK / Tl::THREADS;
  const T* A;
  int M, lda, m0;
  float reg[PER];  // bf16: the tile in flight

  __device__ void fetch(float* As, int k0, int k_end) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * Tl::THREADS;
      const int kk = e % BK, mm = e / BK;
      const int gm = m0 + mm, gk = k0 + kk;
      const bool ok = gm < M && gk < k_end;
      if constexpr (sizeof(T) == 4) {
        cp_async4(&As[kk * Tl::AS + mm],
                  reinterpret_cast<const float*>(ok ? A + (long long)gm * lda + gk
                                                    : A),
                  ok);
      } else {
        reg[i] = ok ? to_f32(A[(long long)gm * lda + gk]) : 0.f;
      }
    }
  }
  __device__ void store(float* As) {
    if constexpr (sizeof(T) != 4) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = threadIdx.x + i * Tl::THREADS;
        As[(e % BK) * Tl::AS + e / BK] = reg[i];
      }
    }
  }
};

// The mainloop: acc += A[:, k_begin:k_end] @ B[k_begin:k_end, :] for the
// block's tile, ascending k.  `smem` is the ring (Tl::SMEM_BYTES).
template <class Tl, class LA, class LB>
__device__ __forceinline__ void mainloop(float* smem, LA& la, LB& lb,
                                         int k_begin, int k_end,
                                         float (&acc)[Tl::TM][Tl::TN]) {
  const int tx = threadIdx.x % Tl::TX, ty = threadIdx.x / Tl::TX;
  const int nk = (k_end - k_begin + BK - 1) / BK;
  auto As = [&](int s) { return smem + s * Tl::STAGE_FLOATS; };
  auto Bs = [&](int s) { return smem + s * Tl::STAGE_FLOATS + BK * Tl::AS; };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      la.fetch(As(s), k_begin + s * BK, k_end);
      lb.fetch(Bs(s), k_begin + s * BK, k_end);
      la.store(As(s));
      lb.store(Bs(s));
    }
    cp_commit();  // one group per stage, empty or not: the count stays fixed
  }
  for (int t = 0; t < nk; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile t is in; the slot of tile t - 1 is free
    const int tn = t + STAGES - 1;
    const int slot = tn % STAGES;
    const bool more = tn < nk;
    if (more) {
      la.fetch(As(slot), k_begin + tn * BK, k_end);
      lb.fetch(Bs(slot), k_begin + tn * BK, k_end);
    }
    cp_commit();
    const float* a_s = As(t % STAGES);
    const float* b_s = Bs(t % STAGES);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[Tl::TM], b[Tl::TN];
#pragma unroll
      for (int s = 0; s < Tl::TM / 4; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(
            &a_s[kk * Tl::AS + Tl::row(ty, s, 0)]);
        a[4 * s] = v.x; a[4 * s + 1] = v.y; a[4 * s + 2] = v.z;
        a[4 * s + 3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < Tl::TN / 4; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(
            &b_s[kk * Tl::BN + Tl::col(tx, s, 0)]);
        b[4 * s] = v.x; b[4 * s + 1] = v.y; b[4 * s + 2] = v.z;
        b[4 * s + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < Tl::TM; ++i)
#pragma unroll
        for (int j = 0; j < Tl::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {  // bf16: widen the next tile into its slot
      la.store(As(slot));
      lb.store(Bs(slot));
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring may now be reused
}

// Hand each output of the tile to store(r, c, v) (local row and column).
// splits == 1: straight from the registers.  splits > 1: the block is rank
// `rank` of a (splits, 1, 1) cluster whose ranks hold the partial chains of
// ascending contraction ranges; every partial tile goes to its block's
// shared memory and each element is summed over the ranks in ascending
// order through distributed shared memory, ((p0 + p1) + p2) + ..., whatever
// rank does the sum.  Every block of the cluster must call this.
template <class Tl, class Store>
__device__ __forceinline__ void split_reduce_store(
    float* smem, const float (&acc)[Tl::TM][Tl::TN], int splits,
    Store& store) {
  const int tx = threadIdx.x % Tl::TX, ty = threadIdx.x / Tl::TX;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < Tl::TM; ++i)
#pragma unroll
      for (int j = 0; j < Tl::TN; ++j)
        store(Tl::row(ty, i / 4, i % 4), Tl::col(tx, j / 4, j % 4), acc[i][j]);
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
#pragma unroll
  for (int i = 0; i < Tl::TM; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TN; ++j)
      smem[Tl::row(ty, i / 4, i % 4) * Tl::BN + Tl::col(tx, j / 4, j % 4)] =
          acc[i][j];
  cl.sync();
  const int rank = (int)cl.block_rank();
  for (int e = rank * Tl::THREADS + threadIdx.x; e < Tl::BM * Tl::BN;
       e += splits * Tl::THREADS) {
    float v = cl.map_shared_rank(smem, 0)[e];
    for (int q = 1; q < splits; ++q) v += cl.map_shared_rank(smem, q)[e];
    store(e / Tl::BN, e % Tl::BN, v);
  }
  cl.sync();  // no block leaves while another still reads its partials
}

// The tile shapes both kernels may be given, by the index the Python launch
// plans use (kernels/_tiles.py::TILES mirrors this table).
#define SGEMM_FOR_EACH_TILE(X) \
  X(0, 128, 128, 8, 8)         \
  X(1, 128, 64, 8, 8)          \
  X(2, 64, 64, 4, 4)           \
  X(3, 32, 32, 4, 4)

// Launch `kernel` with a (splits, 1, 1) cluster and `smem` dynamic bytes,
// opting in above 48 KB.  Returns the launch's error.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int threads,
                           int smem, int splits, cudaStream_t stream,
                           Args&&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

}  // namespace sgemm
