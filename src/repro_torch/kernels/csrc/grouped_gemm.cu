// Grouped GEMM over the experts a mixture-of-experts layer holds, for
// sm_90a, plain C interface.
//
//   out[dst[r]] = scale[r] * (x[rows[r]] @ w[g])   offsets[g] <= r < offsets[g + 1]
//
// Replaces no TPU kernel: the JAX package's mixture of experts
// (src/repro/models/model.py::_moe_ffn) drops the slots past a capacity and
// runs the experts as batched GEMMs of that capacity.  This kernel serves
// the port's dropless layer (models/moe.py), whose experts see as many rows
// as the router sends them.  `rows` gathers the source rows (each sorted
// slot's token), `dst` scatters the results (back to slot order), `scale`
// weighs each row (its gate); each may be null.  Rows at or past
// offsets[G] (the slots of experts held elsewhere) are neither read nor
// written.
//
// What bounds it on an H100: at a prefill's row counts the bf16 tensor-core
// rate (a 128-row block against a 4096 x 768 weight slab does ~100 flops a
// byte); at a decode step's few rows the bytes of the weights of the
// experts that got rows.  The design:
//
//  * The grid is sized from what the host knows: cdiv(R, BM) + G row blocks
//    (each expert adds at most one ragged block) by cdiv(N, BN) column
//    blocks.  A block walks the G offsets on the card to find its expert
//    and its rows; blocks past the last expert's, and experts with no rows,
//    return at once.  No size leaves the card and nothing is padded to a
//    capacity.
//  * A 3-stage cp.async ring of (BM x 32) row tiles, gathered row by row as
//    they are copied (16 bytes a copy, rows past the group zero-filled), and
//    (32 x 128) weight tiles; both padded by 8 elements a row so that the
//    ldmatrix reads below meet no bank conflict.
//  * 8 warps as 2 x 4, a warp (BM / 2) x 32 outputs, each m16n8k16 bf16
//    mma.sync with an f32 accumulator; A fragments by ldmatrix.x4, B
//    fragments by ldmatrix.x4.trans from the row-major (K x N) tile.
//  * The epilogue scales each row in f32, rounds once to bf16 and stores
//    two neighbouring columns a thread at the row's destination.
//  * `done` (may be null): the blocks of column block 0 add the rows they
//    cover, so the caller can hold the rows written to offsets[G].
//
// Not yet a Hopper-only design (wgmma fed by TMA from a producer warp):
// mma.sync reaches a part of the card's bf16 rate; PERF.md keeps the
// kernel's share of its roofline.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_mainloop.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int PAD = 8;
constexpr int AS = BK + PAD;  // elements a row of the A tile
constexpr int BS = BN + PAD;  // elements a row of the B tile

template <int BM>
struct Plan {
  static constexpr int A_ELEMS = BM * AS;
  static constexpr int B_ELEMS = BK * BS;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int SMEM = STAGES * STAGE * 2;  // bytes
  static constexpr int A_COPIES = BM * BK / 8 / THREADS;  // 16 B a copy
  static constexpr int B_COPIES = BK * BN / 8 / THREADS;
  static constexpr int WM = BM / 2;   // rows a warp
  static constexpr int MT = WM / 16;  // m16 tiles a warp
  static constexpr int NT = 4;        // n8 tiles a warp (32 columns)
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sgemm::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sgemm::smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void copy16(bf16* dst, const bf16* src,
                                       bool valid) {
  sgemm::cp_async16(reinterpret_cast<float*>(dst),
                    reinterpret_cast<const float*>(src), valid ? 16 : 0);
}

template <int BM>
__global__ void __launch_bounds__(THREADS) expert_grouped_gemm(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    bf16* __restrict__ out, const int* __restrict__ rows,
    const int* __restrict__ offsets, const float* __restrict__ scale,
    const int* __restrict__ dst, unsigned long long* done, int N, int K,
    int G, long long ldx, long long ldo) {
  using P = Plan<BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  // this block's expert and rows: walk the offsets, counting each expert's
  // row blocks (every thread reads the same few words)
  const int pid = blockIdx.x;
  int first = 0, grp = -1, lo = 0, hi = 0;
  for (int g = 0; g < G; ++g) {
    const int g_lo = offsets[g], g_hi = offsets[g + 1];
    const int nt = g_hi > g_lo ? (g_hi - g_lo + BM - 1) / BM : 0;
    if (pid < first + nt) {
      grp = g;
      lo = g_lo + (pid - first) * BM;
      hi = g_hi;
      break;
    }
    first += nt;
  }
  if (grp < 0) return;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  if (done != nullptr && blockIdx.y == 0 && tid == 0)
    atomicAdd(done, (unsigned long long)min(BM, hi - lo));

  // each thread's copies: A_COPIES source rows, B_COPIES weight chunks
  const bf16* a_src[P::A_COPIES];
  bool a_ok[P::A_COPIES];
  int a_dst[P::A_COPIES];
#pragma unroll
  for (int i = 0; i < P::A_COPIES; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    const int sr = lo + r;
    a_ok[i] = sr < hi;
    const long long src_row =
        a_ok[i] ? (rows != nullptr ? (long long)rows[sr] : (long long)sr) : 0;
    a_src[i] = x + src_row * ldx + kc;
    a_dst[i] = r * AS + kc;
  }
  const bf16* wg = w + (long long)grp * K * N;
  const bf16* b_src[P::B_COPIES];
  bool b_ok[P::B_COPIES];
  int b_dst[P::B_COPIES];
#pragma unroll
  for (int i = 0; i < P::B_COPIES; ++i) {
    const int c = tid + i * THREADS;
    const int kr = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    b_ok[i] = n0 + nc < N;
    b_src[i] = wg + (long long)kr * N + (b_ok[i] ? n0 + nc : 0);
    b_dst[i] = kr * BS + nc;
  }

  auto load = [&](int stage, int kt) {
    bf16* As = smem + stage * P::STAGE;
    bf16* Bs = As + P::A_ELEMS;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < P::A_COPIES; ++i)
      copy16(As + a_dst[i], a_src[i] + k0, a_ok[i]);
#pragma unroll
    for (int i = 0; i < P::B_COPIES; ++i)
      copy16(Bs + b_dst[i], b_src[i] + (long long)k0 * N, b_ok[i]);
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[P::MT][P::NT][4];
#pragma unroll
  for (int i = 0; i < P::MT; ++i)
#pragma unroll
    for (int j = 0; j < P::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    sgemm::cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    sgemm::cp_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, nk);
    sgemm::cp_commit();
    const bf16* As = smem + (kt % STAGES) * P::STAGE;
    const bf16* Bs = As + P::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[P::MT][4];
#pragma unroll
      for (int i = 0; i < P::MT; ++i)
        ldsm_x4(a[i], As + (wm * P::WM + i * 16 + (lane & 15)) * AS + kk +
                          (lane >> 4) * 8);
      uint32_t b[P::NT / 2][4];
#pragma unroll
      for (int j = 0; j < P::NT / 2; ++j)
        ldsm_x4_t(b[j], Bs + (kk + (lane & 15)) * BS + wn * 32 + j * 16 +
                            (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < P::MT; ++i)
#pragma unroll
        for (int j = 0; j < P::NT; ++j)
          mma_bf16(acc[i][j], a[i], b[j / 2][(j & 1) * 2],
                   b[j / 2][(j & 1) * 2 + 1]);
    }
  }
  sgemm::cp_wait<0>();

  // epilogue: thread (g, t) of a warp holds rows g and g + 8 of each m16
  // tile, columns 2t and 2t + 1 of each n8 tile
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < P::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lo + wm * P::WM + i * 16 + g8 + h * 8;
      if (r >= hi) continue;
      const float s = scale != nullptr ? scale[r] : 1.f;
      const long long d = dst != nullptr ? (long long)dst[r] : (long long)r;
      bf16* orow = out + d * ldo;
#pragma unroll
      for (int j = 0; j < P::NT; ++j) {
        const int col = n0 + wn * 32 + j * 8 + t4 * 2;
        if (col >= N) continue;
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(acc[i][j][h * 2] * s);
        v.y = __float2bfloat16_rn(acc[i][j][h * 2 + 1] * s);
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = v;
      }
    }
  }
}

template <int BM>
int launch(const void* x, const void* w, void* out, const void* rows,
           const void* offsets, const void* scale, const void* dst,
           void* done, int N, int K, int G, long long ldx, long long ldo,
           int grid_m, cudaStream_t stream) {
  auto kernel = expert_grouped_gemm<BM>;
  const int smem = Plan<BM>::SMEM;
  static bool opted = false;  // one opt-in a variant, above 48 KB
  if (!opted && smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const dim3 grid(grid_m, (N + BN - 1) / BN, 1);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), static_cast<const int*>(rows),
      static_cast<const int*>(offsets), static_cast<const float*>(scale),
      static_cast<const int*>(dst), static_cast<unsigned long long*>(done), N,
      K, G, ldx, ldo);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (row block, row blocks) comes from
// kernels/grouped_gemm.py::gemm_plan; a shape this file cannot take returns
// cudaErrorInvalidValue: K a multiple of 32, N of 8, the row strides of 8
// elements (16-byte copies and 4-byte stores).
extern "C" int grouped_gemm_launch(const void* x, const void* w, void* out,
                                   const void* rows, const void* offsets,
                                   const void* scale, const void* dst,
                                   void* done, int N, int K, int G,
                                   long long ldx, long long ldo, int bm,
                                   int grid_m, void* stream) {
  if (K % BK || N % 8 || ldx % 8 || ldo % 8 || G < 1 || grid_m < 1 ||
      grid_m >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return launch<128>(x, w, out, rows, offsets, scale, dst, done, N, K, G,
                       ldx, ldo, grid_m, s);
  if (bm == 64)
    return launch<64>(x, w, out, rows, offsets, scale, dst, done, N, K, G,
                      ldx, ldo, grid_m, s);
  return (int)cudaErrorInvalidValue;
}
