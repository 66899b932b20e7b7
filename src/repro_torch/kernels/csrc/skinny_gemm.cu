// Skinny GEMM  A (m, b) @ X (b, F) -> (m, F)  for sm_90a, plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/mds_encode.py::skinny_gemm_pallas
// (body _gemm_kernel), which is every MDS/LT encode (eq. 3), every decode
// (eq. 4) and the worker-pool piece GEMM.
//
// Three regimes, one entry point.  The launch plan (regime, tile, split,
// shared memory) is made in Python (kernels/skinny_gemm.py::piece_plan) and
// checked here: a plan this file cannot take returns cudaErrorInvalidValue.
//
//  * coding (m, b <= 16: every MDS/LT encode and decode): bound by bytes.
//    (b + m) * F elements move and each output takes at most 16 multiply-
//    adds, far below the card's f32 ridge point, so tensor cores would buy
//    nothing.  A sits in shared memory as f32.  Two variants, chosen by
//    kernels/skinny_gemm.py::coding_plan:
//    - narrow (X and the output 16-byte aligned, F a multiple of the 16-
//      byte group: every served model's encode and decode): one group of
//      neighbouring columns a thread in blocks of 128, X's b loads issued
//      before A is staged, then m 16-byte stores.  Many small blocks keep
//      the most bytes in flight: on an H100 it moves its bytes within 4%
//      of the time a device copy of as many bytes takes once F reaches a
//      few 1e5, and it beat a persistent ring of bulk copies (TMA) at every
//      aligned F measured, 2048 to 5.6M (PERF.md).
//    - scalar (an unaligned pointer or a ragged F, whose rows start off
//      16-byte boundaries): one column per thread, grid-stride; the ragged
//      end is masked, never padded.
//    Both compute each output as one fmaf chain from 0 over i = 0 .. b - 1,
//    so they give the same bits, and the bits the coding regime always
//    gave.
//  * GEMV (m <= 16 < b: the decode-step pieces, t_p = 1 at B = 8): bound by
//    bytes, the b x F weight is read once.  A block owns a slab of 32
//    column groups (128 f32 / 256 bf16 columns); its 256 threads are 32
//    groups x 8 contraction lanes, so each warp reads 512 contiguous bytes
//    of one row, and each thread keeps MR x 4 (f32) or MR x 8 (bf16)
//    accumulators (MR: m rounded up to a power of two).  The contraction
//    is split over the 8 lanes of a block (lane l takes rows l, l + 8, ...)
//    and over the `splits` blocks of a thread-block cluster (ascending
//    ranges of `chunk` rows).  Loads: an unrolled run of 16
//    ld.global.nc.v4 per thread (8 where MR x V > 32) for a tile of rows,
//    issued before the tile's rows of A are staged in shared memory, so the
//    two overlap.  Not a cp.async/TMA ring: each byte of the weight is used
//    once, so staging it in shared memory would only add a copy, and 128
//    blocks x 256 threads x 16 x 16 bytes keep 8 MB in flight.  (Of 8, 16
//    and 32 groups a block, 32 was the fastest at both Zamba2 decode shapes
//    on an H100.)  Partials are summed in a fixed order: the lanes through
//    shared memory (lane 0, 1, ..., 7), then the cluster ranks through
//    distributed shared memory in ascending rank.  One
//    launch, no scratch buffer.
//  * tiled (m > 16: prefill pieces): bound by the f32 FMA rate.  The
//    pipelined, register-blocked mainloop of sgemm_mainloop.cuh (4-stage
//    cp.async ring, 8 x 8 or 4 x 4 outputs per thread, A staged K-major),
//    no split: every output is one ascending-k fmaf chain, so the tile may
//    follow the shape.
//
// Stacked pieces (kernels/skinny_gemm.py::piece_gemm_stacked): the n coded
// pieces of one run, (n * t_p, b) rows of A against one X, in one launch.
// The regime is the one piece's (by t_p, not by n * t_p), and the coding and
// GEMV regimes take a row-group grid axis (grid.y; the cluster stays on x):
// group y holds rows y * R .. y * R + R - 1 (R = 16 coding, MR GEMV), so
// the weight is read once per group instead of once per piece.  A row's
// reduction order depends on the regime and b only (the GEMV lane l sums
// k = l, l + 8, ... ascending whatever MR and the staging tile, then lanes
// and ranks in ascending order), so every output has the bits of its piece
// launched alone.  The tiled regime takes the stack as one (n * t_p)-row
// product: each output is one ascending fmaf chain whatever the tile.
//
// Tensor cores stay out: TF32 breaks the numerics below; TF32 wgmma wants
// a K-major B, and X (the weight) is (d_in, d_out); a 3xTF32 or bf16 wgmma
// design is its own piece of work.
//
// Numerics, all regimes: inputs are upcast to f32, products are plain fmaf,
// the result is rounded once to X's type.  Decode matrices at k >= 12 carry
// entries of 1e4-1e5 and results are judged at f32 roundoff.  The
// reduction order of one output element depends on the regime (so on m)
// and on b only, never on F or on where the element sits, so a GEMM tiled
// over column blocks is bit-identical to the one-shot GEMM.
//
// Kernels launch on the stream they are given, allocate nothing and do not
// synchronise.  The entry point returns the launch's error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_mainloop.cuh"

namespace {

constexpr int MAX_SMALL = 16;   // coding regime: m, b <= 16
constexpr int NARROW_THREADS = 128;  // coding variants' blocks
constexpr int SCALAR_THREADS = 256;

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

// Row group blockIdx.y of R rows: A and out advance to its first row, m
// becomes its row count.  One group (grid.y = 1) leaves all three as given.
#define ROW_GROUP(R)                          \
  do {                                        \
    const int r0_ = (int)blockIdx.y * (R);    \
    A += (long long)r0_ * b;                  \
    out += (long long)r0_ * F;                \
    m = min((R), m - r0_);                    \
  } while (0)

// Coding, `narrow` (X and the output 16-byte aligned, F % V == 0: every
// encode and decode of the served models): one 16-byte column group a
// thread, blocks of NARROW_THREADS.  X's b loads are issued before A is
// staged, so the staging overlaps them; nothing else stands between the
// loads and the stores.  Output row r is one fmaf chain from 0 over i = 0,
// 1, ..., b - 1, the order of coding_gemm_scalar too, so both variants give
// the same bits.
template <typename T>
__global__ void __launch_bounds__(NARROW_THREADS)
coding_gemm_narrow(const T* __restrict__ A, const T* __restrict__ X,
                   T* __restrict__ out, int m, int b, long long F) {
  constexpr int V = Group<T>::N;
  __shared__ float sA[MAX_SMALL * MAX_SMALL];
  ROW_GROUP(MAX_SMALL);
  const long long col =
      ((long long)blockIdx.x * NARROW_THREADS + threadIdx.x) * V;
  const bool live = col < F;
  uint4 raw[MAX_SMALL];
#pragma unroll
  for (int i = 0; i < MAX_SMALL; ++i)
    if (i < b && live)
      raw[i] = __ldg(reinterpret_cast<const uint4*>(X + (long long)i * F +
                                                    col));
  stage_a(A, sA, m, b);
  if (!live) return;
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

// Coding, `scalar` (an X or output pointer that is not 16-byte aligned, or
// a ragged F): one column per thread, grid-stride.
template <typename T>
__global__ void __launch_bounds__(SCALAR_THREADS)
coding_gemm_scalar(const T* __restrict__ A, const T* __restrict__ X,
                   T* __restrict__ out, int m, int b, long long F) {
  __shared__ float sA[MAX_SMALL * MAX_SMALL];
  ROW_GROUP(MAX_SMALL);
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


// GEMV regime: m <= 16 < b.  Block = one column slab x one cluster rank.
constexpr int GEMV_THREADS = 256;
constexpr int GEMV_GROUPS = 32;  // 16-byte column groups per block: one warp
constexpr int GEMV_LANES = GEMV_THREADS / GEMV_GROUPS;  // contraction lanes

// GROUPED: row groups on grid.y (a stack of more than MR rows).  One group
// takes the plain kernel: the offset arithmetic alone slowed the MR = 8 and
// 16 GEMV by 5-22% on an H100.
template <typename T, int MR, bool VEC, bool GROUPED>
__global__ void __launch_bounds__(GEMV_THREADS)
piece_gemv_splitk(const T* __restrict__ A, const T* __restrict__ X,
                  T* __restrict__ out, int m, int b, long long F, int chunk) {
  constexpr int V = Group<T>::N;
  constexpr int W = GEMV_GROUPS * V;  // columns per block
  // loads in flight per thread (fewer where the accumulators crowd them)
  constexpr int U = MR * V <= 32 ? 16 : 8;
  constexpr int TK = GEMV_LANES * U;  // rows of A staged per tile
  __shared__ float sA[MR][TK];
  __shared__ float red[GEMV_LANES][W];
  __shared__ float part[MR][W];
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  if constexpr (GROUPED) ROW_GROUP(MR);
  const int splits = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int g = tid % GEMV_GROUPS, l = tid / GEMV_GROUPS;
  const long long slab0 = (long long)(blockIdx.x / splits) * W;
  const long long col = slab0 + g * V;
  const int k0 = rank * chunk;
  const int k1 = min(b, k0 + chunk);

  float acc[MR][V];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;

  for (int t0 = k0; t0 < k1; t0 += TK) {
    // this thread's U rows of the tile: t0 + l, t0 + l + LANES, ...  The
    // loads are issued first, so A's staging below overlaps them.
    float xs[U][V];
    uint4 raw[VEC ? U : 1];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = t0 + l + GEMV_LANES * u;
      if constexpr (VEC) {
        raw[u] = (k < k1 && col < F)
                     ? __ldg(reinterpret_cast<const uint4*>(
                           X + (long long)k * F + col))
                     : make_uint4(0u, 0u, 0u, 0u);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          xs[u][v] = (k < k1 && col + v < F)
                         ? to_f32(X[(long long)k * F + col + v])
                         : 0.f;
      }
    }
    __syncthreads();  // the previous tile of A is consumed
    for (int i = tid; i < MR * TK; i += GEMV_THREADS) {
      const int r = i / TK, kk = i % TK, k = t0 + kk;
      sA[r][kk] = (r < m && k < k1) ? to_f32(A[(long long)r * b + k]) : 0.f;
    }
    __syncthreads();
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < U; ++u) Group<T>::unpack(raw[u], xs[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = l + GEMV_LANES * u;
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float a = sA[r][kk];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(a, xs[u][v], acc[r][v]);
      }
    }
  }

  // lanes, in ascending order, one row of A at a time
#pragma unroll
  for (int r = 0; r < MR; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) red[l][g * V + v] = acc[r][v];
    __syncthreads();
    if (tid < W) {
      float s = red[0][tid];
#pragma unroll
      for (int q = 1; q < GEMV_LANES; ++q) s += red[q][tid];
      part[r][tid] = s;
    }
    __syncthreads();
  }
  // cluster ranks, in ascending order, through distributed shared memory
  cl.sync();
  for (int e = rank * GEMV_THREADS + tid; e < MR * W;
       e += splits * GEMV_THREADS) {
    const int r = e / W;
    const long long c = slab0 + e % W;
    if (r < m && c < F) {
      float s = cl.map_shared_rank(&part[0][0], 0)[e];
      for (int q = 1; q < splits; ++q)
        s += cl.map_shared_rank(&part[0][0], q)[e];
      out[(long long)r * F + c] = from_f32<T>(s);
    }
  }
  cl.sync();  // no block leaves while another still reads its partials
}

// Tiled regime: B is X (K, N) row-major.  VEC: f32, N % 4 == 0 and X
// 16-byte aligned, so rows are copied as 16-byte groups.
template <typename T, class Tl, bool VEC>
struct DenseB {
  static constexpr int PER = Tl::BN * sgemm::BK / Tl::THREADS;
  static constexpr int PER4 = PER / 4;
  const T* B;
  int N, n0;
  float reg[PER];  // bf16: the tile in flight

  __device__ void fetch(float* Bs, int k0, int k_end) {
    if constexpr (sizeof(T) == 4 && VEC) {
#pragma unroll
      for (int i = 0; i < PER4; ++i) {
        const int e = threadIdx.x + i * Tl::THREADS;
        const int kk = e / (Tl::BN / 4), c = (e % (Tl::BN / 4)) * 4;
        const int n = n0 + c, gk = k0 + kk;
        const int bytes = (gk < k_end && n < N) ? min(16, (N - n) * 4) : 0;
        sgemm::cp_async16(&Bs[kk * Tl::BN + c],
                          reinterpret_cast<const float*>(
                              bytes ? B + (long long)gk * N + n : B),
                          bytes);
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = threadIdx.x + i * Tl::THREADS;
        const int kk = e / Tl::BN, c = e % Tl::BN;
        const int n = n0 + c, gk = k0 + kk;
        const bool ok = gk < k_end && n < N;
        if constexpr (sizeof(T) == 4) {
          sgemm::cp_async4(&Bs[kk * Tl::BN + c],
                           reinterpret_cast<const float*>(
                               ok ? B + (long long)gk * N + n : B),
                           ok);
        } else {
          reg[i] = ok ? to_f32(B[(long long)gk * N + n]) : 0.f;
        }
      }
    }
  }
  __device__ void store(float* Bs) {
    if constexpr (sizeof(T) != 4) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = threadIdx.x + i * Tl::THREADS;
        Bs[(e / Tl::BN) * Tl::BN + e % Tl::BN] = reg[i];
      }
    }
  }
};

template <typename T, class Tl, bool VEC>
__global__ void __launch_bounds__(Tl::THREADS)
piece_gemm_tiled(const T* __restrict__ A, const T* __restrict__ X,
                 T* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * Tl::BM, n0 = blockIdx.x * Tl::BN;
  sgemm::RowMajorA<T, Tl> la{A, M, K, m0};
  DenseB<T, Tl, VEC> lb{X, N, n0};
  float acc[Tl::TM][Tl::TN];
#pragma unroll
  for (int i = 0; i < Tl::TM; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TN; ++j) acc[i][j] = 0.f;
  sgemm::mainloop<Tl>(smem, la, lb, 0, K, acc);
  auto store = [&](int r, int c, float v) {
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) C[(long long)gm * N + gn] = from_f32<T>(v);
  };
  sgemm::split_reduce_store<Tl>(smem, acc, 1, store);
}

enum Regime { CODING = 0, GEMV = 1, TILED = 2 };

int regime_of(int m, int b) {
  if (m <= MAX_SMALL && b <= MAX_SMALL) return CODING;
  return m <= MAX_SMALL ? GEMV : TILED;
}

enum CodingVariant { NARROW = 0, SCALAR = 1 };  // _tiles.CODING_VARIANTS

// The coding plan (kernels/skinny_gemm.py::coding_plan): variant, threads,
// grid.x.  narrow needs whole 16-byte rows and aligned X and output.
template <typename T>
int launch_coding(const T* a, const T* x, T* o, int m, int b, long long F,
                  int variant, int threads, long long grid_x, int groups,
                  cudaStream_t stream) {
  constexpr int V = Group<T>::N;
  const dim3 grid((unsigned)grid_x, groups);
  if (variant == NARROW) {
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(o) % 16 == 0;
    const long long G = F / V;  // 16-byte column groups of a row
    if (!aligned || F % V != 0 || threads != NARROW_THREADS ||
        grid_x != (G + threads - 1) / threads)
      return (int)cudaErrorInvalidValue;
    coding_gemm_narrow<T><<<grid, threads, 0, stream>>>(a, x, o, m, b, F);
    return (int)cudaGetLastError();
  }
  // grid-stride: at most 65536 blocks
  const long long blocks = (F + SCALAR_THREADS - 1) / SCALAR_THREADS;
  if (variant != SCALAR || threads != SCALAR_THREADS ||
      grid_x != (blocks < 65536 ? blocks : 65536))
    return (int)cudaErrorInvalidValue;
  coding_gemm_scalar<T><<<grid, SCALAR_THREADS, 0, stream>>>(a, x, o, m, b,
                                                             F);
  return (int)cudaGetLastError();
}

template <typename T, int MR>
int launch_gemv(const T* a, const T* x, T* o, int m, int b, long long F,
                int splits, int chunk, int groups, int threads,
                long long grid_x, cudaStream_t stream) {
  constexpr int W = GEMV_GROUPS * Group<T>::N;
  const long long slabs = (F + W - 1) / W;
  if (m > MR * groups || m <= MR * (groups - 1) ||
      slabs * splits > 0x7fffffffLL || threads != GEMV_THREADS ||
      grid_x != slabs * splits)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(slabs * splits), groups);
  const bool vec = F % Group<T>::N == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  void (*kernel)(const T*, const T*, T*, int, int, long long, int) =
      groups > 1 ? (vec ? &piece_gemv_splitk<T, MR, true, true>
                        : &piece_gemv_splitk<T, MR, false, true>)
                 : (vec ? &piece_gemv_splitk<T, MR, true, false>
                        : &piece_gemv_splitk<T, MR, false, false>);
  return (int)sgemm::launch_cluster(kernel, grid, GEMV_THREADS, 0, splits,
                                    stream, a, x, o, m, b, F, chunk);
}

template <typename T, class Tl>
int launch_tiled(const T* a, const T* x, T* o, int m, int b, long long F,
                 int smem, int threads, long long grid_x,
                 cudaStream_t stream) {
  if (smem != Tl::SMEM_BYTES || threads != Tl::THREADS ||
      grid_x != (F + Tl::BN - 1) / Tl::BN)
    return (int)cudaErrorInvalidValue;
  const long long gy = (m + Tl::BM - 1) / Tl::BM;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((F + Tl::BN - 1) / Tl::BN), (unsigned)gy);
  const bool vec = sizeof(T) == 4 && F % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  void (*kernel)(const T*, const T*, T*, int, int, int) =
      vec ? &piece_gemm_tiled<T, Tl, true> : &piece_gemm_tiled<T, Tl, false>;
  return (int)sgemm::launch_cluster(kernel, grid, Tl::THREADS, smem, 1,
                                    stream, a, x, o, m, (int)F, b);
}

template <typename T>
int launch(const void* A, const void* X, void* out, int m, int b, long long F,
           int regime, int config, int splits, int chunk, int smem, int groups,
           int threads, long long grid_x, cudaStream_t stream) {
  const T* a = static_cast<const T*>(A);
  const T* x = static_cast<const T*>(X);
  T* o = static_cast<T*>(out);
  // the rows of one group decide the regime (a group is one piece's rows,
  // or up to 16 stacked rows of pieces in the same regime)
  const int group_rows = (m + groups - 1) / max(groups, 1);
  if (m < 1 || b < 1 || F < 1 || F >= 0x7fffffffLL || groups < 1 ||
      groups > 65535 || regime != regime_of(group_rows, b))
    return (int)cudaErrorInvalidValue;
  if (regime == CODING) {
    if (splits != 1 || chunk != b || smem != 0 || m > MAX_SMALL * groups ||
        m <= MAX_SMALL * (groups - 1))
      return (int)cudaErrorInvalidValue;
    return launch_coding<T>(a, x, o, m, b, F, config, threads, grid_x, groups,
                            stream);
  }
  if (regime == GEMV) {
    // the splits are `splits` ascending ranges of `chunk` rows, none empty
    if (splits < 1 || splits > sgemm::MAX_SPLIT || chunk < 1 || smem != 0 ||
        (long long)(splits - 1) * chunk >= b ||
        (long long)splits * chunk < b)
      return (int)cudaErrorInvalidValue;
    switch (config) {  // MR = 2^config rows of A
      case 0: return launch_gemv<T, 1>(a, x, o, m, b, F, splits, chunk, groups, threads, grid_x, stream);
      case 1: return launch_gemv<T, 2>(a, x, o, m, b, F, splits, chunk, groups, threads, grid_x, stream);
      case 2: return launch_gemv<T, 4>(a, x, o, m, b, F, splits, chunk, groups, threads, grid_x, stream);
      case 3: return launch_gemv<T, 8>(a, x, o, m, b, F, splits, chunk, groups, threads, grid_x, stream);
      case 4: return launch_gemv<T, 16>(a, x, o, m, b, F, splits, chunk, groups, threads, grid_x, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (splits != 1 || chunk != b || groups != 1)
    return (int)cudaErrorInvalidValue;
  switch (config) {
#define TILE_CASE(ID, BM, BN, TM, TN) \
  case ID:                            \
    return launch_tiled<T, sgemm::Tile<BM, BN, TM, TN>>(a, x, o, m, b, F, smem, threads, grid_x, stream);
    SGEMM_FOR_EACH_TILE(TILE_CASE)
#undef TILE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  regime: 0 coding, 1 GEMV, 2 tiled;
// config: coding the variant (0 narrow, 1 scalar), GEMV log2(MR), tiled
// the tile index of SGEMM_FOR_EACH_TILE; splits / chunk: the contraction
// split; smem: dynamic shared bytes; groups: row groups of the coding and
// GEMV regimes (grid.y; 1 for one piece, and always 1 for tiled); threads
// and grid_x: the block and grid.x the plan expects.  m is every row of A,
// all groups.  Returns the launch's error (0 = launched),
// cudaErrorInvalidValue for a plan this file cannot take.
extern "C" int skinny_gemm_launch(const void* A, const void* X, void* out,
                                  int m, int b, long long F, int dtype,
                                  int regime, int config, int splits,
                                  int chunk, int smem, int groups,
                                  int threads, long long grid_x,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(A, X, out, m, b, F, regime, config, splits, chunk,
                         smem, groups, threads, grid_x, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(A, X, out, m, b, F, regime, config, splits,
                                 chunk, smem, groups, threads, grid_x, s);
  return (int)cudaErrorInvalidValue;
}
