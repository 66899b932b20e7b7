// Direct VALID 2-D convolution for sm_90a, plain C interface:
//   x (N, C_I, H_I, W_I) * w (C_O, C_I, K, K), stride s -> (N, C_O, H_O, W_O)
//
// Replaces the Pallas kernel src/repro/kernels/conv2d.py::conv2d_pallas
// (body _conv_kernel), the worker's conv subtask.  That kernel takes one
// image and tiles output channels only; here the batch axis is part of the
// kernel, because coded pieces are as narrow as W_O = 2 and a tile over the
// width alone would leave the card empty.
//
// Bound: at VGG16's widths every byte moved feeds hundreds of multiply-adds,
// so the tensor cores' dense TF32 rate.  f32 operands are taken in 3xTF32:
// hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest, and each
// product is hi*hi + hi*lo + lo*hi (lo*lo, below 2^-22 of the product, is
// dropped), accumulated in f32 and rounded once to x's type at the end.
// bf16 operands are exact in TF32 (lo = 0): hi*hi alone.
//
// Design: implicit GEMM, nothing is materialised.  With R = C_I * K * K and
// P = N * H_O * W_O the convolution is  out^T (P, C_O) = patch (P, R) @ w^T,
// where w is the OIHW tensor read as a row-major (C_O, R) matrix and
// patch[(n, ho, wo), (ci, kh, kw)] = x[n, ci, ho * s + kh, wo * s + kw] is
// gathered on the fly, with zero fill at every masked edge (P, C_O, R).  x is
// addressed through its element strides, so a width slice x[..., a:b] of a
// larger tensor is read in place; w and the output are contiguous.  The
// offset of each contraction row (ci, kh, kw) in x is computed once per block
// into a table in shared memory, so the gather does no division.
//
// A block of two warpgroups computes BM = 128 pixels x BN = 128 (or 64)
// output channels, each warpgroup 64 pixels by wgmma m64nBNk8: the patch is
// the A operand, in registers, and the weight the B operand, in shared
// memory.  A small kernel (conv2d_implicit_gemm_split_w, its own entry
// point) splits the weight into hi and lo and lays it out in device memory
// as the ring holds it, once for every conv with that weight (the caller
// keeps it), so a stage of the weight is one contiguous copy by cp.async,
// three stages in flight.  Each thread gathers its own A fragments (two pixels,
// two contraction rows a k-step) two stages ahead, by 4-byte reads, and
// splits them in registers; nothing of the patch goes through shared memory.
// One __syncthreads a stage.
//
// Order: each stage's 4 k-steps x 3 products go into a fresh accumulator
// (the tensor core adds in its own rounding), which is then added to the
// running f32 sum in order; a stage is always the same BK = 32 rows of R
// counted from the split's start, zero-filled past its end.  So every output
// element is summed in one order whatever N, H, W or the tile: a conv of n
// stacked pieces gives each piece the bits of its own launch.
//
// R-split: VGG16's narrow coded pieces leave few (P, C_O) tiles at the deep
// layers, so R can be cut into `splits` ascending ranges of `chunk` rows
// (whole stages) over a (splits, 1, 1) thread-block cluster; each rank runs
// its range as above and the partials are summed through distributed shared
// memory in ascending rank.  The Python plan (kernels/conv2d.py::conv_plan)
// makes the split a function of the weight's shape only.
//
// Launches on the given stream, allocates nothing, does not synchronise.
// The entry points return the launch's error; a plan this file cannot take
// returns cudaErrorInvalidValue.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sgemm_mainloop.cuh"  // cp.async, to_f32, from_f32, launch_cluster
#include "ssd_common.cuh"      // the 3xTF32 split

namespace {

namespace cg = cooperative_groups;

using sgemm::cp_async16;
using sgemm::cp_commit;
using sgemm::cp_wait;
using sgemm::from_f32;
using sgemm::smem_u32;
using sgemm::to_f32;

constexpr int BM = 128;       // output pixels a block: two warpgroups of 64
constexpr int BK = 32;        // contraction rows a stage
constexpr int STAGES = 3;     // ring depth
constexpr int THREADS = 256;  // two warpgroups
constexpr int EPAD = 4;       // row padding of the staged output tile

// The output-channel widths BN a block may take, by the index the Python
// launch plan uses (kernels/conv2d.py::CONV_TILES mirrors this table).
#define CONV_FOR_EACH_TILE(X) \
  X(0, 128)                   \
  X(1, 64)

struct ConvShape {
  int N, C_I, C_O, H_O, W_O, K, stride;
  long long sxn, sxc, sxh, sxw;  // element strides of x
};

// A weight tile: BN channels x BK rows of R, K-major in 8-channel x 16-byte
// core matrices (no swizzle): rows 4q..4q+3 of R of channel c lie at byte
// (q / 2) * BN * 32 + (q % 2) * 128 + (c / 8) * 256 + (c % 8) * 16, so that a
// k-step (8 rows of R) is contiguous, its two 4-row halves 128 bytes apart
// and its 8-channel groups 256 bytes apart.  A stage is the hi tile, then the
// lo tile; the split weight holds, for each tile of BN channels, every stage
// of R in order.
template <int BN>
struct Tile {
  static constexpr int BYTES = BN * BK * 4;  // the hi or the lo tile
  static constexpr int STAGE_BYTES = 2 * BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int NACC = BN / 2;  // accumulators a thread of m64nBN
  static_assert(BN * (BM + EPAD) * 4 <= RING_BYTES,
                "the ring holds the output tile");
};

// ssd::split, with lo rounded to TF32 as well (to nearest, where the tensor
// core would drop its low bits): |v - hi - lo| <= 2^-22 |v|
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  ssd::split(v, hi, lo);
  lo = (lo + 0x1000u) & 0xffffe000u;
}

// The B operand in shared memory, K-major, no swizzle: start address, leading
// byte offset (the next 4 rows of K) 128, stride byte offset (the next 8
// channels) 256, all in 16-byte units
__device__ __forceinline__ uint64_t desc(const char* p) {
  return (uint64_t)((smem_u32(p) & 0x3ffff) >> 4) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async's writes to shared memory made visible to the wgmmas' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads of d across the wgmma wait, and from
// giving an A fragment's registers to other values before it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (m64 x nN, f32) += A (64 x 8) B (8 x N) in TF32: A from registers (this
// warp's 16 rows: a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3]
// (g + 8, t + 4), g = lane / 4, t = lane % 4), B from shared memory;
// scale_d = 0 writes d = A B
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2],
                                      const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  if constexpr (BN == 128)
    wgmma_n128(d, a, db, scale_d);
  else
    wgmma_n64(d, a, db, scale_d);
}

// The weight, split and laid out as the ring holds it (Tile): `ws` holds
// ceil(C_O / BN) x n_ks stages, n_ks = ceil(R / BK), zero past C_O and R.
// A thread writes one 16-byte quad of the hi and of the lo tile; neighbouring
// threads write neighbouring quads.
template <typename T, int BN>
__global__ void __launch_bounds__(256)
conv2d_implicit_gemm_split_w(const T* __restrict__ w, float* __restrict__ ws,
                             int C_O, int R, int n_ks) {
  constexpr int PER = BN * BK / 4;  // quads a tile
  const long long total = (long long)((C_O + BN - 1) / BN) * n_ks * PER;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < total;
       e += (long long)gridDim.x * 256) {
    const long long blk = e / PER;  // (channel tile, stage)
    const int i = (int)(e - blk * PER);
    // the quad of channel `row`, rows 4 q.. of the stage, lies at byte 16 i
    const int row = ((i >> 4) % (BN / 8)) * 8 + (i & 7);
    const int q = ((i >> 4) / (BN / 8)) * 2 + ((i >> 3) & 1);
    const int ct = (int)(blk / n_ks);
    const int co = ct * BN + row;
    const int k = (int)(blk - (long long)ct * n_ks) * BK + 4 * q;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v =
          (co < C_O && k + c < R) ? to_f32(w[(long long)co * R + k + c]) : 0.f;
      split(v, hi[c], lo[c]);
    }
    char* base = reinterpret_cast<char*>(ws) + blk * Tile<BN>::STAGE_BYTES;
    *reinterpret_cast<uint4*>(base + 16 * i) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(base + Tile<BN>::BYTES + 16 * i) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// THREE: 3xTF32 products (f32 inputs); else hi*hi alone (bf16 inputs)
template <typename T, int BN, bool THREE>
__global__ void __launch_bounds__(THREADS, 1)
conv2d_implicit_gemm(const T* __restrict__ x, const float* __restrict__ ws,
                     T* __restrict__ out, const ConvShape s, int splits,
                     int chunk) {
  extern __shared__ __align__(128) char smem[];
  using Tl = Tile<BN>;
  int* tab = reinterpret_cast<int*>(smem + Tl::RING_BYTES);
  const int R = s.C_I * s.K * s.K;
  const long long HW = (long long)s.H_O * s.W_O;
  const long long P = (long long)s.N * HW;
  // a (splits, 1, 1) cluster: consecutive blocks along x are its ranks
  const int rank = (int)(blockIdx.x % splits);
  const long long p0 = (long long)(blockIdx.x / splits) * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = rank * chunk;
  const int k_end = min(R, k_begin + chunk);

  // the offsets of this block's contraction rows, ascending r
  const int KK = s.K * s.K;
  for (int i = threadIdx.x; i < k_end - k_begin; i += THREADS) {
    const int r = k_begin + i;
    const int ci = r / KK;
    const int rem = r - ci * KK;
    const int kh = rem / s.K;
    tab[i] = (int)(ci * s.sxc + kh * s.sxh + (rem - kh * s.K) * s.sxw);
  }

  // this thread's two pixels: rows g and g + 8 of its warp's 16
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  bool p_ok[2];
  long long xb[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const long long p =
        p0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * j;
    p_ok[j] = p < P;
    xb[j] = 0;
    if (p_ok[j]) {
      const long long n = p / HW;
      const long long q = p - n * HW;
      const long long ho = q / s.W_O;
      const long long wo = q - ho * s.W_O;
      xb[j] = n * s.sxn + ho * s.stride * s.sxh + wo * s.stride * s.sxw;
    }
  }
  __syncthreads();  // the table

  // stage t of the range: the weight's copy into its slot, and the patch's
  // A values, raw[4 k + 2 h + j] = patch[pixel j][k0 + 8 k + tq + 4 h]
  const long long stage0 =
      (long long)blockIdx.y * ((R + BK - 1) / BK) + k_begin / BK;
  const char* wsrc =
      reinterpret_cast<const char*>(ws) + stage0 * Tl::STAGE_BYTES;
  auto copy_w = [&](int t) {
    const char* src = wsrc + (long long)t * Tl::STAGE_BYTES;
    char* dst = smem + (t % STAGES) * Tl::STAGE_BYTES;
    constexpr int N16 = (THREE ? 2 : 1) * Tl::BYTES / 16;
#pragma unroll
    for (int i = threadIdx.x; i < N16; i += THREADS)
      cp_async16(reinterpret_cast<float*>(dst + 16 * i),
                 reinterpret_cast<const float*>(src + 16 * i), 16);
  };
  auto gather = [&](int t, float (&raw)[16]) {
    const int r0 = k_begin + t * BK + tq;
#pragma unroll
    for (int k = 0; k < BK / 8; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * k + 4 * h;
        const bool ok = r < k_end;
        const int off = ok ? tab[r - k_begin] : 0;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          raw[4 * k + 2 * h + j] =
              (ok && p_ok[j]) ? to_f32(x[xb[j] + off]) : 0.f;
      }
  };

  const int nk = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) copy_w(t);
    cp_commit();  // one group a stage, empty or not: the count stays fixed
  }
  // the patch is gathered two stages ahead: stage t in raw[t % 2]
  float raw0[16], raw1[16];
  gather(0, raw0);
  if (nk > 1) gather(1, raw1);
  float acc[Tl::NACC], part[Tl::NACC];
#pragma unroll
  for (int i = 0; i < Tl::NACC; ++i) acc[i] = part[i] = 0.f;
  uint32_t ahi[BK / 8][4], alo[BK / 8][4];
  auto step = [&](int t, float (&raw)[16]) {
#pragma unroll
    for (int k = 0; k < BK / 8; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (THREE)
          split(raw[4 * k + i], ahi[k][i], alo[k][i]);
        else
          ahi[k][i] = __float_as_uint(raw[4 * k + i]);  // bf16: exact in TF32
      }
    cp_wait<STAGES - 2>();  // this thread's copies of stage t are in
    fence_proxy_async();
    // every copy of stage t is in; every wgmma of stage t - 1 has finished
    __syncthreads();
    const char* st = smem + (t % STAGES) * Tl::STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {
      const char* b = st + k * BN * 32;
      const uint64_t bh = desc(b);
      wgmma<BN>(part, ahi[k], bh, k);
      if constexpr (THREE) {
        wgmma<BN>(part, ahi[k], desc(b + Tl::BYTES), 1);
        wgmma<BN>(part, alo[k], bh, 1);
      }
    }
    wgmma_commit();
    // while they run: the copy of stage t + 2 (into the slot of stage t - 1)
    // and the gather of stage t + 2 (into the registers stage t came in)
    if (t + STAGES - 1 < nk) copy_w(t + STAGES - 1);
    cp_commit();
    if (t + 2 < nk) gather(t + 2, raw);
    wgmma_wait_all();
    // the wgmmas read ahi and alo until here: no register of theirs may be
    // reused before (the gather above must not land in them)
    fence_regs(part);
    fence_regs(ahi);
    if constexpr (THREE) fence_regs(alo);
#pragma unroll
    for (int i = 0; i < Tl::NACC; ++i) acc[i] += part[i];
  };
  for (int t = 0; t < nk; t += 2) {
    step(t, raw0);
    if (t + 1 < nk) step(t + 1, raw1);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free

  // the block's partial tile, channel-major: tile[co][m], rows BM + EPAD apart
  // (accumulator i of lane (g, q) of warp v of warpgroup wg is pixel
  // 64 wg + 16 v + g + 8 ((i / 2) % 2), channel 8 (i / 4) + 2 q + i % 2)
  float* tile = reinterpret_cast<float*>(smem);
  {
    const int m = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < Tl::NACC; ++i)
      tile[(8 * (i >> 2) + 2 * tq + (i & 1)) * (BM + EPAD) + m +
           8 * ((i >> 1) & 1)] = acc[i];
  }
  cg::cluster_group cl = cg::this_cluster();
  if (splits > 1)
    cl.sync();
  else
    __syncthreads();
  // each element summed over the ranks in ascending order, ((p0 + p1) + p2)
  // + ..., whatever rank does the sum; a thread keeps one pixel throughout
  const int m = threadIdx.x % BM;
  const long long p = p0 + m;
  if (p < P) {
    const long long n = p / HW;
    T* o = out + n * s.C_O * HW + (p - n * HW);
    for (int e = rank * THREADS + threadIdx.x; e < BM * BN;
         e += splits * THREADS) {
      const int co = e / BM;
      if (n0 + co >= s.C_O) break;  // co only grows along e
      const int idx = co * (BM + EPAD) + m;
      float v = tile[idx];
      if (splits > 1) {
        v = cl.map_shared_rank(tile, 0)[idx];
        for (int q = 1; q < splits; ++q) v += cl.map_shared_rank(tile, q)[idx];
      }
      o[(long long)(n0 + co) * HW] = from_f32<T>(v);
    }
  }
  if (splits > 1) cl.sync();  // no block leaves while another reads its tile
}

template <typename T, int BN>
int launch_split_w(const void* w, void* ws, int C_O, int R,
                   cudaStream_t stream) {
  const int n_ks = (R + BK - 1) / BK;
  const long long quads =
      (long long)((C_O + BN - 1) / BN) * n_ks * (BN * BK / 4);
  conv2d_implicit_gemm_split_w<T, BN>
      <<<(unsigned)std::min<long long>((quads + 255) / 256, 8 * 132), 256, 0,
         stream>>>(static_cast<const T*>(w), static_cast<float*>(ws), C_O, R,
                   n_ks);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch(const void* x, const void* ws, void* out, const ConvShape& s,
           int splits, int chunk, int smem, cudaStream_t stream) {
  // the ring, then one int offset per contraction row of a split
  if (smem != Tile<BN>::RING_BYTES + 4 * chunk)
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)s.N * s.H_O * s.W_O;
  const long long gx = (P + BM - 1) / BM * splits;
  const long long gy = (s.C_O + BN - 1) / BN;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(ws);
  T* op = static_cast<T*>(out);
  if constexpr (sizeof(T) == 4)
    return (int)sgemm::launch_cluster(&conv2d_implicit_gemm<T, BN, true>, grid,
                                      THREADS, smem, splits, stream, xp, wp, op,
                                      s, splits, chunk);
  else
    return (int)sgemm::launch_cluster(&conv2d_implicit_gemm<T, BN, false>, grid,
                                      THREADS, smem, splits, stream, xp, wp, op,
                                      s, splits, chunk);
}

template <typename T>
int launch_plan(const void* x, const void* ws, void* out, const ConvShape& s,
                int config, int splits, int chunk, int smem,
                cudaStream_t stream) {
  const long long R = (long long)s.C_I * s.K * s.K;
  // the splits are `splits` ascending ranges of `chunk` rows, none empty,
  // each starting on a stage of the split weight
  if (splits < 1 || splits > sgemm::MAX_SPLIT || chunk < 1 ||
      (splits > 1 && chunk % BK) || (long long)(splits - 1) * chunk >= R ||
      (long long)splits * chunk < R)
    return (int)cudaErrorInvalidValue;
  switch (config) {
#define TILE_CASE(ID, BN) \
  case ID:                \
    return launch<T, BN>(x, ws, out, s, splits, chunk, smem, stream);
    CONV_FOR_EACH_TILE(TILE_CASE)
#undef TILE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int split_w_plan(const void* w, void* ws, int C_O, int R, int config,
                 cudaStream_t stream) {
  switch (config) {
#define TILE_CASE(ID, BN) \
  case ID:                \
    return launch_split_w<T, BN>(w, ws, C_O, R, stream);
    CONV_FOR_EACH_TILE(TILE_CASE)
#undef TILE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The weight w (C_O, C_I, K, K), contiguous, split into hi and lo and laid
// out for the tile `config` (BN channels a block) in ws: ceil(C_O / BN) *
// ceil(R / 32) * 2 * BN * 32 floats, 16-byte aligned.  It depends on the
// weight and the tile alone, so the caller may keep it for every conv with
// that weight and tile.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// launch's error.
extern "C" int conv2d_split_w_launch(const void* w, void* ws, int C_O,
                                     int C_I, int K, int dtype, int config,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(ws) % 16 || C_O < 1 || C_I < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const int R = C_I * K * K;
  if (dtype == 0) return split_w_plan<float>(w, ws, C_O, R, config, st);
  if (dtype == 1)
    return split_w_plan<__nv_bfloat16>(w, ws, C_O, R, config, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.  ws: the weight as conv2d_split_w_launch
// lays it out for the same config.  config: the tile index of
// CONV_FOR_EACH_TILE, BN channels a block; splits / chunk: the R-split;
// smem: dynamic shared bytes (the ring + 4 * chunk).  The offsets of x's
// channel, row and column steps within one image must fit an int (the
// wrapper checks).  Returns the launch's error.
extern "C" int conv2d_launch(const void* x, const void* ws, void* out, int N,
                             int C_I, int C_O, int H_O, int W_O, int K,
                             int stride, long long sxn, long long sxc,
                             long long sxh, long long sxw, int dtype,
                             int config, int splits, int chunk, int smem,
                             void* stream) {
  const ConvShape s = {N, C_I, C_O, H_O, W_O, K, stride, sxn, sxc, sxh, sxw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(ws) % 16) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_plan<float>(x, ws, out, s, config, splits, chunk, smem, st);
  if (dtype == 1)
    return launch_plan<__nv_bfloat16>(x, ws, out, s, config, splits, chunk,
                                      smem, st);
  return (int)cudaErrorInvalidValue;
}
