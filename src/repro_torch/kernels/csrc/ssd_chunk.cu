// Mamba2 SSD (state-space duality) chunk scan for sm_90a, plain C interface:
//   x (B, T, H, P), dt (B, T, H), A (H,), Bm / Cm (B, T, N), h0 (B, H, P, N)
//   -> y (B, T, H, P) in x's type, final state (B, H, P, N) in f32
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py::ssd_chunk_pallas
// (body _ssd_kernel), one SSD chunk per grid step over the batch.  Here a
// whole sequence of chunks of length L runs in four passes, the chunk-
// parallel form of the reference's models/ssm.py::ssd_chunked.  With
// dA = dt * A and cum its running sum inside a chunk:
//
//   (1) cb:         G[b, c] = tril(C_c B_c^T)                    (L x L)
//   (2) states:     S[b, c, h][p, n] = sum_s w_s x[s, p] B[s, n],
//                   w_s = exp(cum_end - cum_s) dt_s;  also cum_end[b, c, h]
//   (3) state_pass: Hin[c] = Hin[c-1] exp(cum_end[c-1]) + S[c-1], Hin[0] = h0;
//                   the final state is the state after the last chunk
//   (4) out:        y[l, p] = sum_{s <= l} G[l, s] exp(cum_l - cum_s) dt_s x[s, p]
//                           + exp(cum_l) sum_n C[l, n] Hin[p, n]
//
// Rows past T (a ragged last chunk) read as x = dt = B = C = 0, which is what
// the reference's zero padding gives: they add nothing and do not decay.
//
// Why this shape on Hopper.  The TPU kernel keeps one chunk of every head
// (2 MB at Zamba2's widths) in VMEM; a Hopper block has 227 KB.  Only the
// carried state is sequential over chunks, and it is a P x N elementwise
// recurrence, so passes (1), (2) and (4) run every (batch, chunk, head) in
// parallel and pass (3) alone walks the chunks.  Bm and Cm are shared by the
// heads, so C B^T is computed once per (batch, chunk) in pass (1), not once
// per head.  The running sum of dA is a warp scan, taken while the chunk's
// operands are in flight.
//
// Bound: operations.  The products (L x L x N once per chunk; per head
// L x N x P, causal L x L x P and P x L x N) run on the tensor cores as
// 3xTF32: each operand is split as hi = a rounded to TF32, lo = a - hi, and
// lo*hi + hi*lo + hi*hi is accumulated in f32 by mma.sync.m16n8k8, which
// keeps f32 accuracy (plain TF32 keeps about 3 decimal digits and would fail
// the f64 check).  The split is integer arithmetic: cvt.rna.tf32.f32 issues
// at a fraction of the integer rate, and with a split per operand value it
// held the products back.  Operands are staged with cp.async (16 bytes where the rows
// allow it, else 4), bf16 x / Bm / Cm are widened to f32 on load, and the
// shared-memory row strides make every fragment read conflict-free.
//
// Blocks (shared memory in bytes at L = 128, P = 64 and N = 64 / N = 128,
// so blocks per SM of 228 KB):
//   cb          4 warps, grid (tiles^2, c, B), tiles = ceil(L / 64): one
//               64 x 64 tile of G, C and B rows staged (34,816 / 67,584:
//               6 / 3 per SM); tiles above the diagonal are written as zeros
//   states      8 warps, grid (H, c, B): x and B of the chunk (75,264 /
//               108,032: 3 / 2 per SM); warp w owns rows p in
//               [16 (w % 4), +16) and half of the n columns
//   state_pass  8 warps, grid (ceil(P N / 256), H, B), no shared memory
//   out         8 warps, grid (H, c, B): all L rows of y for one head.  Both
//               products stream their contraction in slabs of 32 (state
//               columns of C and Hin, then sequence rows of G and x)
//               through a ring of 3 stages, two slabs in flight while one
//               is multiplied (83,968 for both N: 2 per SM); each G slab is
//               turned in place into the decayed G o exp(segsum) o dt, its
//               rows above the slab (causally zero) neither copied nor
//               multiplied.  Warp w owns the m-tiles w % 4 and 7 - w % 4,
//               an early and a late one so the causal work is even, and
//               half of the p columns
// Each product keeps the high parts' product and the two small cross terms
// in separate accumulators, so the three tensor-core products of a step do
// not wait on each other.
// Limits: L <= 128, P <= 64, N <= 128.  The shared memory of each pass is
// planned in Python (kernels/ssd_chunk.py::ssd_plan) and re-checked here.
//
// x, dt, Bm and Cm are read through their strides (innermost stride 1), so
// views of the in_proj output need no copy; G, S, Hin, y, h0 and the final
// state are contiguous.  Every entry point launches on the given stream,
// allocates nothing, does not synchronise and returns a cudaError_t
// (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sgemm_mainloop.cuh"  // cp.async helpers, to_f32

namespace {

using sgemm::cp_async16;
using sgemm::cp_async4;
using sgemm::cp_commit;
using sgemm::cp_wait;
using sgemm::to_f32;

constexpr int LMAX = 128, PMAX = 64, NMAX = 128;
constexpr int THREADS = 128;       // cb: 4 warps
constexpr int WIDE = 256;          // states, out, state_pass: 8 warps
constexpr int RB = 64;             // rows of a G tile
// out: the contraction of both products runs in slabs of KS columns (state
// columns n, then sequence rows s) through a ring of STAGES buffers, so the
// copies of slab k + 2 are in flight while slab k is multiplied
constexpr int KS = 32, STAGES = 3;

enum { VEC_X = 1, VEC_B = 2, VEC_C = 4, VEC_G = 8, VEC_S = 16 };

__host__ __device__ constexpr int up(int a, int b) { return (a + b - 1) / b * b; }
// Row strides (floats) for conflict-free fragment reads: an A fragment reads
// row g, column t (g < 8, t < 4) of a row-major tile, g * S + t, distinct
// banks when S = 4 mod 8; a B fragment reads row t, column g, t * S + g,
// distinct when S = 8 mod 16.  Both keep rows 16-byte aligned.
__host__ __device__ constexpr int stride_a(int n) { return up(n, 8) + 4; }
__host__ __device__ constexpr int stride_b(int n) { return up(n, 16) + 8; }

struct Dims {
  int B, T, H, P, N, L, c;
  long long sxb, sxt, sxh;  // x strides (p stride 1)
  long long sdb, sdt, sdh;  // dt strides
  long long sbb, sbt;       // Bm strides (n stride 1)
  long long scb, sct;       // Cm strides
  int vec;                  // VEC_*: those rows load as 4-element quads
};

// Shared memory (bytes) of each pass; kernels/ssd_chunk.py::ssd_plan holds
// the same formulas.
inline int smem_cb(int L, int P, int N) { return 4 * 2 * RB * stride_a(N); }
inline int smem_states(int L, int P, int N) {
  const int lk = up(L, 8);
  return 4 * (lk * stride_b(P) + lk * stride_b(N) + 3 * LMAX);
}
inline int smem_out(int L, int P, int N) {
  const int lk = up(L, 8), sa = stride_a(KS), hin = up(P, 8) * sa,
            xr = KS * stride_b(P);
  return 4 * (STAGES * (lk * sa + (hin > xr ? hin : xr)) + 2 * LMAX);
}

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

// ---- (1) C B^T once per (batch, chunk) ---------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ G, const Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (d.L + RB - 1) / RB;
  const int ti = blockIdx.x / nt, tj = blockIdx.x - ti * nt;
  const int c = blockIdx.y, b = blockIdx.z;
  const int r0 = ti * RB, s0 = tj * RB;
  const int rows = min(RB, d.L - r0), cols = min(RB, d.L - s0);
  float* Gt = G + (((long long)b * d.c + c) * d.L + r0) * d.L + s0;
  if (tj > ti) {  // above the diagonal
    for (int e = threadIdx.x; e < rows * cols; e += THREADS)
      Gt[(long long)(e / cols) * d.L + e % cols] = 0.f;
    return;
  }
  const int len = min(d.L, d.T - c * d.L);  // rows of the chunk within T
  const int NS = stride_a(d.N), K8 = up(d.N, 8);
  float* Cs = smem;            // RB x NS: C rows r0..
  float* Bs = Cs + RB * NS;    // RB x NS: B rows s0..
  const long long t0 = (long long)c * d.L;
  stage(Cs, NS, Cm + b * d.scb + (t0 + r0) * d.sct, d.sct,
        max(0, min(rows, len - r0)), d.N, up(rows, 16), K8, d.vec & VEC_C);
  stage(Bs, NS, Bm + b * d.sbb + (t0 + s0) * d.sbt, d.sbt,
        max(0, min(cols, len - s0)), d.N, up(cols, 8), K8, d.vec & VEC_B);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, m0 = 16 * warp;
  if (m0 >= rows) return;
  const int ntn = (cols + 7) / 8;
  float acc[8][4] = {}, sml[8][4] = {};
  for (int k = 0; k < K8; k += 8) {
    const float* a = Cs + (m0 + g) * NS + k + t;
    const float av[4] = {a[0], a[8 * NS], a[4], a[8 * NS + 4]};
    uint32_t ah[4], al[4];
    split_a(av, ah, al);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < ntn) {  // B[k][s] = Bm[s][k]
        const float* bp = Bs + (8 * j + g) * NS + k + t;
        mma3(acc[j], sml[j], ah, al, bp[0], bp[4]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + g + 8 * (i >> 1), s = 8 * j + 2 * t + (i & 1);
      if (r < rows && s < cols)
        Gt[(long long)r * d.L + s] =
            (ti == tj && s > r) ? 0.f : acc[j][i] + sml[j][i];
    }
  }
}

// ---- (2) chunk states ----------------------------------------------------------

template <typename T, int NT>
__global__ void __launch_bounds__(WIDE, NT == 8 ? 3 : 2)
ssd_states_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  float* __restrict__ S, float* __restrict__ cum_end,
                  const Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int len = min(d.L, d.T - c * d.L);
  const int LK = up(d.L, 8), XS = stride_b(d.P), BS = stride_b(d.N);
  float* Xs = smem;             // LK x XS: x[s][p]
  float* Bs = Xs + LK * XS;     // LK x BS: B[s][n]
  float* cum = Bs + LK * BS;    // LMAX
  float* dts = cum + LMAX;      // LMAX
  float* wts = dts + LMAX;      // LMAX: exp(cum_end - cum_s) dt_s
  const long long t0 = (long long)c * d.L;
  stage(Xs, XS, x + b * d.sxb + t0 * d.sxt + h * d.sxh, d.sxt, len, d.P, LK,
        up(d.P, 16), d.vec & VEC_X);
  stage(Bs, BS, Bm + b * d.sbb + t0 * d.sbt, d.sbt, len, d.N, LK, up(d.N, 8),
        d.vec & VEC_B);
  cp_commit();
  if (threadIdx.x < 32)
    chunk_scan(dt + b * d.sdb + t0 * d.sdt + h * d.sdh, d.sdt, len, A[h], cum,
               dts);
  __syncthreads();
  const float ce = cum[d.L - 1];
  for (int l = threadIdx.x; l < LK; l += WIDE)
    wts[l] = expf(ce - cum[l]) * dts[l];
  if (threadIdx.x == 0) cum_end[((long long)b * d.c + c) * d.H + h] = ce;
  cp_wait<0>();
  __syncthreads();

  // warp w: rows p in [16 (w % 4), +16), n tiles [j0, j0 + NT / 2)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, m0 = 16 * (warp & 3);
  constexpr int NH = NT / 2;
  const int j0 = NH * (warp >> 2), ntn = (d.N + 7) / 8 - j0;
  if (m0 >= d.P || ntn <= 0) return;
  float acc[NH][4] = {}, sml[NH][4] = {};
  for (int k = 0; k < LK; k += 8) {
    // A[p][s] = x[s][p] w_s
    const float w0 = wts[k + t], w1 = wts[k + t + 4];
    const float* xa = Xs + (k + t) * XS + m0 + g;
    const float av[4] = {xa[0] * w0, xa[8] * w0, xa[4 * XS] * w1,
                         xa[4 * XS + 8] * w1};
    uint32_t ah[4], al[4];
    split_a(av, ah, al);
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      if (j < ntn) {
        const float* bp = Bs + (k + t) * BS + 8 * (j0 + j) + g;
        mma3(acc[j], sml[j], ah, al, bp[0], bp[4 * BS]);
      }
    }
  }
  float* So = S + (((long long)b * d.c + c) * d.H + h) * d.P * d.N;
#pragma unroll
  for (int j = 0; j < NH; ++j) {
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int p = m0 + g + 4 * i, n = 8 * (j0 + j) + 2 * t;
      if (p < d.P && n < d.N)
        store2(So + p * d.N + n, acc[j][i] + sml[j][i],
               acc[j][i + 1] + sml[j][i + 1], n + 1 < d.N, d.N % 2 == 0);
    }
  }
}

// ---- (3) state passing: sequential over chunks, parallel over (b, h, p, n) --

__global__ void __launch_bounds__(WIDE)
ssd_state_pass_kernel(const float* __restrict__ S,
                      const float* __restrict__ cum_end,
                      const float* __restrict__ h0, float* __restrict__ Hin,
                      float* __restrict__ h_out, int nc, int H, int PN) {
  const int e = blockIdx.x * WIDE + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  float v = h0 ? h0[bh * PN + e] : 0.f;
#pragma unroll 4
  for (int j = 0; j < nc; ++j) {
    const long long ch = ((long long)b * nc + j) * H + h;
    const float s = S[ch * PN + e];
    Hin[ch * PN + e] = v;
    v = fmaf(v, expf(cum_end[ch]), s);
  }
  h_out[bh * PN + e] = v;
}

// ---- (4) chunk output -------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(WIDE, 2)
ssd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Cm,
               const float* __restrict__ G, const float* __restrict__ Hin,
               T* __restrict__ y, const Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int len = min(d.L, d.T - c * d.L);
  const int LK = up(d.L, 8), P8 = up(d.P, 8);
  const int SA = stride_a(KS), XS = stride_b(d.P);
  // a stage: C or G columns (LK x SA), then Hin columns (P8 x SA) or x rows
  // (KS x XS)
  const int stage_floats = LK * SA + max(P8 * SA, KS * XS);
  float* cum = smem + STAGES * stage_floats;  // LMAX
  float* dts = cum + LMAX;                    // LMAX
  const long long t0 = (long long)c * d.L;
  const long long bc = (long long)b * d.c + c, ch = bc * d.H + h;
  const T* Cg = Cm + b * d.scb + t0 * d.sct;
  const T* xg = x + b * d.sxb + t0 * d.sxt + h * d.sxh;
  const float* Hg = Hin + ch * d.P * d.N;
  const float* Gg = G + bc * d.L * d.L;
  const int n_inter = (d.N + KS - 1) / KS, n_slabs = n_inter +
                                                   (d.L + KS - 1) / KS;
  auto load = [&](int k) {
    if (k < n_slabs) {
      float* st = smem + (k % STAGES) * stage_floats;
      if (k < n_inter) {  // C[:, n0 : n0 + KS] and Hin[:, n0 : n0 + KS]
        const int n0 = k * KS, cols = min(KS, d.N - n0);
        stage(st, SA, Cg + n0, d.sct, len, cols, LK, KS, d.vec & VEC_C);
        stage(st + LK * SA, SA, Hg + n0, (long long)d.N, d.P, cols, P8, KS,
              d.vec & VEC_S);
      } else {  // G[s0 :, s0 : s0 + KS] (the causal rows) and x[s0 : s0 + KS]
        const int s0 = (k - n_inter) * KS, cols = min(KS, d.L - s0);
        stage(st + s0 * SA, SA, Gg + (long long)s0 * d.L + s0, (long long)d.L,
              d.L - s0, cols, LK - s0, KS, d.vec & VEC_G);
        stage(st + LK * SA, XS, xg + s0 * d.sxt, d.sxt, max(0, len - s0),
              d.P, KS, P8, d.vec & VEC_X);
      }
    }
    cp_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) load(k);
  if (threadIdx.x < 32)
    chunk_scan(dt + b * d.sdb + t0 * d.sdt + h * d.sdh, d.sdt, len, A[h], cum,
               dts);

  // warp w: m-tiles {w % 4, 7 - w % 4} (an early and a late one, so the
  // causal work is even) and p tiles [4 (w / 4), +4)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt[2] = {16 * (warp & 3), 16 * (7 - (warp & 3))};
  const int j0 = 4 * (warp >> 2), ntp = (d.P + 7) / 8 - j0;
  float acc[2][4][4] = {}, sml[2][4][4] = {};
  for (int k = 0; k < n_slabs; ++k) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // slab k has landed; slab k - 1's buffer is free
    load(k + STAGES - 1);
    float* st = smem + (k % STAGES) * stage_floats;
    const bool inter = k < n_inter;
    const int s0 = inter ? 0 : (k - n_inter) * KS;
    if (!inter) {
      if (k == n_inter) {  // the incoming-state term is complete: scale it
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float e0 = expf(cum[mt[mi] + g]), e1 = expf(cum[mt[mi] + g + 8]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[mi][j][0] = (acc[mi][j][0] + sml[mi][j][0]) * e0;
            acc[mi][j][1] = (acc[mi][j][1] + sml[mi][j][1]) * e0;
            acc[mi][j][2] = (acc[mi][j][2] + sml[mi][j][2]) * e1;
            acc[mi][j][3] = (acc[mi][j][3] + sml[mi][j][3]) * e1;
            sml[mi][j][0] = sml[mi][j][1] = sml[mi][j][2] = sml[mi][j][3] = 0.f;
          }
        }
      }
      // G becomes M[l][s] = G[l][s] exp(cum_l - cum_s) dt_s for s <= l
      const int sc = s0 + lane;
      const float cs = cum[sc], ds = dts[sc];
      for (int l = s0 + warp; l < LK; l += WIDE / 32) {
        float* m = st + l * SA + lane;
        *m = sc <= l ? *m * expf(cum[l] - cs) * ds : 0.f;
      }
      __syncthreads();
    }
    const float* As = st;                 // rows l, columns of the slab
    const float* Bs = st + LK * SA;       // Hin[p][n] or x[s][p]
#pragma unroll
    for (int kk = 0; kk < KS; kk += 8) {
      // B fragments of the warp's p tiles, shared by its two m-tiles
      float bv[4][2] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pc = 8 * (j0 + j) + g;
        if (j >= ntp) continue;
        if (inter) {
          bv[j][0] = Bs[pc * SA + kk + t];
          bv[j][1] = Bs[pc * SA + kk + t + 4];
        } else {
          bv[j][0] = Bs[(kk + t) * XS + pc];
          bv[j][1] = Bs[(kk + t + 4) * XS + pc];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m0 = mt[mi];
        // rows past the chunk, or (causal) all above slab column s0 + kk
        if (m0 >= LK || (!inter && s0 + kk > m0 + 15)) continue;
        const float* a = As + (m0 + g) * SA + kk + t;
        const float av[4] = {a[0], a[8 * SA], a[4], a[8 * SA + 4]};
        uint32_t ah[4], al[4];
        split_a(av, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < ntp) mma3(acc[mi][j], sml[mi][j], ah, al, bv[j][0], bv[j][1]);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int l = mt[mi] + g + 4 * i, p = 8 * (j0 + j) + 2 * t;
        if (l < len && p < d.P)
          store2(y + ((b * (long long)d.T + t0 + l) * d.H + h) * d.P + p,
                 acc[mi][j][i] + sml[mi][j][i],
                 acc[mi][j][i + 1] + sml[mi][j][i + 1], p + 1 < d.P,
                 d.P % 2 == 0);
      }
    }
  }
}

// ---- host side ------------------------------------------------------------------

// dims: B, T, H, P, N, L, c, sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, scb, sct,
// vec.  False when a value is out of the kernels' range.
bool parse(const long long* v, Dims& d) {
  for (int i = 0; i < 7; ++i)
    if (v[i] < 1 || v[i] > 0x7fffffffLL) return false;
  d.B = (int)v[0], d.T = (int)v[1], d.H = (int)v[2], d.P = (int)v[3];
  d.N = (int)v[4], d.L = (int)v[5], d.c = (int)v[6];
  d.sxb = v[7], d.sxt = v[8], d.sxh = v[9], d.sdb = v[10], d.sdt = v[11];
  d.sdh = v[12], d.sbb = v[13], d.sbt = v[14], d.scb = v[15], d.sct = v[16];
  d.vec = (int)v[17];
  const int nt = (d.L + RB - 1) / RB;
  return d.L <= LMAX && d.P <= PMAX && d.N <= NMAX && d.B <= 65535 &&
         d.c <= 65535 && d.c == (d.T + d.L - 1) / d.L &&
         (long long)nt * d.H <= 0x7fffffffLL &&
         (long long)d.P * d.N <= 0x7fffffffLL;
}

// Opt a kernel into `smem` bytes of dynamic shared memory (once per size
// step) and into the largest shared-memory carveout, so that the blocks per
// SM that the plan counts on fit.
template <typename K>
int opt_in(K* kernel, int smem, std::atomic<int>& opted) {
  if (smem <= opted.load()) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  int cur = opted.load();
  while (cur < smem && !opted.compare_exchange_weak(cur, smem)) {
  }
  return 0;
}

template <typename T>
int launch_cb(const void* Bm, const void* Cm, void* G, const Dims& d,
              int smem, cudaStream_t st) {
  static std::atomic<int> opted{48 * 1024};
  if (smem != smem_cb(d.L, d.P, d.N)) return (int)cudaErrorInvalidValue;
  if (int e = opt_in(&ssd_cb_kernel<T>, smem, opted)) return e;
  const int nt = (d.L + RB - 1) / RB;
  ssd_cb_kernel<T><<<dim3(nt * nt, d.c, d.B), THREADS, smem, st>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<float*>(G), d);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
int launch_states_nt(const void* x, const float* dt, const float* A,
                     const void* Bm, float* S, float* cum_end, const Dims& d,
                     int smem, cudaStream_t st) {
  static std::atomic<int> opted{48 * 1024};
  if (int e = opt_in(&ssd_states_kernel<T, NT>, smem, opted)) return e;
  ssd_states_kernel<T, NT><<<dim3(d.H, d.c, d.B), WIDE, smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), S, cum_end,
      d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_states(const void* x, const float* dt, const float* A,
                  const void* Bm, float* S, float* cum_end, const Dims& d,
                  int smem, cudaStream_t st) {
  if (smem != smem_states(d.L, d.P, d.N)) return (int)cudaErrorInvalidValue;
  if (d.N <= 64)
    return launch_states_nt<T, 8>(x, dt, A, Bm, S, cum_end, d, smem, st);
  return launch_states_nt<T, 16>(x, dt, A, Bm, S, cum_end, d, smem, st);
}

template <typename T>
int launch_out(const void* x, const float* dt, const float* A, const void* Cm,
               const float* G, const float* Hin, void* y, const Dims& d,
               int smem, cudaStream_t st) {
  static std::atomic<int> opted{48 * 1024};
  if (smem != smem_out(d.L, d.P, d.N)) return (int)cudaErrorInvalidValue;
  if (int e = opt_in(&ssd_out_kernel<T>, smem, opted)) return e;
  ssd_out_kernel<T><<<dim3(d.H, d.c, d.B), WIDE, smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Cm), G, Hin,
      static_cast<T*>(y), d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  smem: the pass's
// dynamic shared memory in bytes, as ssd_plan computes it.

extern "C" int ssd_cb_launch(const void* Bm, const void* Cm, void* G,
                             const long long* dims, int dtype, int smem,
                             void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cb<float>(Bm, Cm, G, d, smem, st);
  if (dtype == 1) return launch_cb<__nv_bfloat16>(Bm, Cm, G, d, smem, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssd_states_launch(const void* x, const void* dt, const void* A,
                                 const void* Bm, void* S, void* cum_end,
                                 const long long* dims, int dtype, int smem,
                                 void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* Sf = static_cast<float*>(S);
  float* cf = static_cast<float*>(cum_end);
  if (dtype == 0)
    return launch_states<float>(x, dtf, Af, Bm, Sf, cf, d, smem, st);
  if (dtype == 1)
    return launch_states<__nv_bfloat16>(x, dtf, Af, Bm, Sf, cf, d, smem, st);
  return (int)cudaErrorInvalidValue;
}

// h0 may be null (zero state).
extern "C" int ssd_state_pass_launch(const void* S, const void* cum_end,
                                     const void* h0, void* Hin, void* h_out,
                                     const long long* dims, void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  const int PN = d.P * d.N;
  const dim3 grid((PN + WIDE - 1) / WIDE, d.H, d.B);
  if (d.H > 65535) return (int)cudaErrorInvalidValue;
  ssd_state_pass_kernel<<<grid, WIDE, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const float*>(cum_end),
      static_cast<const float*>(h0), static_cast<float*>(Hin),
      static_cast<float*>(h_out), d.c, d.H, PN);
  return (int)cudaGetLastError();
}

extern "C" int ssd_out_launch(const void* x, const void* dt, const void* A,
                              const void* Cm, const void* G, const void* Hin,
                              void* y, const long long* dims, int dtype,
                              int smem, void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Gf = static_cast<const float*>(G);
  const float* Hf = static_cast<const float*>(Hin);
  if (dtype == 0)
    return launch_out<float>(x, dtf, Af, Cm, Gf, Hf, y, d, smem, st);
  if (dtype == 1)
    return launch_out<__nv_bfloat16>(x, dtf, Af, Cm, Gf, Hf, y, d, smem, st);
  return (int)cudaErrorInvalidValue;
}
