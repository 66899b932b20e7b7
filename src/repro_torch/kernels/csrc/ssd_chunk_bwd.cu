// Backward of the Mamba2 SSD chunk scan (csrc/ssd_chunk.cu) for sm_90a,
// plain C interface.  Given dy (B, T, H, P) and the final state's gradient
// dhT (B, H, P, N) (or none), it returns dx, ddt, dA, dB, dC and dh0.
//
// The reference has no backward kernel: its models differentiate the plain
// jnp ssd_chunked.  This is the reverse of the forward's four passes, each
// a kernel with a plain PyTorch version in kernels/ssd_chunk.py (the
// formulas are written out there).  The forward saves the causal C B^T of
// each chunk (G), the states entering each chunk (Hin) and each chunk's
// total decay (cum_end); the running sum of dA inside a chunk is recomputed
// here by the forward's own warp scan, so it is the forward's to the bit.
//
//   (4') out_bwd         grid (groups, c, B): a block walks `heads`
//                        consecutive heads of one (chunk, batch): dy, x,
//                        C, Hin of each -> the intra term's dx, dHin, the
//                        row terms of d(cum) and d(dt); dG and the
//                        incoming state's dC are summed over the block's
//                        heads on chip and written once per block
//   (3') state_pass_bwd  grid (H, B): the one walk over the chunks, last to
//                        first: dS per chunk, d(cum_end) through the carried
//                        state, dh0
//   (2') states_bwd      grid (groups, c, B): dS -> dx (added to the intra
//                        term's), d(cum) gathered into ddt and the chunk's
//                        share of dA by a reverse warp scan over the rows;
//                        dB's share summed over the block's heads on chip
//   (1') cb_bwd          grid (2 ceil(L / 16), c, B): 16 rows of dC or of dB
//                        per block: the groups' dG summed, dG B or dG^T C,
//                        plus the groups' dC or dB shares; block (0, 0, 0)
//                        also sums dA over batch and chunks
//
// Bound: the products and the bytes about equally at the model's shape
// (3xTF32 at 495/3 TFLOP/s and x, dy, Hin, dS, dx at 3.35 TB/s: ~0.04 ms
// each; each head's share of the sums never reaches device memory).
// Every product runs on the tensor cores as 3xTF32 (ssd_common.cuh: hi =
// tf32(v), lo = v - hi, lo*hi + hi*lo + hi*hi accumulated in f32 by
// mma.sync.m16n8k8): dy x^T and M^T dy (causal L x L x P), dHin =
// (e^cum dy)^T C and dC's share (e^cum dy) Hin, x dS and B dS^T
// (L x P x N), dG B and dG^T C (causal L x L x N).  One TF32 mma.sync has
// ~32 cycles of latency against ~7 of issue interval and a warp issues in
// order, so a product over several tiles runs each of the three partial
// products over all of them before the next (mma_part), and out_bwd and
// states_bwd run 16 warps.  The heads' shares of dG never reach device
// memory: a warp keeps the same dG tiles in registers for every head of
// its block, and dC's and dB's shares go to a shared-memory accumulator,
// so only one partial per block (`groups` per chunk) is written.
// Operands are staged by cp.async with row strides
// that keep every fragment read conflict-free: a fragment whose
// contraction runs along the stored rows takes k in the order (2t, 2t + 1)
// (one float2 read, stride 8 mod 16), one whose contraction runs down the
// stored columns k in the order (t, t + 4) (stride 8 mod 16) or (2t, 2t + 1)
// (stride 4 mod 8); both operands of a product use the same order.
//
// Determinism: every sum is taken in a fixed order by a fixed thread (the
// heads in head order, the groups in group order, the shuffle reductions
// by a fixed pattern, the warps' shares in warp order), with no atomics,
// so two runs give the same bits whatever the scheduling.
//
// The decay exp(cum_l - cum_s) is formed inside the chunk for each (l, s),
// as the forward's out pass forms its decayed G, never as exp(cum_l) times
// exp(-cum_s), whose second factor overflows for heads that decay fast.
// bf16 x / Bm / Cm are widened on load; every gradient is written in f32
// (the caller casts).  Limits as the forward's: L <= 128, P <= 64,
// N <= 128.
//
// x, dt, Bm and Cm are read through the forward's strides (the same dims
// array); dy, G, Hin, cum_end and every output are contiguous f32.  Every
// entry point launches on the given stream, allocates nothing, does not
// synchronise and returns a cudaError_t (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ssd_common.cuh"  // 3xTF32, strides, staging, chunk_scan

namespace {

using namespace ssd;
using sgemm::cp_commit;
using sgemm::cp_wait;

constexpr int WIDE = 256;  // state_pass_bwd, cb_bwd: 8 warps
constexpr int BIG = 512;   // out_bwd, states_bwd: 16 warps
constexpr int RT = 16;     // cb_bwd: rows of dB or dC per block
constexpr int KMAX = (PMAX * NMAX + WIDE - 1) / WIDE;  // state elements/thread
constexpr int NSMALL = 17;  // out_bwd: rows of LMAX floats after the tiles

struct Dims {
  int B, T, H, P, N, L, c;
  long long sxb, sxt, sxh;  // x strides (p stride 1)
  long long sdb, sdt, sdh;  // dt strides
  long long sbb, sbt;       // Bm strides (n stride 1)
  long long scb, sct;       // Cm strides
  int vec;                  // VEC_*: those rows load as 4-element quads
};

bool parse(const long long* v, Dims& d) {
  for (int i = 0; i < 7; ++i)
    if (v[i] < 1 || v[i] > 0x7fffffffLL) return false;
  d.B = (int)v[0], d.T = (int)v[1], d.H = (int)v[2], d.P = (int)v[3];
  d.N = (int)v[4], d.L = (int)v[5], d.c = (int)v[6];
  d.sxb = v[7], d.sxt = v[8], d.sxh = v[9], d.sdb = v[10], d.sdt = v[11];
  d.sdh = v[12], d.sbb = v[13], d.sbt = v[14], d.scb = v[15], d.sct = v[16];
  d.vec = (int)v[17];
  return d.L <= LMAX && d.P <= PMAX && d.N <= NMAX && d.B <= 65535 &&
         d.c <= 65535 && d.H <= 65535 && d.c == (d.T + d.L - 1) / d.L;
}

// Shared memory (floats, then bytes) of each pass;
// kernels/ssd_chunk.py::ssd_bwd_plan holds the same formulas.
//   out_bwd:    X (x, then Hin), U (G turned into M, then C), dy, the dC
//               accumulator and NSMALL rows of LMAX
//   states_bwd: x, B, dS, the dB accumulator and 8 rows of LMAX
//   cb_bwd:     B or C, and the summed dG rows or columns
__host__ __device__ inline int out_bwd_x(int L, int P, int N) {
  const int a = up(L, 16) * stride_b(P), h = up(P, 8) * stride_a(N);
  return a > h ? a : h;
}
__host__ __device__ inline int out_bwd_u(int L, int P, int N) {
  return up(L, 16) * (L > N ? stride_b(L) : stride_b(N));
}
inline int smem_out_bwd(int L, int P, int N) {
  const int l16 = up(L, 16);
  return 4 * (out_bwd_x(L, P, N) + out_bwd_u(L, P, N) + l16 * stride_b(P) +
              l16 * stride_b(N) + NSMALL * LMAX);
}
inline int smem_states_bwd(int L, int P, int N) {
  const int l16 = up(L, 16), sb = stride_b(N);
  return 4 * (l16 * stride_a(P) + 2 * l16 * sb + up(P, 8) * sb + 8 * LMAX);
}
inline int smem_cb_bwd(int L, int P, int N) {
  const int l16 = up(L, 16), r = RT * stride_a(L), c = l16 * stride_b(RT);
  return 4 * (l16 * stride_b(N) + (r > c ? r : c));
}

// ---- fragments ------------------------------------------------------------------
// g = lane / 4, t = lane % 4.  A fragment (16 x 8 at rows m0, k0), B
// fragment (8 x 8 at k0, columns n0), each split into its TF32 high and low
// parts.  "rows": the contraction runs along X's rows; "cols": down X's
// columns.  The _p forms take k in the order (2t, 2t + 1).

__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  split(a0, h[0], l[0]);
  split(a1, h[1], l[1]);
  split(a2, h[2], l[2]);
  split(a3, h[3], l[3]);
}
__device__ __forceinline__ void split2(float b0, float b1, uint32_t (&h)[2],
                                       uint32_t (&l)[2]) {
  split(b0, h[0], l[0]);
  split(b1, h[1], l[1]);
}
// A(m, k) = X[m S + k], S = 4 mod 8
__device__ __forceinline__ void a_rows(const float* X, int S, int m0, int k0,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = X + (m0 + g) * S + k0 + t;
  split4(p[0], p[8 * S], p[4], p[8 * S + 4], h, l);
}
// A(m, k) = X[m S + k], S = 8 mod 16, k in the order (2t, 2t + 1)
__device__ __forceinline__ void a_rows_p(const float* X, int S, int m0, int k0,
                                         uint32_t (&h)[4], uint32_t (&l)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = X + (m0 + g) * S + k0 + 2 * t;
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 w = *reinterpret_cast<const float2*>(p + 8 * S);
  split4(u.x, w.x, u.y, w.y, h, l);
}
// A(m, k) = X[k S + m], S = 8 mod 16
__device__ __forceinline__ void a_cols(const float* X, int S, int m0, int k0,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = X + (k0 + t) * S + m0 + g;
  split4(p[0], p[8], p[4 * S], p[4 * S + 8], h, l);
}
// B(k, n) = X[k S + n], S = 8 mod 16
__device__ __forceinline__ void b_cols(const float* X, int S, int n0, int k0,
                                       uint32_t (&h)[2], uint32_t (&l)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = X + (k0 + t) * S + n0 + g;
  split2(p[0], p[4 * S], h, l);
}
// B(k, n) = X[k S + n], S = 4 mod 8, k in the order (2t, 2t + 1)
__device__ __forceinline__ void b_cols_p(const float* X, int S, int n0,
                                         int k0, uint32_t (&h)[2],
                                         uint32_t (&l)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = X + (k0 + 2 * t) * S + n0 + g;
  split2(p[0], p[S], h, l);
}
// B(k, n) = X[n S + k], S = 8 mod 16, k in the order (2t, 2t + 1)
__device__ __forceinline__ void b_rows_p(const float* X, int S, int n0,
                                         int k0, uint32_t (&h)[2],
                                         uint32_t (&l)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float2 u =
      *reinterpret_cast<const float2*>(X + (n0 + g) * S + k0 + 2 * t);
  split2(u.x, u.y, h, l);
}
// Part `pass` of d += a b in 3xTF32: 0 and 1 the two small cross terms,
// 2 the high parts' product.  A product over several tiles runs pass 0 on
// every tile, then pass 1, then pass 2: consecutive tensor-core
// instructions then touch different accumulators, and a warp, which issues
// in order, does not wait out one instruction's latency (~32 cycles, 5x
// its issue interval) before the next.
__device__ __forceinline__ void mma_part(float (&d)[4], int pass,
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  if (pass == 0)
    mma_tf32(d, al, bh[0], bh[1]);
  else if (pass == 1)
    mma_tf32(d, ah, bl[0], bl[1]);
  else
    mma_tf32(d, ah, bh[0], bh[1]);
}
// acc[j] += a b[j] for j < n, the three passes over all the tiles
template <int NT>
__device__ __forceinline__ void mma3_tiles(float (&acc)[NT][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2],
                                           int n) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < n) mma_part(acc[j], pass, ah, al, bh[j], bl[j]);
}

// v summed over the four lanes of a fragment row (the lanes of one g)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum of v over the block, the same bits every run: a butterfly inside
// each warp, then the warps' sums in warp order by thread 0.  Returns the
// sum in thread 0; red holds WIDE / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < WIDE / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// ---- (4') out_bwd --------------------------------------------------------------

// One 16 x 8 tile of dM = dy x^T at rows m0 (l), columns n0 (s), m-tile mi:
// its share of dG into gacc, G turned into M = G o E o dt_s in place in Ms,
// Z = R o dt_s summed into this thread's rows (zrow), and R's column sums
// over the tile's 16 rows into colr[mi], with E = exp(cum_l - cum_s),
// R = dM o G o E, zero above the diagonal and past L.  Every load first,
// then selects: no branch between a load and its use.
__device__ __forceinline__ void dm_tile(const float (&acc)[4],
                                        float (&gacc)[4], int m0, int n0,
                                        int mi, int L, const float* cum,
                                        const float* dts, float* Ms, int SM,
                                        float* colr, float (&zrow)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int l0 = m0 + g, s0 = n0 + 2 * t;
  const float cl[2] = {cum[l0], cum[l0 + 8]};
  const float cs[2] = {cum[s0], cum[s0 + 1]}, ds[2] = {dts[s0], dts[s0 + 1]};
  float2* p0 = reinterpret_cast<float2*>(Ms + l0 * SM + s0);
  float2* p1 = reinterpret_cast<float2*>(Ms + (l0 + 8) * SM + s0);
  const float2 g0 = *p0, g1 = *p1;
  const float gv[4] = {g0.x, g0.y, g1.x, g1.y};
  float m[4], r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + 8 * (i >> 1), s = s0 + (i & 1);
    const float e = expf(cl[i >> 1] - cs[i & 1]);
    const float E = s <= l && l < L ? e : 0.f;
    gacc[i] += acc[i] * E * ds[i & 1];
    m[i] = gv[i] * E * ds[i & 1];
    r[i] = acc[i] * gv[i] * E;
    zrow[i >> 1] += r[i] * ds[i & 1];
  }
  *p0 = make_float2(m[0], m[1]);
  *p1 = make_float2(m[2], m[3]);
  float cr[2] = {r[0] + r[2], r[1] + r[3]};
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    cr[0] += __shfl_xor_sync(0xffffffffu, cr[0], o);
    cr[1] += __shfl_xor_sync(0xffffffffu, cr[1], o);
  }
  if (g == 0) {
    colr[mi * LMAX + s0] = cr[0];
    colr[mi * LMAX + s0 + 1] = cr[1];
  }
}

// One 16 x 8 tile of an (L, L) f32 matrix at rows m0, columns n0, rows
// and columns past L dropped.
__device__ __forceinline__ void put_tile(float* out, const float (&v)[4],
                                         int m0, int n0, int L) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const int l = m0 + g + 4 * i, s = n0 + 2 * t;
    if (l < L && s < L)
      store2(out + l * L + s, v[i], v[i + 1], s + 1 < L, L % 2 == 0);
  }
}

// 16 warps; warp w = 4 r + a.  dM's causal tiles: m-tiles a (lo) and 7 - a
// (hi), columns 8 (r + 4q), q < 2 (lo) and q < 4 (hi): 4.5 tiles a warp at
// L = 128, the same every head, so the heads' dG stays in the warp's
// registers.  Tiles past the diagonal or past L are multiplied (on clamped
// operands) and never used, so the product has no branch.  dx = M^T dy:
// s-tiles {a, 7 - a}, p-tiles 2r, 2r + 1.  dHin: p-tile a, a quarter r of
// the n-tiles.  dC's share: l-tile w % 8, a half w / 8 of the n-tiles.
// NT: n-tiles of N (8 or 16).
template <typename T, int NT>
__global__ void __launch_bounds__(BIG, 1)
ssd_out_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Cm,
                   const float* __restrict__ G, const float* __restrict__ Hin,
                   const float* __restrict__ dy, float* __restrict__ dx,
                   float* __restrict__ dGp, float* __restrict__ dCp,
                   float* __restrict__ dHin, float* __restrict__ dcum,
                   float* __restrict__ ddt, const Dims d, const int heads) {
  constexpr int NQ = NT / 4, NH = NT / 2;
  extern __shared__ __align__(16) float smem[];
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int L = d.L, P = d.P, N = d.N, H = d.H;
  const int t0 = c * L, len = min(L, d.T - t0);
  const int L8 = up(L, 8), L16 = up(L, 16), P8 = up(P, 8), P16 = up(P, 16);
  const int N8 = up(N, 8), N16 = up(N, 16);
  const int SD = stride_b(P), SM = stride_b(L), SC = stride_b(N),
            SH = stride_a(N);
  float* Xs = smem;                           // [L16][SD] x, [P8][SH] Hin
  float* U = Xs + out_bwd_x(L, P, N);         // [L16][SM] G, M; [L16][SC] C
  float* Ds = U + out_bwd_u(L, P, N);         // [L16][SD] dy, then e^cum dy
  float* Acc = Ds + L16 * SD;                 // [L16][SC] dC's share
  float* cum = Acc + L16 * SC;                // LMAX each
  float* dts = cum + LMAX;
  float* ecm = dts + LMAX;                    // exp(cum)
  float* rowz = ecm + LMAX;                   // [4][LMAX] Z's row sums
  float* colr = rowz + 4 * LMAX;              // [8][LMAX] R's column sums
  float* rowc = colr + 8 * LMAX;              // [2][LMAX] the state's row term
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int a = warp & 3, r = warp >> 2;
  const int mlo = 16 * a, mhi = 16 * (7 - a);
  const bool lo_on = mlo < L16, hi_on = mhi < L16;
  const int mlo_c = min(mlo, L16 - 16), mhi_c = min(mhi, L16 - 16);
  const long long bc = (long long)b * d.c + c;
  const long long dyrow = (long long)H * P;
  const float* Gc = G + bc * L * L;
  const int ntn = N8 / 8, ntp = P8 / 8;
  auto lo_tile = [&](int q) {
    const int nj = r + 4 * q;
    return lo_on && nj <= 2 * a + 1 && 8 * nj < L;
  };
  auto hi_tile = [&](int q) {
    const int nj = r + 4 * q;
    return hi_on && nj <= 15 - 2 * a && 8 * nj < L;
  };

  for (int e = tid; e < L16 * SC; e += BIG) Acc[e] = 0.f;
  float gl[2][4] = {}, gh[4][4] = {};  // this warp's tiles of the heads' dG

  const int h_end = min(H, (grp + 1) * heads);
  for (int h = grp * heads; h < h_end; ++h) {
    const long long bch = bc * H + h;
    __syncthreads();  // the previous head is done with every buffer
    stage(Xs, SD, x + b * d.sxb + t0 * d.sxt + h * d.sxh, d.sxt, len, P, L16,
          P16, d.vec & VEC_X);
    stage(Ds, SD, dy + ((long long)b * d.T + t0) * dyrow + (long long)h * P,
          dyrow, len, P, L16, P16, P % 4 == 0);
    stage(U, SM, Gc, (long long)L, L, L, L16, L16, L % 4 == 0);
    cp_commit();
    if (warp == 0)
      chunk_scan(dt + b * d.sdb + t0 * d.sdt + h * d.sdh, d.sdt, len, A[h],
                 cum, dts);
    cp_wait<0>();
    __syncthreads();
    if (tid < LMAX) ecm[tid] = expf(cum[tid]);

    // dM = dy x^T on the warp's causal tiles
    float ml[2][4] = {}, mh[4][4] = {};
    for (int k = 0; k < P8; k += 8) {
      uint32_t lh[4], ll[4], hh[4], hl[4], bh[4][2], bl[4][2];
      a_rows_p(Ds, SD, mlo_c, k, lh, ll);
      a_rows_p(Ds, SD, mhi_c, k, hh, hl);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b_rows_p(Xs, SD, min(8 * (r + 4 * q), L16 - 8), k, bh[q], bl[q]);
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          mma_part(ml[q], pass, lh, ll, bh[q], bl[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_part(mh[q], pass, hh, hl, bh[q], bl[q]);
      }
    }
    __syncthreads();  // every warp is done with x: Hin takes its place
    float* Hs = Xs;   // [P8][SH]
    stage(Hs, SH, Hin + bch * P * N, (long long)N, P, N, P8, N8, N % 4 == 0);
    cp_commit();
    float* Ms = U;
    float zr[2][2] = {};
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (lo_tile(q))
        dm_tile(ml[q], gl[q], mlo, 8 * (r + 4 * q), a, L, cum, dts, Ms, SM,
                colr, zr[0]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (hi_tile(q))
        dm_tile(mh[q], gh[q], mhi, 8 * (r + 4 * q), 7 - a, L, cum, dts, Ms,
                SM, colr, zr[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float z0 = quad_sum(zr[i][0]), z1 = quad_sum(zr[i][1]);
      const int m0 = i == 0 ? mlo : mhi;
      if (t == 0 && m0 < L16) {
        rowz[r * LMAX + m0 + g] = z0;
        rowz[r * LMAX + m0 + g + 8] = z1;
      }
    }
    __syncthreads();

    // the intra term's dx = M^T dy; rows l < s add nothing, so the s-tile
    // 7 - a joins at k = 16 (7 - a)
    if (lo_on) {
      float acc[2][2][4] = {};
      const int jb = 2 * r;
      const int pc[2] = {8 * min(jb, ntp - 1), 8 * min(jb + 1, ntp - 1)};
      const int kmid = hi_on ? mhi : L8;
      for (int k = mlo; k < kmid; k += 8) {
        uint32_t ah[4], al[4], bh[2][2], bl[2][2];
        a_cols(Ms, SM, mlo, k, ah, al);
#pragma unroll
        for (int j = 0; j < 2; ++j) b_cols(Ds, SD, pc[j], k, bh[j], bl[j]);
        mma3_tiles(acc[0], ah, al, bh, bl, 2);
      }
      for (int k = kmid; k < L8; k += 8) {
        uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
        a_cols(Ms, SM, mlo, k, ah[0], al[0]);
        a_cols(Ms, SM, mhi, k, ah[1], al[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) b_cols(Ds, SD, pc[j], k, bh[j], bl[j]);
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mma_part(acc[mi][j], pass, ah[mi], al[mi], bh[j], bl[j]);
      }
      float* dxo = dx + ((long long)b * d.T + t0) * dyrow + (long long)h * P;
      const int ms[2] = {mlo, mhi};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; i += 2) {
            const int s = ms[mi] + g + 4 * i, p = 8 * (jb + j) + 2 * t;
            if (jb + j < ntp && s < len && p < P)
              store2(dxo + s * dyrow + p, acc[mi][j][i], acc[mi][j][i + 1],
                   p + 1 < P, P % 2 == 0);
          }
    }
    __syncthreads();  // done with M: C takes its place

    float* Cs = U;  // [L16][SC]
    stage(Cs, SC, Cm + b * d.scb + t0 * d.sct, d.sct, len, N, L16, N16,
          d.vec & VEC_C);
    cp_commit();
    for (int e = tid; e < L16 * P16; e += BIG) {
      const int l = e / P16;
      Ds[l * SD + e - l * P16] *= ecm[l];
    }
    cp_wait<0>();
    __syncthreads();

    // dHin = (e^cum dy)^T C: p-tile a, the quarter r of the n-tiles
    if (mlo < P16) {
      const int jb = r * NQ;
      float acc[NQ][4] = {};
      for (int k = 0; k < L8; k += 8) {
        uint32_t ah[4], al[4], bh[NQ][2], bl[NQ][2];
        a_cols(Ds, SD, mlo, k, ah, al);
#pragma unroll
        for (int j = 0; j < NQ; ++j)
          b_cols(Cs, SC, 8 * min(jb + j, ntn - 1), k, bh[j], bl[j]);
        mma3_tiles(acc, ah, al, bh, bl, NQ);
      }
      float* dHo = dHin + bch * P * N;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int p = mlo + g + 4 * i, n = 8 * (jb + j) + 2 * t;
          if (p < P && n < N)
            store2(dHo + p * N + n, acc[j][i], acc[j][i + 1], n + 1 < N,
                 N % 2 == 0);
        }
    }
    // dC's share (e^cum dy) Hin into the accumulator, and the state's row
    // term of d(cum), sum_n C[l, n] dC[l, n]: l-tile w % 8, half w / 8 of
    // the n-tiles
    if (16 * (warp & 7) < L16) {
      const int m0 = 16 * (warp & 7), jb = (warp >> 3) * NH;
      float acc[NH][4] = {};
      for (int k = 0; k < P8; k += 8) {
        uint32_t ah[4], al[4], bh[NH][2], bl[NH][2];
        a_rows_p(Ds, SD, m0, k, ah, al);
#pragma unroll
        for (int j = 0; j < NH; ++j)
          b_cols_p(Hs, SH, 8 * min(jb + j, ntn - 1), k, bh[j], bl[j]);
        mma3_tiles(acc, ah, al, bh, bl, NH);
      }
      float rc[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        if (jb + j >= ntn) continue;
        const int n = 8 * (jb + j) + 2 * t;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int l = m0 + g + 8 * q;
          const float2 cv = *reinterpret_cast<const float2*>(Cs + l * SC + n);
          rc[q] += cv.x * acc[j][2 * q] + cv.y * acc[j][2 * q + 1];
          float2* pa = reinterpret_cast<float2*>(Acc + l * SC + n);
          float2 v = *pa;
          v.x += acc[j][2 * q];
          v.y += acc[j][2 * q + 1];
          *pa = v;
        }
      }
      const float r0 = quad_sum(rc[0]), r1 = quad_sum(rc[1]);
      if (t == 0) {
        rowc[(warp >> 3) * LMAX + m0 + g] = r0;
        rowc[(warp >> 3) * LMAX + m0 + g + 8] = r1;
      }
    }
    __syncthreads();
    for (int l = tid; l < L; l += BIG) {
      float cr = 0.f;
      for (int mi = l / 16; mi < L16 / 16; ++mi) cr += colr[mi * LMAX + l];
      const float rz = rowz[l] + rowz[LMAX + l] + rowz[2 * LMAX + l] +
                       rowz[3 * LMAX + l];
      dcum[bch * L + l] = rz - cr * dts[l] + (rowc[l] + rowc[LMAX + l]);
      ddt[bch * L + l] = cr;
    }
  }
  __syncthreads();  // the dC accumulator is complete

  // this block's partial sums: dG (zero above the diagonal) and dC's share
  float* dGo = dGp + (bc * gridDim.x + grp) * L * L;
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (lo_tile(q)) put_tile(dGo, gl[q], mlo, 8 * (r + 4 * q), L);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (hi_tile(q)) put_tile(dGo, gh[q], mhi, 8 * (r + 4 * q), L);
  for (int e = tid; e < L * L; e += BIG) {
    const int l = e / L, s = e - l * L;
    if (s >= l / 16 * 16 + 16) dGo[e] = 0.f;  // above the warps' tiles
  }
  float* dCo = dCp + (bc * gridDim.x + grp) * L * N;
  for (int e = tid; e < L * N; e += BIG) {
    const int l = e / N;
    dCo[e] = Acc[l * SC + e - l * N];
  }
}

// ---- (3') state_pass_bwd -----------------------------------------------------

__global__ void __launch_bounds__(WIDE)
ssd_state_pass_bwd_kernel(const float* __restrict__ Hin,
                          const float* __restrict__ cum_end,
                          const float* __restrict__ dHin,
                          const float* __restrict__ dhT, float* __restrict__ dS,
                          float* __restrict__ dce, float* __restrict__ dh0,
                          int nc, int H, int PN) {
  __shared__ float red[WIDE / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  float g[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int e = threadIdx.x + k * WIDE;
    g[k] = (dhT != nullptr && e < PN)
               ? dhT[((long long)b * H + h) * PN + e] : 0.f;
  }
  for (int j = nc - 1; j >= 0; --j) {
    const long long bjh = ((long long)b * nc + j) * H + h;
    const float a = expf(cum_end[bjh]);
    const long long base = bjh * PN;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int e = threadIdx.x + k * WIDE;
      if (e < PN) {
        dS[base + e] = g[k];
        part += g[k] * Hin[base + e];
        g[k] = dHin[base + e] + g[k] * a;
      }
    }
    const float tot = block_sum(part, red);
    if (threadIdx.x == 0) dce[bjh] = tot * a;
  }
  if (dh0 != nullptr) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int e = threadIdx.x + k * WIDE;
      if (e < PN) dh0[((long long)b * H + h) * PN + e] = g[k];
    }
  }
}

// ---- (2') states_bwd ----------------------------------------------------------

// 16 warps; warp w owns rows s in [16 (w % 8), +16) and the half w / 8 of
// the columns of both products: V = x dS (n-tiles) and W = B dS^T
// (p-tiles).  NT: n-tiles of N (8 or 16).
template <typename T, int NT>
__global__ void __launch_bounds__(BIG, 1)
ssd_states_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const float* __restrict__ dS,
                      const float* __restrict__ dcum_o,
                      const float* __restrict__ ddt_o,
                      const float* __restrict__ dce, float* __restrict__ dx,
                      float* __restrict__ dBp, float* __restrict__ ddt,
                      float* __restrict__ dA_part, const Dims d,
                      const int heads) {
  constexpr int NH = NT / 2;
  extern __shared__ __align__(16) float smem[];
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int L = d.L, P = d.P, N = d.N, H = d.H;
  const int t0 = c * L, len = min(L, d.T - t0);
  const int L16 = up(L, 16), P8 = up(P, 8), N8 = up(N, 8);
  const int SX = stride_a(P), SB = stride_b(N);
  float* Xs = smem;               // [L16][SX] x
  float* Bs = Xs + L16 * SX;      // [L16][SB] B
  float* Ss = Bs + L16 * SB;      // [P8][SB] dS
  float* Acc = Ss + P8 * SB;      // [L16][SB] dB's share
  float* cum = Acc + L16 * SB;    // LMAX each
  float* dts = cum + LMAX;
  float* w = dts + LMAX;          // exp(cum_end - cum_s) dt_s
  float* ex = w + LMAX;           // exp(cum_end - cum_s)
  float* dw = ex + LMAX;          // [2][LMAX] B_s . V_s, by half
  float* dco = dw + 2 * LMAX;     // dcum_o of the head
  float* dto = dco + LMAX;        // ddt_o of the head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, m0 = 16 * (warp & 7), half = warp >> 3;
  const long long bc = (long long)b * d.c + c;
  const long long xrow = (long long)H * P;
  const int ntn = N8 / 8, ntp = P8 / 8;

  stage(Bs, SB, Bm + b * d.sbb + t0 * d.sbt, d.sbt, len, N, L16, N8,
        d.vec & VEC_B);
  for (int e = tid; e < L16 * SB; e += BIG) Acc[e] = 0.f;

  const int h_end = min(H, (grp + 1) * heads);
  for (int h = grp * heads; h < h_end; ++h) {
    const long long bch = bc * H + h;
    __syncthreads();  // the previous head is done with every buffer
    stage(Xs, SX, x + b * d.sxb + t0 * d.sxt + h * d.sxh, d.sxt, len, P, L16,
          P8, d.vec & VEC_X);
    stage(Ss, SB, dS + bch * P * N, (long long)N, P, N, P8, N8, N % 4 == 0);
    stage(dco, LMAX, dcum_o + bch * L, 0, 1, L, 1, up(L, 4), L % 4 == 0);
    stage(dto, LMAX, ddt_o + bch * L, 0, 1, L, 1, up(L, 4), L % 4 == 0);
    cp_commit();
    if (warp == 0)
      chunk_scan(dt + b * d.sdb + t0 * d.sdt + h * d.sdh, d.sdt, len, A[h],
                 cum, dts);
    cp_wait<0>();
    __syncthreads();
    for (int s = tid; s < LMAX; s += BIG) {
      ex[s] = s < L ? expf(cum[L - 1] - cum[s]) : 0.f;
      w[s] = ex[s] * dts[s];
    }
    __syncthreads();

    if (m0 < L16) {
      // V = x dS: w o V is dB's share, B_s . V_s is dw
      {
        const int jb = half * NH;
        float acc[NH][4] = {};
#pragma unroll 2
        for (int k = 0; k < P8; k += 8) {
          uint32_t ah[4], al[4], bh[NH][2], bl[NH][2];
          a_rows(Xs, SX, m0, k, ah, al);
#pragma unroll
          for (int j = 0; j < NH; ++j)
            b_cols(Ss, SB, 8 * min(jb + j, ntn - 1), k, bh[j], bl[j]);
          mma3_tiles(acc, ah, al, bh, bl, NH);
        }
        float dwp[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          if (jb + j >= ntn) continue;
          const int n = 8 * (jb + j) + 2 * t;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int s = m0 + g + 8 * q;
            const float2 bv = *reinterpret_cast<const float2*>(Bs + s * SB + n);
            dwp[q] += bv.x * acc[j][2 * q] + bv.y * acc[j][2 * q + 1];
            float2* pa = reinterpret_cast<float2*>(Acc + s * SB + n);
            float2 v = *pa;
            v.x += w[s] * acc[j][2 * q];
            v.y += w[s] * acc[j][2 * q + 1];
            *pa = v;
          }
        }
        const float d0 = quad_sum(dwp[0]), d1 = quad_sum(dwp[1]);
        if (t == 0) {
          dw[half * LMAX + m0 + g] = d0;
          dw[half * LMAX + m0 + g + 8] = d1;
        }
      }
      // dx += w o (B dS^T), the intra term's dx read before the product
      const int jb = 4 * half;
      float* dxo = dx + ((long long)b * d.T + t0) * xrow + (long long)h * P;
      float dxv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = m0 + g + 8 * (i >> 1), p = 8 * (jb + j) + 2 * t + (i & 1);
          dxv[j][i] = jb + j < ntp && s < len && p < P ? dxo[s * xrow + p]
                                                       : 0.f;
        }
      float acc[4][4] = {};
#pragma unroll 2
      for (int k = 0; k < N8; k += 8) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        a_rows_p(Bs, SB, m0, k, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b_rows_p(Ss, SB, 8 * min(jb + j, ntp - 1), k, bh[j], bl[j]);
        mma3_tiles(acc, ah, al, bh, bl, 4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int s = m0 + g + 8 * q, p = 8 * (jb + j) + 2 * t;
          if (jb + j < ntp && s < len && p < P)
            store2(dxo + s * xrow + p, dxv[j][2 * q] + w[s] * acc[j][2 * q],
                 dxv[j][2 * q + 1] + w[s] * acc[j][2 * q + 1], p + 1 < P,
                 P % 2 == 0);
        }
    }
    __syncthreads();
    // d(cum), its reverse running sum over the chunk (the gradient of
    // dA = dt A), ddt and this chunk's share of dA, by warp 0: lane i owns
    // rows 4i..4i+3
    if (warp == 0) {
      float dws[4], dww[4], v[4], part = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 4 * lane + i;
        dws[i] = dw[s] + dw[LMAX + s];
        dww[i] = s < L ? dws[i] * w[s] : 0.f;
        part += dww[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      const float last = dce[bch] + part;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 4 * lane + i;
        v[i] = s < L ? dco[s] - dww[i] + (s == L - 1 ? last : 0.f) : 0.f;
      }
      v[2] += v[3];
      v[1] += v[2];
      v[0] += v[1];
      float incl = v[0];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += n;
      }
      float excl = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) excl = 0.f;
      const float ah = A[h];
      float da = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 4 * lane + i;
        const float rc = v[i] + excl;
        da += rc * dts[s];
        if (s < len)
          ddt[((long long)b * d.T + t0 + s) * H + h] =
              dto[s] + dws[i] * ex[s] + rc * ah;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        da += __shfl_xor_sync(0xffffffffu, da, o);
      if (lane == 0) dA_part[bch] = da;
    }
  }
  __syncthreads();
  float* dBo = dBp + (bc * gridDim.x + grp) * L * N;
  for (int e = tid; e < L * N; e += BIG) {
    const int l = e / N;
    dBo[e] = Acc[l * SB + e - l * N];
  }
}

// ---- (1') cb_bwd ---------------------------------------------------------------

// Block x < ceil(L / 16): rows r0.. of dC = sum_g dC_g + dG B; else rows
// r0.. of dB = sum_g dB_g + dG^T C.  Warp w owns the n-tiles w and w + 8.
template <typename T>
__global__ void __launch_bounds__(WIDE)
ssd_cb_bwd_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ dGp, const float* __restrict__ dBp,
                  const float* __restrict__ dCp,
                  const float* __restrict__ dA_part, float* __restrict__ dB,
                  float* __restrict__ dC, float* __restrict__ dA,
                  const Dims d, const int ng) {
  extern __shared__ __align__(16) float smem[];
  const int L = d.L, N = d.N, H = d.H;
  const int nt = (L + RT - 1) / RT;
  const int which = blockIdx.x / nt;  // 0: rows of dC, 1: rows of dB
  const int r0 = (blockIdx.x - which * nt) * RT;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * L, len = min(L, d.T - t0);
  const int L8 = up(L, 8), L16 = up(L, 16), N8 = up(N, 8);
  const int SO = stride_b(N), SG = stride_a(L), SGC = stride_b(RT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Os = smem;            // [L16][SO]: B for dC's rows, C for dB's
  float* Gs = Os + L16 * SO;   // dG's rows [RT][SG] or columns [L8][SGC]
  const long long bc = (long long)b * d.c + c, gsz = (long long)L * L;
  const float* dG0 = dGp + bc * ng * gsz;
  const int kc = min(L, r0 + RT);
  if (which == 0) {
    stage(Os, SO, Bm + b * d.sbb + t0 * d.sbt, d.sbt, len, N, L16, N8,
          d.vec & VEC_B);
    cp_commit();
    const int KC = up(kc, 8);
    for (int e = tid; e < RT * KC; e += WIDE) {
      const int i = e / KC, s = e - i * KC, r = r0 + i;
      float v = 0.f;
      if (r < L && s < kc)
        for (int q = 0; q < ng; ++q) v += dG0[q * gsz + r * L + s];
      Gs[i * SG + s] = v;
    }
  } else {
    stage(Os, SO, Cm + b * d.scb + t0 * d.sct, d.sct, len, N, L16, N8,
          d.vec & VEC_C);
    cp_commit();
    for (int e = tid; e < (L8 - r0) * RT; e += WIDE) {
      const int l = r0 + e / RT, j = e % RT;
      float v = 0.f;
      if (l < L && r0 + j < L)
        for (int q = 0; q < ng; ++q) v += dG0[q * gsz + l * L + r0 + j];
      Gs[l * SGC + j] = v;
    }
  }
  cp_wait<0>();
  __syncthreads();

  const int ntn = N8 / 8;
  const int kb = which == 0 ? 0 : r0, ke = which == 0 ? up(kc, 8) : L8;
  float acc[2][4] = {};
  const int nj = warp < ntn ? (warp + 8 < ntn ? 2 : 1) : 0;
#pragma unroll 2
  for (int k = kb; k < ke; k += 8) {
    uint32_t ah[4], al[4], bh[2][2], bl[2][2];
    if (which == 0)
      a_rows(Gs, SG, 0, k, ah, al);
    else
      a_cols(Gs, SGC, 0, k, ah, al);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      if (jj < nj) b_cols(Os, SO, 8 * (warp + 8 * jj), k, bh[jj], bl[jj]);
    mma3_tiles(acc, ah, al, bh, bl, nj);
  }
  const float* part = (which == 0 ? dCp : dBp) + bc * ng * L * N;
  float* out = (which == 0 ? dC : dB) + ((long long)b * d.T + t0) * N;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = warp + 8 * jj;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i >> 1), n = 8 * j + 2 * t + (i & 1);
      if (j < ntn && r < len && n < N) {
        float v = 0.f;
        for (int q = 0; q < ng; ++q) v += part[((long long)q * L + r) * N + n];
        out[(long long)r * N + n] = v + acc[jj][i];
      }
    }
  }
  if (blockIdx.x == 0 && c == 0 && b == 0) {
    for (int h = tid; h < H; h += WIDE) {
      float s = 0.f;
      for (int bb = 0; bb < d.B; ++bb)
        for (int cc = 0; cc < d.c; ++cc)
          s += dA_part[((long long)bb * d.c + cc) * H + h];
      dA[h] = s;
    }
  }
}

// Opt a kernel into `smem` bytes of dynamic shared memory (once per size
// step).
template <typename K>
int opt_in(K* kernel, int smem, std::atomic<int>& opted) {
  if (smem <= opted.load()) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int cur = opted.load();
  while (cur < smem && !opted.compare_exchange_weak(cur, smem)) {
  }
  return 0;
}

inline int groups(const Dims& d, int heads) {
  return heads >= 1 ? (d.H + heads - 1) / heads : 0;
}

template <typename T, int NT>
int launch_out_bwd_nt(const void* x, const float* dt, const float* A,
                      const void* Cm, const float* G, const float* Hin,
                      const float* dy, float* dx, float* dGp, float* dCp,
                      float* dHin, float* dcum, float* ddt, const Dims& d,
                      int heads, int smem, cudaStream_t st) {
  static std::atomic<int> opted{48 * 1024};
  if (int e = opt_in(&ssd_out_bwd_kernel<T, NT>, smem, opted)) return e;
  ssd_out_bwd_kernel<T, NT>
      <<<dim3(groups(d, heads), d.c, d.B), BIG, smem, st>>>(
          static_cast<const T*>(x), dt, A, static_cast<const T*>(Cm), G, Hin,
          dy, dx, dGp, dCp, dHin, dcum, ddt, d, heads);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_out_bwd(const void* x, const float* dt, const float* A,
                   const void* Cm, const float* G, const float* Hin,
                   const float* dy, float* dx, float* dGp, float* dCp,
                   float* dHin, float* dcum, float* ddt, const Dims& d,
                   int heads, int smem, cudaStream_t st) {
  if (smem != smem_out_bwd(d.L, d.P, d.N) || groups(d, heads) < 1)
    return (int)cudaErrorInvalidValue;
  if (d.N <= 64)
    return launch_out_bwd_nt<T, 8>(x, dt, A, Cm, G, Hin, dy, dx, dGp, dCp,
                                   dHin, dcum, ddt, d, heads, smem, st);
  return launch_out_bwd_nt<T, 16>(x, dt, A, Cm, G, Hin, dy, dx, dGp, dCp,
                                  dHin, dcum, ddt, d, heads, smem, st);
}

template <typename T, int NT>
int launch_states_bwd_nt(const void* x, const float* dt, const float* A,
                         const void* Bm, const float* dS, const float* dcum_o,
                         const float* ddt_o, const float* dce, float* dx,
                         float* dBp, float* ddt, float* dA_part,
                         const Dims& d, int heads, int smem, cudaStream_t st) {
  static std::atomic<int> opted{48 * 1024};
  if (int e = opt_in(&ssd_states_bwd_kernel<T, NT>, smem, opted)) return e;
  ssd_states_bwd_kernel<T, NT>
      <<<dim3(groups(d, heads), d.c, d.B), BIG, smem, st>>>(
          static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), dS,
          dcum_o, ddt_o, dce, dx, dBp, ddt, dA_part, d, heads);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_states_bwd(const void* x, const float* dt, const float* A,
                      const void* Bm, const float* dS, const float* dcum_o,
                      const float* ddt_o, const float* dce, float* dx,
                      float* dBp, float* ddt, float* dA_part, const Dims& d,
                      int heads, int smem, cudaStream_t st) {
  if (smem != smem_states_bwd(d.L, d.P, d.N) || groups(d, heads) < 1)
    return (int)cudaErrorInvalidValue;
  if (d.N <= 64)
    return launch_states_bwd_nt<T, 8>(x, dt, A, Bm, dS, dcum_o, ddt_o, dce,
                                      dx, dBp, ddt, dA_part, d, heads, smem,
                                      st);
  return launch_states_bwd_nt<T, 16>(x, dt, A, Bm, dS, dcum_o, ddt_o, dce, dx,
                                     dBp, ddt, dA_part, d, heads, smem, st);
}

template <typename T>
int launch_cb_bwd(const void* Bm, const void* Cm, const float* dGp,
                  const float* dBp, const float* dCp, const float* dA_part,
                  float* dB, float* dC, float* dA, const Dims& d, int ng,
                  int smem, cudaStream_t st) {
  static std::atomic<int> opted{48 * 1024};
  if (smem != smem_cb_bwd(d.L, d.P, d.N) || ng < 1 || ng > d.H)
    return (int)cudaErrorInvalidValue;
  if (int e = opt_in(&ssd_cb_bwd_kernel<T>, smem, opted)) return e;
  const int nt = (d.L + RT - 1) / RT;
  ssd_cb_bwd_kernel<T><<<dim3(2 * nt, d.c, d.B), WIDE, smem, st>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), dGp, dBp, dCp,
      dA_part, dB, dC, dA, d, ng);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, Bm, Cm): 0 = float32, 1 = bfloat16.  smem: the pass's dynamic
// shared memory in bytes, as ssd_bwd_plan computes it.  heads: heads per
// block of out_bwd and states_bwd; their grid has ceil(H / heads) groups,
// and dGp, dCp, dBp hold one partial sum per group: (B, c, groups, L, L)
// and (B, c, groups, L, N).

extern "C" int ssd_out_bwd_launch(const void* x, const void* dt, const void* A,
                                  const void* Cm, const void* G,
                                  const void* Hin, const void* dy, void* dx,
                                  void* dGp, void* dCp, void* dHin,
                                  void* dcum, void* ddt,
                                  const long long* dims, int dtype, int heads,
                                  int smem, void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_out_bwd<float>(x, f(dt), f(A), Cm, f(G), f(Hin), f(dy),
                                 o(dx), o(dGp), o(dCp), o(dHin), o(dcum),
                                 o(ddt), d, heads, smem, st);
  if (dtype == 1)
    return launch_out_bwd<__nv_bfloat16>(x, f(dt), f(A), Cm, f(G), f(Hin),
                                         f(dy), o(dx), o(dGp), o(dCp),
                                         o(dHin), o(dcum), o(ddt), d, heads,
                                         smem, st);
  return (int)cudaErrorInvalidValue;
}

// dhT and dh0 may be null (no final-state gradient, no initial state).
extern "C" int ssd_state_pass_bwd_launch(const void* Hin, const void* cum_end,
                                         const void* dHin, const void* dhT,
                                         void* dS, void* dce, void* dh0,
                                         const long long* dims, void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  ssd_state_pass_bwd_kernel<<<dim3(d.H, d.B), WIDE, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Hin), static_cast<const float*>(cum_end),
      static_cast<const float*>(dHin), static_cast<const float*>(dhT),
      static_cast<float*>(dS), static_cast<float*>(dce),
      static_cast<float*>(dh0), d.c, d.H, d.P * d.N);
  return (int)cudaGetLastError();
}

extern "C" int ssd_states_bwd_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* dS, const void* dcum_o,
                                     const void* ddt_o, const void* dce,
                                     void* dx, void* dBp, void* ddt,
                                     void* dA_part, const long long* dims,
                                     int dtype, int heads, int smem,
                                     void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_states_bwd<float>(x, f(dt), f(A), Bm, f(dS), f(dcum_o),
                                    f(ddt_o), f(dce), o(dx), o(dBp), o(ddt),
                                    o(dA_part), d, heads, smem, st);
  if (dtype == 1)
    return launch_states_bwd<__nv_bfloat16>(
        x, f(dt), f(A), Bm, f(dS), f(dcum_o), f(ddt_o), f(dce), o(dx), o(dBp),
        o(ddt), o(dA_part), d, heads, smem, st);
  return (int)cudaErrorInvalidValue;
}

// ng: the groups whose partial sums dGp, dBp, dCp hold.
extern "C" int ssd_cb_bwd_launch(const void* Bm, const void* Cm,
                                 const void* dGp, const void* dBp,
                                 const void* dCp, const void* dA_part,
                                 void* dB, void* dC, void* dA,
                                 const long long* dims, int dtype, int ng,
                                 int smem, void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_cb_bwd<float>(Bm, Cm, f(dGp), f(dBp), f(dCp), f(dA_part),
                                o(dB), o(dC), o(dA), d, ng, smem, st);
  if (dtype == 1)
    return launch_cb_bwd<__nv_bfloat16>(Bm, Cm, f(dGp), f(dBp), f(dCp),
                                        f(dA_part), o(dB), o(dC), o(dA), d,
                                        ng, smem, st);
  return (int)cudaErrorInvalidValue;
}
