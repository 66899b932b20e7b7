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
//   (4') out_bwd         grid (H, c, B): dy, x, G, C, Hin of one (chunk,
//                        head) -> the intra term's dx, this head's share of
//                        dG, dC and the incoming state's gradient dHin, and
//                        the row terms of d(cum) and d(dt)
//   (3') state_pass_bwd  grid (H, B): the one walk over the chunks, last to
//                        first: dS per chunk, d(cum_end) through the carried
//                        state, dh0
//   (2') states_bwd      grid (H, c, B): dS -> dx (added to the intra
//                        term's), this head's share of dB, and d(cum)
//                        gathered into ddt and the chunk's share of dA by a
//                        reverse running sum over the chunk's rows
//   (1') cb_bwd          grid (2 ceil(L / 16), c, B): 16 rows of dC or of dB
//                        per block, the heads' shares summed, plus dG's
//                        terms; block (0, 0, 0) also sums dA over batch and
//                        chunks
//
// Determinism: every sum is taken in a fixed order by a fixed thread (the
// heads' shares in head order, the block reductions by a fixed shuffle
// pattern and then warp by warp), with no atomics, so two runs give the
// same bits whatever the scheduling.
//
// Arithmetic: SIMT f32, the products staged in shared memory with odd row
// strides and computed in register tiles of 4 x 4 outputs a thread
// (tile4x4), so that a warp's reads fall in distinct banks and a
// multiply-add costs half a shared-memory read.  bf16 x / Bm / Cm
// are widened on load; every gradient is written in f32 (the caller casts).
// Limits as the forward's: L <= 128, P <= 64, N <= 128.
//
// x, dt, Bm and Cm are read through the forward's strides (the same dims
// array); dy, G, Hin, cum_end and every output are contiguous f32.  Every
// entry point launches on the given stream, allocates nothing, does not
// synchronise and returns a cudaError_t (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int LMAX = 128, PMAX = 64, NMAX = 128;
constexpr int WIDE = 256;  // every pass: 8 warps
constexpr int RT = 16;     // cb_bwd: rows of dB or dC per block
constexpr int KMAX = (PMAX * NMAX + WIDE - 1) / WIDE;  // state elements/thread

struct Dims {
  int B, T, H, P, N, L, c;
  long long sxb, sxt, sxh;  // x strides (p stride 1)
  long long sdb, sdt, sdh;  // dt strides
  long long sbb, sbt;       // Bm strides (n stride 1)
  long long scb, sct;       // Cm strides
  int vec;                  // unused here (the forward's copy widths)
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

// Shared memory (bytes) of each pass; kernels/ssd_chunk.py::ssd_bwd_plan
// holds the same formulas.
inline int smem_out_bwd(int L, int P, int N) {
  const int a = 2 * L * (L + 1), b = (L + P) * (N + 1);
  return 4 * (2 * L * (P + 1) + (a > b ? a : b) + 5 * LMAX + 16 * LMAX);
}
inline int smem_states_bwd(int L, int P, int N) {
  return 4 * (L * (P + 1) + 2 * L * (N + 1) + P * (N + 1) + 6 * LMAX);
}
inline int smem_cb_bwd(int L, int P, int N) {
  return 4 * (L * (N + 1) + L * RT);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The forward's running sum of dA over a chunk (ssd_chunk.cu::chunk_scan),
// by warp 0: lane i owns rows 4i..4i+3.  Writes dts[l] (dt, 0 past len)
// and cum[l] for every l < LMAX.
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

// Rows [0, len) of a strided (rows, cols) operand into shared memory with
// row stride ld; rows [len, L) are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long srow, int len, int L,
                                      int cols) {
  for (int e = threadIdx.x; e < L * cols; e += WIDE) {
    const int r = e / cols, k = e - r * cols;
    dst[r * ld + k] = r < len ? to_f32(src[r * srow + k]) : 0.f;
  }
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

// ---- register tiles ------------------------------------------------------------

// A 64 x 64 block of a product from shared memory, 4 x 4 outputs a thread:
// thread (ti, tj) = (t / 16, t % 16) owns rows r0 + 16 i and columns
// c0 + 16 j (i, j < 4), r0 = row block + ti, c0 = column block + tj, and
//   acc[i][j] = sum_{k0 <= k < k1} A(r0 + 16 i, k) B(c0 + 16 j, k),
// A(r, k) = A[r ar + k ak] (0 for r >= nr), B(c, k) = B[c br + k bk] (0
// for c >= nc), summed in ascending k.  Interleaved rows and columns keep
// the reads of a warp (two rows, sixteen columns) in distinct banks for
// the unit and odd strides used here; each k costs 8 reads for 16
// multiply-adds.
__device__ __forceinline__ void tile4x4(float (&acc)[4][4], const float* A,
                                        int ar, int ak, int nr, const float* B,
                                        int br, int bk, int nc, int r0, int c0,
                                        int k0, int k1) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = k0; k < k1; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * i;
      a[i] = r < nr ? A[r * ar + k * ak] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 16 * j;
      b[j] = c < nc ? B[c * br + k * bk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

constexpr int TB = 64;  // rows and columns of a register-tiled block

// ---- (4') out_bwd --------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(WIDE)
ssd_out_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Cm,
                   const float* __restrict__ G, const float* __restrict__ Hin,
                   const float* __restrict__ dy, float* __restrict__ dx,
                   float* __restrict__ dGh, float* __restrict__ dCh,
                   float* __restrict__ dHin, float* __restrict__ dcum,
                   float* __restrict__ ddt, const Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int L = d.L, P = d.P, N = d.N, H = d.H;
  const int t0 = c * L, len = min(L, d.T - t0);
  const int lp = P + 1, ll = L + 1, ln = N + 1;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  float* xs = smem;                 // [L][P + 1]
  float* dys = xs + L * lp;         // [L][P + 1]
  float* big = dys + L * lp;        // M, R [L][L + 1] each; then C, Hin
  float* Ms = big;
  float* Rs = big + L * ll;
  const int bigsz = max(2 * L * ll, (L + P) * ln);
  float* cum = big + bigsz;         // [LMAX] each
  float* dts = cum + LMAX;
  float* rowz = dts + LMAX;
  float* colr = rowz + LMAX;
  float* colz = colr + LMAX;
  float* part = colz + LMAX;        // [LMAX][16]

  stage(xs, lp, x + b * d.sxb + t0 * d.sxt + h * d.sxh, d.sxt, len, L, P);
  const long long dyrow = (long long)H * P;
  stage(dys, lp, dy + ((long long)b * d.T + t0) * dyrow + (long long)h * P,
        dyrow, len, L, P);
  if (threadIdx.x < 32)
    chunk_scan(dt + b * d.sdb + t0 * d.sdt + h * d.sdh, d.sdt, len, A[h], cum,
               dts);
  __syncthreads();

  // dM = dy x^T on the causal blocks; M, R to shared memory (zero above
  // the diagonal), this head's share of dG out
  const long long bch = ((long long)b * d.c + c) * H + h;
  const float* Gc = G + ((long long)b * d.c + c) * L * L;
  float* dGo = dGh + bch * L * L;
  for (int bl = 0; bl < L; bl += TB) {
    for (int bs = 0; bs < L; bs += TB) {
      if (bs > bl) {  // wholly above the diagonal
        for (int e = threadIdx.x; e < TB * TB; e += WIDE) {
          const int l = bl + e / TB, s = bs + e % TB;
          if (l < L && s < L) {
            Ms[l * ll + s] = 0.f;
            Rs[l * ll + s] = 0.f;
            dGo[l * L + s] = 0.f;
          }
        }
        continue;
      }
      float acc[4][4];
      tile4x4(acc, dys, lp, 1, L, xs, lp, 1, L, bl + ti, bs + tj, 0, P);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = bl + ti + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = bs + tj + 16 * j;
          if (l >= L || s >= L) continue;
          float m = 0.f, r = 0.f, g = 0.f;
          if (s <= l) {
            const float E = expf(cum[l] - cum[s]);
            const float gg = Gc[l * L + s];
            r = acc[i][j] * gg * E;
            m = gg * E * dts[s];
            g = acc[i][j] * E * dts[s];
          }
          Ms[l * ll + s] = m;
          Rs[l * ll + s] = r;
          dGo[l * L + s] = g;
        }
      }
    }
  }
  __syncthreads();

  // intra dx = M^T dy (M is zero above the diagonal, so each thread's sum
  // starts at its first row), and the row / column sums of R and Z = R o dt_s
  float* dxo = dx + ((long long)b * d.T + t0) * dyrow + (long long)h * P;
  for (int bs = 0; bs < L; bs += TB) {
    for (int bp = 0; bp < P; bp += TB) {
      float acc[4][4];
      tile4x4(acc, Ms, 1, ll, L, dys, 1, lp, P, bs + ti, bp + tj, bs + ti, L);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = bs + ti + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = bp + tj + 16 * j;
          if (s < len && p < P) dxo[s * dyrow + p] = acc[i][j];
        }
      }
    }
  }
  for (int i = threadIdx.x; i < 2 * L; i += WIDE) {
    if (i < L) {  // row i of Z
      float z = 0.f;
      for (int s = 0; s <= i; ++s) z += Rs[i * ll + s] * dts[s];
      rowz[i] = z;
    } else {      // column s of R
      const int s = i - L;
      float r = 0.f;
      for (int l = s; l < L; ++l) r += Rs[l * ll + s];
      colr[s] = r;
      colz[s] = r * dts[s];
    }
  }
  __syncthreads();

  // the incoming state's term, with dy's rows scaled by exp(cum): C and Hin
  // in place of M and R
  float* Cs = big;          // [L][N + 1]
  float* Hs = big + L * ln; // [P][N + 1]
  stage(Cs, ln, Cm + b * d.scb + t0 * d.sct, d.sct, len, L, N);
  stage(Hs, ln, Hin + bch * P * N, (long long)N, P, P, N);
  for (int e = threadIdx.x; e < L * P; e += WIDE) {
    const int l = e / P;
    dys[l * lp + e - l * P] *= expf(cum[l]);
  }
  __syncthreads();
  // dC's share = (exp(cum) dy) Hin, and the state's row term of d(cum),
  // sum_n C[l, n] dC[l, n] (= exp(cum_l) dy_l . (C Hin^T)_l): each thread's
  // share of its rows, then the sixteen shares of a row in order
  float* dCo = dCh + bch * L * N;
  for (int bl = 0; bl < L; bl += TB) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int bn = 0; bn < N; bn += TB) {
      float acc[4][4];
      tile4x4(acc, dys, lp, 1, L, Hs, 1, ln, N, bl + ti, bn + tj, 0, P);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = bl + ti + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = bn + tj + 16 * j;
          if (l < L && n < N) {
            dCo[l * N + n] = acc[i][j];
            v[i] += Cs[l * ln + n] * acc[i][j];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = bl + ti + 16 * i;
      if (l < L) part[l * 16 + tj] = v[i];
    }
  }
  // dHin = (exp(cum) dy)^T C
  float* dHo = dHin + bch * P * N;
  for (int bn = 0; bn < N; bn += TB) {
    float acc[4][4];
    tile4x4(acc, dys, 1, lp, P, Cs, 1, ln, N, ti, bn + tj, 0, len);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ti + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = bn + tj + 16 * j;
        if (p < P && n < N) dHo[p * N + n] = acc[i][j];
      }
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += WIDE) {
    float v = 0.f;
    for (int k = 0; k < 16; ++k) v += part[l * 16 + k];
    dcum[bch * L + l] = rowz[l] - colz[l] + v;
    ddt[bch * L + l] = colr[l];
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

template <typename T>
__global__ void __launch_bounds__(WIDE)
ssd_states_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const float* __restrict__ dS,
                      const float* __restrict__ dcum_o,
                      const float* __restrict__ ddt_o,
                      const float* __restrict__ dce, float* __restrict__ dx,
                      float* __restrict__ dBh, float* __restrict__ ddt,
                      float* __restrict__ dA_part, const Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int L = d.L, P = d.P, N = d.N, H = d.H;
  const int t0 = c * L, len = min(L, d.T - t0);
  const int lp = P + 1, ln = N + 1;
  float* xs = smem;              // [L][P + 1]
  float* Bs = xs + L * lp;       // [L][N + 1]
  float* Vs = Bs + L * ln;       // [L][N + 1]
  float* dSs = Vs + L * ln;      // [P][N + 1]
  float* cum = dSs + P * ln;     // [LMAX] each
  float* dts = cum + LMAX;
  float* w = dts + LMAX;
  float* ex = w + LMAX;
  float* dw = ex + LMAX;
  float* rc = dw + LMAX;

  const long long bch = ((long long)b * d.c + c) * H + h;
  stage(xs, lp, x + b * d.sxb + t0 * d.sxt + h * d.sxh, d.sxt, len, L, P);
  stage(Bs, ln, Bm + b * d.sbb + t0 * d.sbt, d.sbt, len, L, N);
  stage(dSs, ln, dS + bch * P * N, (long long)N, P, P, N);
  if (threadIdx.x < 32)
    chunk_scan(dt + b * d.sdb + t0 * d.sdt + h * d.sdh, d.sdt, len, A[h], cum,
               dts);
  __syncthreads();
  for (int s = threadIdx.x; s < L; s += WIDE) {
    ex[s] = expf(cum[L - 1] - cum[s]);
    w[s] = ex[s] * dts[s];
  }
  __syncthreads();

  // V = x dS (L x N): dB's share, kept for dw
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  float* dBo = dBh + bch * L * N;
  for (int bs = 0; bs < L; bs += TB) {
    for (int bn = 0; bn < N; bn += TB) {
      float acc[4][4];
      tile4x4(acc, xs, lp, 1, L, dSs, 1, ln, N, bs + ti, bn + tj, 0, P);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = bs + ti + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = bn + tj + 16 * j;
          if (s < L && n < N) {
            Vs[s * ln + n] = acc[i][j];
            dBo[s * N + n] = w[s] * acc[i][j];
          }
        }
      }
    }
  }
  // dx += w o (B dS^T)
  const long long xrow = (long long)H * P;
  float* dxo = dx + ((long long)b * d.T + t0) * xrow + (long long)h * P;
  for (int bs = 0; bs < len; bs += TB) {
    float acc[4][4];
    tile4x4(acc, Bs, ln, 1, len, dSs, ln, 1, P, bs + ti, tj, 0, N);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = bs + ti + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tj + 16 * j;
        if (s < len && p < P) dxo[s * xrow + p] += w[s] * acc[i][j];
      }
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < L; s += WIDE) {
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc += Bs[s * ln + n] * Vs[s * ln + n];
    dw[s] = acc;
  }
  __syncthreads();
  // the chunk's rows in order, by one thread: d(cum), its reverse running
  // sum (the gradient of dA = dt A), ddt and this chunk's share of dA
  if (threadIdx.x == 0) {
    const long long row = bch * L;
    float last = dce[bch];
    for (int s = 0; s < L; ++s) last += dw[s] * w[s];
    float run = 0.f, da = 0.f;
    for (int s = L - 1; s >= 0; --s) {
      run += dcum_o[row + s] - dw[s] * w[s] + (s == L - 1 ? last : 0.f);
      rc[s] = run;
      da += run * dts[s];
    }
    dA_part[bch] = da;
  }
  __syncthreads();
  const float a = A[h];
  for (int s = threadIdx.x; s < len; s += WIDE)
    ddt[((long long)b * d.T + t0 + s) * H + h] =
        ddt_o[bch * L + s] + dw[s] * ex[s] + rc[s] * a;
}

// ---- (1') cb_bwd ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(WIDE)
ssd_cb_bwd_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ dGh, const float* __restrict__ dBh,
                  const float* __restrict__ dCh,
                  const float* __restrict__ dA_part, float* __restrict__ dB,
                  float* __restrict__ dC, float* __restrict__ dA,
                  const Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (d.L + RT - 1) / RT;
  const int which = blockIdx.x / nt;  // 0: rows of dC, 1: rows of dB
  const int r0 = (blockIdx.x - which * nt) * RT;
  const int c = blockIdx.y, b = blockIdx.z;
  const int L = d.L, N = d.N, H = d.H;
  const int t0 = c * L, len = min(L, d.T - t0);
  const int ln = N + 1, rows = min(RT, L - r0);
  float* Os = smem;             // [L][N + 1]: B for dC's rows, C for dB's
  float* dGs = Os + L * ln;     // [RT][L]: dG's rows (dC) or columns (dB)
  if (which == 0)
    stage(Os, ln, Bm + b * d.sbb + t0 * d.sbt, d.sbt, len, L, N);
  else
    stage(Os, ln, Cm + b * d.scb + t0 * d.sct, d.sct, len, L, N);
  const long long bc0 = ((long long)b * d.c + c) * H;
  for (int e = threadIdx.x; e < rows * L; e += WIDE) {
    // dC: dG[r0 + i, k], k fastest;  dB: dG[k, r0 + i], i fastest (the
    // reads of a warp are consecutive either way)
    const int i = which == 0 ? e / L : e % rows;
    const int k = which == 0 ? e - i * L : e / rows;
    const long long off = which == 0 ? (long long)(r0 + i) * L + k
                                     : (long long)k * L + r0 + i;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc += dGh[(bc0 + h) * L * L + off];
    dGs[i * L + k] = acc;
  }
  __syncthreads();
  const float* share = which == 0 ? dCh : dBh;
  float* out = which == 0 ? dC : dB;
  for (int e = threadIdx.x; e < rows * N; e += WIDE) {
    const int i = e / N, n = e - i * N, r = r0 + i;
    if (r >= len) continue;
    float acc = 0.f;
    for (int h = 0; h < H; ++h)
      acc += share[((bc0 + h) * L + r) * N + n];
    if (which == 0) {
      for (int s = 0; s <= r; ++s) acc += dGs[i * L + s] * Os[s * ln + n];
    } else {
      for (int l = r; l < L; ++l) acc += dGs[i * L + l] * Os[l * ln + n];
    }
    out[((long long)b * d.T + t0 + r) * N + n] = acc;
  }
  if (blockIdx.x == 0 && c == 0 && b == 0) {
    for (int h = threadIdx.x; h < H; h += WIDE) {
      float acc = 0.f;
      for (int bb = 0; bb < d.B; ++bb)
        for (int cc = 0; cc < d.c; ++cc)
          acc += dA_part[((long long)bb * d.c + cc) * H + h];
      dA[h] = acc;
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

template <typename T>
int launch_out_bwd(const void* x, const float* dt, const float* A,
                   const void* Cm, const float* G, const float* Hin,
                   const float* dy, float* dx, float* dGh, float* dCh,
                   float* dHin, float* dcum, float* ddt, const Dims& d,
                   int smem, cudaStream_t st) {
  static std::atomic<int> opted{48 * 1024};
  if (smem != smem_out_bwd(d.L, d.P, d.N)) return (int)cudaErrorInvalidValue;
  if (int e = opt_in(&ssd_out_bwd_kernel<T>, smem, opted)) return e;
  ssd_out_bwd_kernel<T><<<dim3(d.H, d.c, d.B), WIDE, smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Cm), G, Hin, dy,
      dx, dGh, dCh, dHin, dcum, ddt, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_states_bwd(const void* x, const float* dt, const float* A,
                      const void* Bm, const float* dS, const float* dcum_o,
                      const float* ddt_o, const float* dce, float* dx,
                      float* dBh, float* ddt, float* dA_part, const Dims& d,
                      int smem, cudaStream_t st) {
  static std::atomic<int> opted{48 * 1024};
  if (smem != smem_states_bwd(d.L, d.P, d.N))
    return (int)cudaErrorInvalidValue;
  if (int e = opt_in(&ssd_states_bwd_kernel<T>, smem, opted)) return e;
  ssd_states_bwd_kernel<T><<<dim3(d.H, d.c, d.B), WIDE, smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), dS, dcum_o,
      ddt_o, dce, dx, dBh, ddt, dA_part, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cb_bwd(const void* Bm, const void* Cm, const float* dGh,
                  const float* dBh, const float* dCh, const float* dA_part,
                  float* dB, float* dC, float* dA, const Dims& d, int smem,
                  cudaStream_t st) {
  static std::atomic<int> opted{48 * 1024};
  if (smem != smem_cb_bwd(d.L, d.P, d.N)) return (int)cudaErrorInvalidValue;
  if (int e = opt_in(&ssd_cb_bwd_kernel<T>, smem, opted)) return e;
  const int nt = (d.L + RT - 1) / RT;
  ssd_cb_bwd_kernel<T><<<dim3(2 * nt, d.c, d.B), WIDE, smem, st>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), dGh, dBh, dCh,
      dA_part, dB, dC, dA, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, Bm, Cm): 0 = float32, 1 = bfloat16.  smem: the pass's dynamic
// shared memory in bytes, as ssd_bwd_plan computes it.

extern "C" int ssd_out_bwd_launch(const void* x, const void* dt, const void* A,
                                  const void* Cm, const void* G,
                                  const void* Hin, const void* dy, void* dx,
                                  void* dGh, void* dCh, void* dHin,
                                  void* dcum, void* ddt,
                                  const long long* dims, int dtype, int smem,
                                  void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_out_bwd<float>(x, f(dt), f(A), Cm, f(G), f(Hin), f(dy),
                                 o(dx), o(dGh), o(dCh), o(dHin), o(dcum),
                                 o(ddt), d, smem, st);
  if (dtype == 1)
    return launch_out_bwd<__nv_bfloat16>(x, f(dt), f(A), Cm, f(G), f(Hin),
                                         f(dy), o(dx), o(dGh), o(dCh),
                                         o(dHin), o(dcum), o(ddt), d, smem,
                                         st);
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
                                     void* dx, void* dBh, void* ddt,
                                     void* dA_part, const long long* dims,
                                     int dtype, int smem, void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_states_bwd<float>(x, f(dt), f(A), Bm, f(dS), f(dcum_o),
                                    f(ddt_o), f(dce), o(dx), o(dBh), o(ddt),
                                    o(dA_part), d, smem, st);
  if (dtype == 1)
    return launch_states_bwd<__nv_bfloat16>(
        x, f(dt), f(A), Bm, f(dS), f(dcum_o), f(ddt_o), f(dce), o(dx), o(dBh),
        o(ddt), o(dA_part), d, smem, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssd_cb_bwd_launch(const void* Bm, const void* Cm,
                                 const void* dGh, const void* dBh,
                                 const void* dCh, const void* dA_part,
                                 void* dB, void* dC, void* dA,
                                 const long long* dims, int dtype, int smem,
                                 void* stream) {
  Dims d;
  if (!parse(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_cb_bwd<float>(Bm, Cm, f(dGh), f(dBh), f(dCh), f(dA_part),
                                o(dB), o(dC), o(dA), d, smem, st);
  if (dtype == 1)
    return launch_cb_bwd<__nv_bfloat16>(Bm, Cm, f(dGh), f(dBh), f(dCh),
                                        f(dA_part), o(dB), o(dC), o(dA), d,
                                        smem, st);
  return (int)cudaErrorInvalidValue;
}
