// Mamba2 SSD (state-space duality) chunk scan for sm_90a, plain C interface:
//   x (B, T, H, P), dt (B, T, H), A (H,), Bm / Cm (B, T, N), h0 (B, H, P, N)
//   -> y (B, T, H, P) in x's type, h_out (B, H, P, N) in f32
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py::ssd_chunk_pallas
// (body _ssd_kernel), one SSD chunk per grid step over the batch.  Here one
// launch covers the whole sequence: a block owns one (head, batch) pair and
// walks its chunks of length L in order, carrying the P x N state in shared
// memory from chunk to chunk.  A sequence of one chunk (T = L) is exactly the
// Pallas kernel's signature.  For each chunk, with dA = dt * A and cum its
// running sum inside the chunk:
//
//   y[l, p]  = sum_{s <= l} (C_l . B_s) exp(cum_l - cum_s) dt_s x[s, p]
//              + exp(cum_l) sum_n C[l, n] h[p, n]
//   h'[p, n] = exp(cum_{L-1}) h[p, n]
//              + sum_s exp(cum_{L-1} - cum_s) dt_s x[s, p] B[s, n]
//
// Rows past T (a ragged last chunk) read as x = dt = B = C = 0, which is what
// the reference's zero padding gives: they add nothing and do not decay.
//
// Why not the TPU's blocking: the Pallas grid is (B,) with the whole chunk
// (all H heads, 2 MB at Zamba2's widths) in VMEM; a Hopper block has 227 KB.
// So the grid is (H, B) and a block holds one head's chunk: x (L x P), B and
// C (L x N each), the state (P x N) and one L x 32 tile of the decay-weighted
// C B^T, all f32: 135 KB at L = 128, P = N = 64 (Zamba2), 217 KB at N = 128
// (Mamba2-2.7B).  Limits: L <= 128, P <= 64, N <= 128.
// The causal mask is applied explicitly (s > l gives 0), never through
// exp(-inf).
//
// Bound: operations.  Per chunk and head the work is three products of
// L x L x N, L x L x P and L x P x N multiply-adds; the bytes are read once.
// This kernel is the simple form: plain f32 fmaf from shared memory, 256
// threads with 4 x 8 register tiles, no tensor cores (no TF32), the C B^T
// tile recomputed per head.  wgmma, TMA and sharing C B^T across heads are
// later work.
//
// x, dt, Bm and Cm are read through their strides (innermost stride 1), so
// views of the in_proj output need no copy; y, h0 and h_out are contiguous.
// Launches on the given stream, allocates nothing, does not synchronise.
// The entry point returns a cudaError_t (0 = launched).

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

constexpr int THREADS = 256;
constexpr int TY = 16, TX = 16;      // thread grid inside a block
constexpr int LMAX = 128, PMAX = 64, NMAX = 128;
constexpr int TS = 32;               // s-tile of the C B^T matrix
constexpr int RI = LMAX / TY;        // y rows per thread
constexpr int RJ = PMAX / TX;        // y columns per thread
constexpr int SI = PMAX / TY;        // state rows per thread
constexpr int SJ = NMAX / TX;        // state columns per thread

struct ScanShape {
  int B, T, H, P, N, L;
  long long sxb, sxt, sxh;  // x strides (p stride 1)
  long long sdb, sdt, sdh;  // dt strides
  long long sbb, sbt;       // Bm strides (n stride 1)
  long long scb, sct;       // Cm strides
};

__host__ __device__ inline int smem_floats(int L, int P, int N) {
  return L * P + 2 * L * (N + 1) + P * (N + 1) + L * (TS + 1) + 4 * L;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_out,
                const ScanShape s) {
  extern __shared__ __align__(16) float smem[];
  const int L = s.L, P = s.P, N = s.N, NS = N + 1;
  float* xs = smem;                 // L x P
  float* Bs = xs + L * P;           // L x (N + 1)
  float* Cs = Bs + L * NS;          // L x (N + 1)
  float* hs = Cs + L * NS;          // P x (N + 1): the carried state
  float* Ms = hs + P * NS;          // L x (TS + 1): a tile of weighted C B^T
  float* dts = Ms + L * (TS + 1);   // L
  float* cum = dts + L;             // L
  float* ecum = cum + L;            // L: exp(cum_l)
  float* wts = ecum + L;            // L: exp(cum_end - cum_s) dt_s

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const float Ah = A[h];
  const long long hbase = ((long long)b * s.H + h) * P * N;

  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    hs[p * NS + n] = h0 ? h0[hbase + e] : 0.f;
  }

  for (int t0 = 0; t0 < s.T; t0 += L) {
    const int len = min(L, s.T - t0);
    // ---- stage the chunk (rows past T read as zero) ----------------------
    for (int e = tid; e < L * P; e += THREADS) {
      const int l = e / P, p = e - l * P;
      xs[e] = l < len ? to_f32(x[b * s.sxb + (t0 + l) * s.sxt + h * s.sxh + p])
                      : 0.f;
    }
    for (int e = tid; e < L * N; e += THREADS) {
      const int l = e / N, n = e - l * N;
      float bv = 0.f, cv = 0.f;
      if (l < len) {
        bv = to_f32(Bm[b * s.sbb + (t0 + l) * s.sbt + n]);
        cv = to_f32(Cm[b * s.scb + (t0 + l) * s.sct + n]);
      }
      Bs[l * NS + n] = bv;
      Cs[l * NS + n] = cv;
    }
    for (int l = tid; l < L; l += THREADS)
      dts[l] = l < len ? dt[b * s.sdb + (t0 + l) * s.sdt + h * s.sdh] : 0.f;
    __syncthreads();
    if (tid == 0) {  // running sum of dA, in order, as a sequential cumsum
      float c = 0.f;
      for (int l = 0; l < L; ++l) {
        c += dts[l] * Ah;
        cum[l] = c;
      }
    }
    __syncthreads();
    const float cum_end = cum[L - 1];
    for (int l = tid; l < L; l += THREADS) {
      ecum[l] = expf(cum[l]);
      wts[l] = expf(cum_end - cum[l]) * dts[l];
    }
    __syncthreads();

    // ---- y: incoming-state term, then the intra-chunk term by s-tiles ----
    float acc[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int l = ty + TY * i;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int p = tx + TX * j;
        float v = 0.f;
        if (l < L && p < P) {
          for (int n = 0; n < N; ++n)
            v = fmaf(Cs[l * NS + n], hs[p * NS + n], v);
          v *= ecum[l];
        }
        acc[i][j] = v;
      }
    }
    for (int s0 = 0; s0 < L; s0 += TS) {
      // Ms[l][ss] = (C_l . B_s) exp(cum_l - cum_s) dt_s for s <= l, else 0
      for (int e = tid; e < L * TS; e += THREADS) {
        const int l = e / TS, ss = e - l * TS, sg = s0 + ss;
        float m = 0.f;
        if (sg < L && sg <= l) {
          for (int n = 0; n < N; ++n)
            m = fmaf(Cs[l * NS + n], Bs[sg * NS + n], m);
          m *= expf(cum[l] - cum[sg]) * dts[sg];
        }
        Ms[l * (TS + 1) + ss] = m;
      }
      __syncthreads();
      const int s_end = min(TS, L - s0);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int l = ty + TY * i;
        if (l >= L) continue;
        for (int ss = 0; ss < s_end; ++ss) {
          const float m = Ms[l * (TS + 1) + ss];
          const float* xrow = xs + (s0 + ss) * P;
#pragma unroll
          for (int j = 0; j < RJ; ++j) {
            const int p = tx + TX * j;
            if (p < P) acc[i][j] = fmaf(m, xrow[p], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int l = ty + TY * i;
      if (l >= len) continue;
      T* yrow = y + (((long long)b * s.T + t0 + l) * s.H + h) * P;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int p = tx + TX * j;
        if (p < P) yrow[p] = from_f32<T>(acc[i][j]);
      }
    }

    // ---- the outgoing state: each thread updates its own (p, n) entries --
    const float decay = ecum[L - 1];
#pragma unroll
    for (int i = 0; i < SI; ++i) {
      const int p = ty + TY * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const int n = tx + TX * j;
        if (n >= N) continue;
        float v = 0.f;
        for (int sl = 0; sl < L; ++sl)
          v = fmaf(xs[sl * P + p] * wts[sl], Bs[sl * NS + n], v);
        hs[p * NS + n] = fmaf(hs[p * NS + n], decay, v);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    h_out[hbase + e] = hs[p * NS + n];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* h_out,
           const ScanShape& s, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(s.L, s.P, s.N);
  static size_t opted_in = 48 * 1024;  // the default dynamic shared memory
  if (bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = bytes;
  }
  const dim3 grid((unsigned)s.H, (unsigned)s.B);
  ssd_scan_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, static_cast<T*>(y), h_out, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory in bytes for a chunk of L rows, head dim P, state N.
extern "C" long long ssd_chunk_smem_bytes(int L, int P, int N) {
  return (long long)sizeof(float) * smem_floats(L, P, N);
}

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  h0 may be null
// (zero state).  Returns a cudaError_t (0 = launched).
extern "C" int ssd_chunk_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* h0, void* y, void* h_out, int B, int T,
    int H, int P, int N, int L, long long sxb, long long sxt, long long sxh,
    long long sdb, long long sdt, long long sdh, long long sbb, long long sbt,
    long long scb, long long sct, int dtype, void* stream) {
  if (L < 1 || L > LMAX || P < 1 || P > PMAX || N < 1 || N > NMAX || B < 1 ||
      T < 1 || H < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const ScanShape s = {B, T, H, P, N, L, sxb, sxt, sxh, sdb, sdt, sdh,
                       sbb, sbt, scb, sct};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dtf, Af, Bm, Cm, h0f, y, hf, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, h0f, y, hf, s, st);
  return (int)cudaErrorInvalidValue;
}
