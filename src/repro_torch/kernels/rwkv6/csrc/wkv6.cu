// Chunked WKV6 recurrence (K6) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py
// (`wkv6_bhsd`, body `_wkv6_kernel`), the RWKV6 "Finch" time-mix
//
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,  y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
//
// in the chunk-parallel form of `repro.nn.ssm.wkv6_chunked`: within a chunk
// of C tokens the pairwise decays are exp(cum_prev[t] - cum[j]) with j < t,
// the state update decays are exp(total - cum[t]), and the output decay is
// exp(cum_prev[t]): every exponent is <= 0 (log-decays are <= 0), so nothing
// overflows however strong the decay.  It also writes the state after the
// last chunk, which `wkv6_chunked` returns and the prefill keeps for the
// decode cache, and it may start from a given state.
//
// Design.  The Pallas grid (B*H streams x sequential chunks) becomes one
// block of 256 threads per (b, h) stream looping over its chunks: the
// (D, D) f32 state lives in shared memory for the whole sequence (16 KB at
// D = 64), with the chunk's r, k, v, cumulative decays and the (C, C)
// intra-chunk scores beside it (about 149 KB at C = D = 64).  Inputs are read
// in the model layout (B, S, H, D) f32; the tail of the last chunk is read as
// zeros (zero k and zero log-decay leave the state unchanged), which is the
// reference's zero padding without a copy.  Every product is an f32 FMA on
// the CUDA cores; the exponentials are `expf` (full precision).
//
// Bound on the H100: at the rwkv6-3b prefill shape (B*H = 160 streams of
// 2048 x 64) the kernel reads 4 x 84 MB and writes 84 MB (0.126 ms at
// 3.35 TB/s) and does about 10.7 GFLOP of f32 work (0.16 ms at 67 TFLOP/s):
// bound by operations.  160 blocks fill the 132 SMs only 1.2 times, and the
// C * C * D / 2 exponentials of the intra-chunk scores dominate.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ lw,
         const float* __restrict__ u, const float* __restrict__ s0,
         float* __restrict__ y, float* __restrict__ s_out, int H, int S,
         int D, int C) {
  extern __shared__ float smem[];
  const int CS = C + 1;                 // row stride of the transposed tiles
  float* R = smem;                      // [C][D]  r
  float* CP = R + C * D;                // [C][D]  cum_prev (exclusive)
  float* RD = CP + C * D;               // [C][D]  r * exp(cum_prev)
  float* KD = RD + C * D;               // [C][D]  k * exp(total - cum)
  float* V = KD + C * D;                // [C][D]  v
  float* Kt = V + C * D;                // [D][CS] k, transposed
  float* CT = Kt + D * CS;              // [D][CS] cum (inclusive), transposed
  float* ATT = CT + D * CS;             // [C][C]  intra-chunk scores
  float* St = ATT + C * C;              // [D][D]  state
  float* DG = St + D * D;               // [C]     r . (u * k)
  float* TOT = DG + C;                  // [D]     total log-decay of the chunk
  float* U = TOT + D;                   // [D]     bonus

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long tok = (long long)H * D;            // stride of one token
  const long long base = (long long)b * S * tok + (long long)h * D;
  const long long sbase = (long long)blockIdx.x * D * D;

  for (int e = tid; e < D * D; e += NT) St[e] = s0 ? s0[sbase + e] : 0.f;
  for (int d = tid; d < D; d += NT) U[d] = u[h * D + d];

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();                    // the previous chunk is consumed
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, d = e % D;
      const bool in = c0 + t < S;
      const long long off = base + (c0 + t) * tok + d;
      const float kk = in ? k[off] : 0.f;
      R[e] = in ? r[off] : 0.f;
      V[e] = in ? v[off] : 0.f;
      CP[e] = in ? lw[off] : 0.f;       // the log-decay, for the cumsum
      Kt[d * CS + t] = kk;
    }
    __syncthreads();
    // cumulative log-decays down each channel (in the reference's terms
    // cum = cumsum(lw), cum_prev = cum - lw, total = cum[C - 1])
    for (int d = tid; d < D; d += NT) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        const float w = CP[t * D + d];
        run += w;
        CT[d * CS + t] = run;
        CP[t * D + d] = run - w;
      }
      TOT[d] = run;
    }
    __syncthreads();
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, d = e % D;
      RD[e] = R[e] * expf(CP[e]);
      KD[e] = Kt[d * CS + t] * expf(TOT[d] - CT[d * CS + t]);
    }
    // att[t, j] = sum_d r[t,d] k[j,d] exp(cum_prev[t,d] - cum[j,d]), j < t
    for (int e = tid; e < C * C; e += NT) {
      const int t = e / C, j = e % C;
      float a = 0.f;
      if (j < t) {
        for (int d = 0; d < D; ++d)
          a = fmaf(R[t * D + d] * Kt[d * CS + j],
                   expf(CP[t * D + d] - CT[d * CS + j]), a);
      }
      ATT[e] = a;
    }
    for (int t = tid; t < C; t += NT) {
      float a = 0.f;
      for (int d = 0; d < D; ++d)
        a = fmaf(R[t * D + d] * U[d], Kt[d * CS + t], a);
      DG[t] = a;
    }
    __syncthreads();
    // y = att @ v + diag * v + r_dec @ S_start
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, f = e % D;
      float intra = 0.f;
      for (int j = 0; j < t; ++j) intra = fmaf(ATT[t * C + j], V[j * D + f], intra);
      intra = fmaf(DG[t], V[e], intra);
      float inter = 0.f;
      for (int d = 0; d < D; ++d) inter = fmaf(RD[t * D + d], St[d * D + f], inter);
      if (c0 + t < S) y[base + (c0 + t) * tok + f] = intra + inter;
    }
    __syncthreads();
    // S = diag(exp(total)) S + (k * exp(total - cum))^T v
    for (int e = tid; e < D * D; e += NT) {
      const int d = e / D, f = e % D;
      float a = 0.f;
      for (int t = 0; t < C; ++t) a = fmaf(KD[t * D + d], V[t * D + f], a);
      St[e] = fmaf(expf(TOT[d]), St[e], a);
    }
  }
  __syncthreads();
  for (int e = tid; e < D * D; e += NT) s_out[sbase + e] = St[e];
}

}  // namespace

extern "C" {

size_t wkv6_smem_bytes(int D, int C) {
  return sizeof(float) *
         (5 * (size_t)C * D + 2 * (size_t)D * (C + 1) + (size_t)C * C +
          (size_t)D * D + C + 2 * D);
}

// r, k, v, lw: (B, S, H, D) f32 contiguous; u: (H, D); s0: (B, H, D, D) or
// null; y: (B, S, H, D); s_out: (B, H, D, D).  Returns a cudaError_t.
int wkv6_launch(const float* r, const float* k, const float* v,
                const float* lw, const float* u, const float* s0, float* y,
                float* s_out, int B, int S, int H, int D, int C,
                void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 64 || C < 1 || C > 64)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = wkv6_smem_bytes(D, C);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_fwd<<<B * H, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, lw, u, s0, y, s_out, H, S, D, C);
  return (int)cudaGetLastError();
}

const char* wkv6_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
