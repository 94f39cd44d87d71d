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
// Design: one call is THREE launches on the caller's stream, so that the
// work that does not depend on the carried state (most of it) runs in
// parallel over every chunk of every stream, not chunk after chunk:
//
//   (a) wkv6_intra, grid (B*H, nC), one chunk a block: the cumulative
//       log-decays (a thread a channel, in token order: see scan_tile);
//       the strict lower triangle of the (C, C) scores,
//       att[t, j] = sum_d r[t,d] k[j,d] exp(cum_prev[t,d] - cum[j,d]), its
//       C(C-1)/2 pairs spread evenly over the threads, two rows a thread
//       against one k row; y = att @ v + (r . u k) v written to y; the
//       chunk's own state increment (k * exp(total - cum))^T v and `total`
//       written to a scratch the wrapper allocates, (B, H, nC, D, D) and
//       (B, H, nC, D);
//   (b) wkv6_scan, grid (B*H, D*D / 256): the columns (and rows) of S are
//       independent scalar recurrences over the chunks.  A thread owns one
//       element: it writes S_start of chunk c over that chunk's increment,
//       then S = exp(total) * S + increment (the reference's order), from
//       state0 or zeros, and writes the final state;
//   (c) wkv6_inter, grid (B*H, nC): y += (r * exp(cum_prev)) @ S_start,
//       the scan of (a) done again (same code, same bits).
//
// The exponent is never factored (exp(cum_prev[t]) / exp(cum[j]) would
// overflow under strong decay); a factored form on the tensor cores is a
// later step.  All arithmetic is f32 on the CUDA cores, `expf` at full
// precision.  Inputs are read in the model layout (B, S, H, D) f32; the
// tail of the last chunk reads as zeros (zero k and zero log-decay leave
// the state unchanged), the reference's zero padding without a copy.
//
// Bound on the H100: exponentials.  At the rwkv6-3b prefill shape (B*H =
// 160 streams of 2048 x 64, 5120 chunks) the scores take C(C-1)/2 * D =
// 129,024 exponentials a chunk, 0.70 G in all with the decays: 0.168 ms at
// the SFU's 16 a clock a SM (1.98 GHz); the f32 work (10.7 GFLOP) takes
// 0.160 ms at 67 TFLOP/s and the bytes that must move (4 x 84 MB in, 84 MB
// out) 0.126 ms.  This design moves more: the increments (84 MB) out of
// (a), through (b) and into (c), y twice more and r and the log-decays
// again in (c), about 1 GB, 0.31 ms at 3.35 TB/s.  In (a) the shared-memory
// rows are padded to 68 floats and read as float4, so that the 32 lanes of
// a warp, on 32 neighbouring j, read k and cum without bank conflicts; a
// thread scores two rows against each k and cum row it reads, so shared
// memory serves about 1.6 wavefronts a warp's product, not 2.75.
#include "wkv6_tile.cuh"

namespace {

struct IntraSmem {
  float R[MAXC * LD];    // r
  float K[MAXC * LD];    // k, then k * exp(total - cum)
  float CP[MAXC * LD];   // cum_prev
  float CU[MAXC * LD];   // lw, then cum
  float V[MAXC * LD];    // v
  float ATT[MAXC * (MAXC + 1)];  // att, the bonus on its diagonal
  float TOT[MAXC];
  float U[MAXC];
};

__global__ void __launch_bounds__(NT, 2)
wkv6_intra(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ inc, float* __restrict__ tot, Shape g) {
  extern __shared__ float4 smem4[];
  IntraSmem& sm = *reinterpret_cast<IntraSmem*>(smem4);
  const int bh = blockIdx.x, c = blockIdx.y, C = g.C, D = g.D, Dp = g.Dp;
  const Stream s = stream_of(g, bh, c);
  const long long off = s.off;
  load_tile(sm.R, s, r + off, D, Dp, g.vec);
  load_tile(sm.K, s, k + off, D, Dp, g.vec);
  load_tile(sm.V, s, v + off, D, Dp, g.vec);
  load_tile(sm.CU, s, lw + off, D, Dp, g.vec);
  const int h = bh % g.H;
  for (int d = threadIdx.x; d < MAXC; d += NT) {
    sm.U[d] = d < D ? u[h * D + d] : 0.0f;
  }
  __syncthreads();
  scan_tile(sm.CU, sm.CP, sm.TOT, C, Dp);
  strict_scores(sm.R, sm.K, sm.CP, sm.CU, sm.ATT, C, Dp);
  // the bonus diagonal, r . (u * k), on att's diagonal; zeros above it
  for (int t = threadIdx.x; t < MAXC; t += NT) {
    float a = 0.0f;
    for (int d = 0; d < Dp; ++d) {
      a = fmaf(sm.R[t * LD + d] * sm.U[d], sm.K[t * LD + d], a);
    }
    sm.ATT[t * (MAXC + 1) + t] = a;
  }
  for (int e = threadIdx.x; e < MAXC * MAXC; e += NT) {
    const int t = e >> 6, j = e & (MAXC - 1);
    if (j > t) sm.ATT[t * (MAXC + 1) + j] = 0.0f;
  }
  __syncthreads();
  // y_intra = att @ v + diag * v, (att | diag) lower triangular: a thread
  // owns four columns of rows a = tt and b = 63 - tt (65 terms in all,
  // whatever tt), each a float4 of v a term
  {
    const int tt = threadIdx.x >> 4, f0 = (threadIdx.x & 15) * 4;
    if (f0 < Dp) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? MAXC - 1 - tt : tt;
        if (t >= s.valid) continue;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int j = 0; j <= t; ++j) {
          const float w = sm.ATT[t * (MAXC + 1) + j];
          const float4 vv = *reinterpret_cast<const float4*>(sm.V + j * LD + f0);
          a.x = fmaf(w, vv.x, a.x);
          a.y = fmaf(w, vv.y, a.y);
          a.z = fmaf(w, vv.z, a.z);
          a.w = fmaf(w, vv.w, a.w);
        }
        store4(y + off + t * s.tok + f0, a, D - f0, g.vec);
      }
    }
  }
  // k_dec = k * exp(total - cum), over k (the scores are done with it)
  for (int e = threadIdx.x; e < MAXC * MAXC; e += NT) {
    const int t = e >> 6, d = e & (MAXC - 1);
    if (t < C && d < Dp) sm.K[t * LD + d] *= expf(sm.TOT[d] - sm.CU[t * LD + d]);
  }
  __syncthreads();
  // the chunk's increment k_dec^T v, (D, D): a 2 x 4 tile a thread
  const long long chunk = (long long)bh * g.nC + c;
  float* incc = inc + chunk * D * D;
  const int d0 = (threadIdx.x >> 4) * 2, f0 = (threadIdx.x & 15) * 4;
  if (d0 < Dp && f0 < Dp) {
    float acc[2][4] = {};
    for (int t = 0; t < C; ++t) {
      const float2 kd = *reinterpret_cast<const float2*>(sm.K + t * LD + d0);
      const float4 vv = *reinterpret_cast<const float4*>(sm.V + t * LD + f0);
      const float ka[2] = {kd.x, kd.y};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(ka[i], va[jj], acc[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (d0 + i < D && f0 + jj < D) incc[(d0 + i) * D + f0 + jj] = acc[i][jj];
      }
    }
  }
  for (int d = threadIdx.x; d < D; d += NT) tot[chunk * D + d] = sm.TOT[d];
}

// A thread owns element e = (d, f) of a stream's state and walks the
// chunks: inc[c] <- S_start(c); S = exp(total_c[d]) * S + inc_c.  Eight
// chunks' increments and totals are loaded before any is written over.
__global__ void __launch_bounds__(NS)
wkv6_scan(float* __restrict__ inc, const float* __restrict__ tot,
          const float* __restrict__ s0, float* __restrict__ s_out, Shape g) {
  constexpr int kAhead = 8;
  const int bh = blockIdx.x, D = g.D;
  const int e = blockIdx.y * NS + threadIdx.x;
  if (e >= D * D) return;
  const int d = e / D;
  const long long dd = (long long)D * D;
  float S = s0 ? s0[bh * dd + e] : 0.0f;
  float* p = inc + bh * g.nC * dd + e;
  const float* w = tot + (long long)bh * g.nC * D + d;
  for (int c0 = 0; c0 < g.nC; c0 += kAhead) {
    float add[kAhead], lw[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < g.nC) {
        add[i] = p[(c0 + i) * dd];
        lw[i] = w[(c0 + i) * D];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < g.nC) {
        p[(c0 + i) * dd] = S;
        S = expf(lw[i]) * S + add[i];
      }
    }
  }
  s_out[bh * dd + e] = S;
}

struct InterSmem {
  float RD[MAXC * LD];   // r, then r * exp(cum_prev)
  float CP[MAXC * LD];   // cum_prev
  float CU[MAXC * LD];   // lw, then cum
  float St[MAXC * LD];   // S_start
  float TOT[MAXC];
};

__global__ void __launch_bounds__(NT, 2)
wkv6_inter(const float* __restrict__ r, const float* __restrict__ lw,
           const float* __restrict__ sst, float* __restrict__ y, Shape g) {
  extern __shared__ float4 smem4[];
  InterSmem& sm = *reinterpret_cast<InterSmem*>(smem4);
  const int bh = blockIdx.x, c = blockIdx.y, C = g.C, D = g.D, Dp = g.Dp;
  const Stream s = stream_of(g, bh, c);
  const long long off = s.off;
  load_tile(sm.RD, s, r + off, D, Dp, g.vec);
  load_tile(sm.CU, s, lw + off, D, Dp, g.vec);
  // S_start as a (D, D) tile: its rows are D floats apart
  Stream st;
  st.off = 0;
  st.tok = D;
  st.valid = D;
  load_tile(sm.St, st, sst + ((long long)bh * g.nC + c) * D * D, D, Dp,
            g.vec);
  __syncthreads();
  scan_tile(sm.CU, sm.CP, sm.TOT, C, Dp);
  for (int e = threadIdx.x; e < MAXC * MAXC; e += NT) {
    const int t = e >> 6, d = e & (MAXC - 1);
    if (t < C && d < Dp) sm.RD[t * LD + d] *= expf(sm.CP[t * LD + d]);
  }
  __syncthreads();
  // y[t, f] += sum_d r_dec[t, d] S_start[d, f]: a 2 x 4 tile a thread
  const int t0 = (threadIdx.x >> 4) * 2, f0 = (threadIdx.x & 15) * 4;
  if (t0 < s.valid && f0 < Dp) {
    float acc[2][4] = {};
    for (int d = 0; d < Dp; ++d) {
      const float4 sv = *reinterpret_cast<const float4*>(sm.St + d * LD + f0);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float rd = sm.RD[(t0 + i) * LD + d];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(rd, sa[jj], acc[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (t0 + i >= s.valid) break;
      float* yt = y + off + (t0 + i) * s.tok + f0;
      float4 a = load4(yt, D - f0, g.vec);
      a.x += acc[i][0];
      a.y += acc[i][1];
      a.z += acc[i][2];
      a.w += acc[i][3];
      store4(yt, a, D - f0, g.vec);
    }
  }
}

}  // namespace

extern "C" {

// r, k, v, lw: (B, S, H, D) f32 contiguous; u: (H, D); s0: (B, H, D, D) or
// null; y: (B, S, H, D); s_out: (B, H, D, D); inc: (B, H, nC, D, D) and
// tot: (B, H, nC, D) f32 scratch, nC = ceil(S / C).  Three launches on
// `stream`.  Returns a cudaError_t.
int wkv6_launch(const float* r, const float* k, const float* v,
                const float* lw, const float* u, const float* s0, float* y,
                float* s_out, float* inc, float* tot, int B, int S, int H,
                int D, int C, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > MAXC || C < 1 || C > MAXC)
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const int vec = D % 4 == 0 && aligned(r) && aligned(k) && aligned(v) &&
                  aligned(lw) && aligned(inc);
  const Shape g{B, S, H, D, C, (S + C - 1) / C, (D + 3) / 4 * 4, vec};
  auto st = static_cast<cudaStream_t>(stream);
  const int intra = (int)sizeof(IntraSmem), inter = (int)sizeof(InterSmem);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_intra, cudaFuncAttributeMaxDynamicSharedMemorySize, intra);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        wkv6_inter, cudaFuncAttributeMaxDynamicSharedMemorySize, inter);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 chunks(B * H, g.nC);
  wkv6_intra<<<chunks, NT, intra, st>>>(r, k, v, lw, u, y, inc, tot, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_scan<<<dim3(B * H, (D * D + NS - 1) / NS), NS, 0, st>>>(inc, tot, s0,
                                                                s_out, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_inter<<<chunks, NT, inter, st>>>(r, lw, inc, y, g);
  return (int)cudaGetLastError();
}

const char* wkv6_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
