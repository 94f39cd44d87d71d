// Flash attention backward (K5's gradient) for Hopper (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel: the JAX package trains through the XLA twin of
// its flash kernel (src/repro/nn/layers.py:104-176) and lets autodiff take
// the gradient; its Pallas kernel (kernels/flash_attention/kernel.py) has no
// VJP.  The port's forward runs K5 itself (flash_tc.cu, flash.cu), so on the
// card its gradient comes from here.  It computes, for the forward's
// function (scores s = q k^T / sqrt(D) under the causal and window mask,
// p = softmax(s) in f32, o = p v, a row with no valid key giving 0):
//
//   Di    = rowsum(dO * O)                  (O the forward's output)
//   dS    = p * (dO v^T - Di)
//   dQ    = dS k / sqrt(D)
//   dK    = dS^T q / sqrt(D)                summed over the G query heads
//   dV    = p^T dO                          of each kv head (GQA)
//
// Design: two launches, no atomics, so a run repeats bit for bit.
//
// 1. `flash_bwd_dq`: a block of 256 threads owns BQ query rows of one
//    (batch, head).  It takes Di from its dO and O rows, sweeps the visible
//    key tiles once for each row's max m and sum l (the forward's online
//    recurrence), then again for p = exp(s - m) / l, dP = dO v^T, dS and
//    dQ += dS k.  It writes dQ, and m, l and Di to a (B, H, S) scratch.
// 2. `flash_bwd_dkdv`: a block owns BK keys of one (batch, kv head) and
//    sweeps the G query heads of its group and, for each, the query tiles
//    that can see its keys, recomputing p from m and l (the same products
//    in the same order as launch 1, so the same bits) and summing
//    dV += p^T dO and dK += dS^T q in registers.
//
// Tiles sit in shared memory as f32 (BQ = BK = 64; 32 at D = 256), every
// product is an f32 FMA on the CUDA cores, summed in the order of its
// index; no tensor cores, no TF32.  A ragged tail is masked in the kernel,
// and q, k, v, O and dO are read in place through their strides (the head
// dim contiguous).  Gradients are written in the inputs' type, contiguous.
//
// Bound on the H100: at qwen2-1.5b's training shape, (2, 4096, 12, 128)
// against (2, 4096, 2, 128) bf16 causal, the backward's five products
// (s, dP, dQ, dK, dV) over the causal pairs are 5 * 2 * B*H*S*T/2 * D =
// 129 GFLOP (0.13 ms at the bf16 tensor-core peak); this kernel recomputes
// s three times and dP twice (eight products, 206 GFLOP) at the f32 CUDA
// cores' 67 TFLOP/s.  wgmma with TMA-fed tiles is the later redesign.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;          // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Strides in elements (the last dim is contiguous): q, k, v, the forward's
// output o and its gradient g (dO).
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh;
};

struct Shape {
  int H, K, S, Tn, causal, window;
  float scale;                   // 1 / sqrt(D)
};

__device__ __forceinline__ bool visible(int qpos, int kpos, const Shape& sh) {
  return qpos < sh.S && kpos < sh.Tn && (!sh.causal || kpos <= qpos) &&
         (sh.window <= 0 || qpos - kpos < sh.window);
}

template <int D, int DV, int BQ, int BK>
constexpr int dq_smem_floats() {
  return BQ * (D + 1) + BQ * (DV + 1) + D * (BK + 1) + DV * (BK + 1) +
         BQ * (BK + 1);
}

template <int D, int DV, int BQ, int BK>
constexpr int dkdv_smem_floats() {
  return BK * (D + 1) + BK * (DV + 1) + D * (BQ + 1) + DV * (BQ + 1) +
         2 * BK * (BQ + 1) + 3 * BQ;
}

// ---------------------------------------------------------------------------
// launch 1: dQ, and each row's m, l and Di
// ---------------------------------------------------------------------------

template <typename T, int D, int DV, int BQ, int BK>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ g, T* __restrict__ dq,
             float* __restrict__ mbuf, float* __restrict__ lbuf,
             float* __restrict__ dibuf, Strides st, Shape sh) {
  constexpr int RI = BQ / 16, CJ = BK / 16, DJ = D / 16;
  constexpr int QSTR = D + 1, GSTR = DV + 1, KSTR = BK + 1, PSTR = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][QSTR]
  float* Gs = Qs + BQ * QSTR;             // [BQ][GSTR]   dO
  float* Kt = Gs + BQ * GSTR;             // [D][KSTR]    k, transposed
  float* Vt = Kt + D * KSTR;              // [DV][KSTR]   v, transposed
  float* Ps = Vt + DV * KSTR;             // [BQ][PSTR]   dS

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int H = sh.H, S = sh.S, Tn = sh.Tn;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / sh.K);
  const int q0 = blockIdx.x * BQ;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kh * st.kh;
  const T* vp = v + b * st.vb + kh * st.vh;
  const T* op = o + b * st.ob + h * st.oh;
  const T* gp = g + b * st.gb + h * st.gh;

  for (int e = tid; e < BQ * D; e += NT) {
    int r = e / D, d = e % D;
    Qs[r * QSTR + d] = (q0 + r < S) ? to_f32(qp[(q0 + r) * st.qs + d]) : 0.f;
  }
  for (int e = tid; e < BQ * DV; e += NT) {
    int r = e / DV, d = e % DV;
    Gs[r * GSTR + d] = (q0 + r < S) ? to_f32(gp[(q0 + r) * st.gs + d]) : 0.f;
  }
  __syncthreads();

  // Di = sum_d dO[r][d] * O[r][d], in order of d (each lane of a row group
  // computes its rows' sums whole)
  float di[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.f;
    if (q0 + r < S)
      for (int d = 0; d < DV; ++d)
        acc = fmaf(Gs[r * GSTR + d], to_f32(op[(q0 + r) * st.os + d]), acc);
    di[i] = acc;
  }

  int k_end = sh.causal ? min(Tn, q0 + BQ) : Tn;
  int k_begin = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  // pass 1: each row's max and sum, the forward's online recurrence
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * D; e += NT) {
      int c = e / D, d = e % D;
      Kt[d * KSTR + c] = (k0 + c < Tn) ? to_f32(kp[(k0 + c) * st.ks + d]) : 0.f;
    }
    __syncthreads();
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * QSTR + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Kt[d * KSTR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[CJ];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        valid[j] = visible(qpos, k0 + tx + 16 * j, sh);
        s[i][j] = valid[j] ? s[i][j] * sh.scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        rs += valid[j] ? expf(s[i][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = fmaf(expf(m[i] - m_new), l[i], rs);
      m[i] = m_new;
    }
  }

  // pass 2: p, dP, dS and dQ
  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();             // the previous tile's Kt/Vt/Ps are consumed
    for (int e = tid; e < BK * D; e += NT) {
      int c = e / D, d = e % D;
      Kt[d * KSTR + c] = (k0 + c < Tn) ? to_f32(kp[(k0 + c) * st.ks + d]) : 0.f;
    }
    for (int e = tid; e < BK * DV; e += NT) {
      int c = e / DV, d = e % DV;
      Vt[d * KSTR + c] = (k0 + c < Tn) ? to_f32(vp[(k0 + c) * st.vs + d]) : 0.f;
    }
    __syncthreads();
    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * QSTR + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Kt[d * KSTR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      float gv[RI], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) gv[i] = Gs[(ty + 16 * i) * GSTR + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = Vt[d * KSTR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (l[i] > 0.f && visible(q0 + r, k0 + c, sh)) {
          const float p = expf(s[i][j] * sh.scale - m[i]) / l[i];
          ds = p * (dp[i][j] - di[i]);
        }
        Ps[r * PSTR + c] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PSTR + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Kt[(tx + 16 * j) * KSTR + c];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], kv, acc[i][j]);
      }
    }
  }

  // dq is (B, S, H, D) contiguous; m, l, Di are (B, H, S)
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    T* dqp = dq + (((long long)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqp[tx + 16 * j] = from_f32<T>(acc[i][j] * sh.scale);
    if (tx == 0) {
      const long long row = ((long long)b * H + h) * S + qpos;
      mbuf[row] = m[i];
      lbuf[row] = l[i];
      dibuf[row] = di[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launch 2: dK and dV, summed over the group's query heads
// ---------------------------------------------------------------------------

template <typename T, int D, int DV, int BQ, int BK>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ g,
               T* __restrict__ dk, T* __restrict__ dv,
               const float* __restrict__ mbuf, const float* __restrict__ lbuf,
               const float* __restrict__ dibuf, Strides st, Shape sh) {
  constexpr int CI = BK / 16, RJ = BQ / 16, DJ = D / 16, VJ = DV / 16;
  constexpr int KSTR = D + 1, VSTR = DV + 1, TSTR = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                       // [BK][KSTR]
  float* Vs = Ks + BK * KSTR;             // [BK][VSTR]
  float* Qt = Vs + BK * VSTR;             // [D][TSTR]    q, transposed
  float* Gt = Qt + D * TSTR;              // [DV][TSTR]   dO, transposed
  float* Pt = Gt + DV * TSTR;             // [BK][TSTR]   p^T
  float* St = Pt + BK * TSTR;             // [BK][TSTR]   dS^T
  float* Mr = St + BK * TSTR;             // [BQ]  m
  float* Lr = Mr + BQ;                    // [BQ]  l
  float* Dr = Lr + BQ;                    // [BQ]  Di

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int H = sh.H, K = sh.K, S = sh.S, Tn = sh.Tn;
  const int G = H / K;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int k0 = blockIdx.x * BK;

  const T* kp = k + b * st.kb + kh * st.kh;
  const T* vp = v + b * st.vb + kh * st.vh;
  for (int e = tid; e < BK * D; e += NT) {
    int c = e / D, d = e % D;
    Ks[c * KSTR + d] = (k0 + c < Tn) ? to_f32(kp[(k0 + c) * st.ks + d]) : 0.f;
  }
  for (int e = tid; e < BK * DV; e += NT) {
    int c = e / DV, d = e % DV;
    Vs[c * VSTR + d] = (k0 + c < Tn) ? to_f32(vp[(k0 + c) * st.vs + d]) : 0.f;
  }

  float ak[CI][DJ], av[CI][VJ];
#pragma unroll
  for (int i = 0; i < CI; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) ak[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < VJ; ++j) av[i][j] = 0.f;
  }

  // the query tiles that can see a key of this block
  int q_begin = sh.causal ? min(k0, S) : 0;
  q_begin = (q_begin / BQ) * BQ;
  const int q_end = sh.window > 0 ? min(S, k0 + BK - 1 + sh.window) : S;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const T* qp = q + b * st.qb + h * st.qh;
    const T* gp = g + b * st.gb + h * st.gh;
    const long long rows = ((long long)b * H + h) * S;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();           // the previous tile's Qt/Gt/Pt/St are consumed
      for (int e = tid; e < BQ * D; e += NT) {
        int r = e / D, d = e % D;
        Qt[d * TSTR + r] = (q0 + r < S) ? to_f32(qp[(q0 + r) * st.qs + d]) : 0.f;
      }
      for (int e = tid; e < BQ * DV; e += NT) {
        int r = e / DV, d = e % DV;
        Gt[d * TSTR + r] = (q0 + r < S) ? to_f32(gp[(q0 + r) * st.gs + d]) : 0.f;
      }
      for (int r = tid; r < BQ; r += NT) {
        const bool in = q0 + r < S;
        Mr[r] = in ? mbuf[rows + q0 + r] : 0.f;
        Lr[r] = in ? lbuf[rows + q0 + r] : 0.f;
        Dr[r] = in ? dibuf[rows + q0 + r] : 0.f;
      }
      __syncthreads();
      // s^T and dP^T: rows are this block's keys, columns the tile's queries
      float s[CI][RJ], dp[CI][RJ];
#pragma unroll
      for (int i = 0; i < CI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[CI], qv[RJ];
#pragma unroll
        for (int i = 0; i < CI; ++i) kv[i] = Ks[(ty + 16 * i) * KSTR + d];
#pragma unroll
        for (int j = 0; j < RJ; ++j) qv[j] = Qt[d * TSTR + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < CI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
      }
#pragma unroll 4
      for (int d = 0; d < DV; ++d) {
        float vv[CI], gv[RJ];
#pragma unroll
        for (int i = 0; i < CI; ++i) vv[i] = Vs[(ty + 16 * i) * VSTR + d];
#pragma unroll
        for (int j = 0; j < RJ; ++j) gv[j] = Gt[d * TSTR + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < CI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) dp[i][j] = fmaf(gv[j], vv[i], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < CI; ++i) {
        const int c = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int r = tx + 16 * j;
          float p = 0.f, ds = 0.f;
          if (Lr[r] > 0.f && visible(q0 + r, k0 + c, sh)) {
            p = expf(s[i][j] * sh.scale - Mr[r]) / Lr[r];
            ds = p * (dp[i][j] - Dr[r]);
          }
          Pt[c * TSTR + r] = p;
          St[c * TSTR + r] = ds;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[CI], sv[CI];
#pragma unroll
        for (int i = 0; i < CI; ++i) {
          pv[i] = Pt[(ty + 16 * i) * TSTR + r];
          sv[i] = St[(ty + 16 * i) * TSTR + r];
        }
#pragma unroll
        for (int j = 0; j < VJ; ++j) {
          const float gv = Gt[(tx + 16 * j) * TSTR + r];
#pragma unroll
          for (int i = 0; i < CI; ++i) av[i][j] = fmaf(pv[i], gv, av[i][j]);
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float qv = Qt[(tx + 16 * j) * TSTR + r];
#pragma unroll
          for (int i = 0; i < CI; ++i) ak[i][j] = fmaf(sv[i], qv, ak[i][j]);
        }
      }
    }
  }

  // dk (B, T, K, D) and dv (B, T, K, DV), contiguous
#pragma unroll
  for (int i = 0; i < CI; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Tn) continue;
    const long long row = ((long long)b * Tn + kpos) * K + kh;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dk[row * D + tx + 16 * j] = from_f32<T>(ak[i][j] * sh.scale);
#pragma unroll
    for (int j = 0; j < VJ; ++j)
      dv[row * DV + tx + 16 * j] = from_f32<T>(av[i][j]);
  }
}

template <typename F>
cudaError_t set_smem(F* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* g, void* dq, void* dk, void* dv, float* mbuf,
                   float* lbuf, float* dibuf, int B, Strides st, Shape sh,
                   cudaStream_t stream) {
  constexpr int BQ = D == 256 ? 32 : 64, BK = BQ;
  constexpr size_t b1 = dq_smem_floats<D, DV, BQ, BK>() * sizeof(float);
  constexpr size_t b2 = dkdv_smem_floats<D, DV, BQ, BK>() * sizeof(float);
  auto* k1 = flash_bwd_dq<T, D, DV, BQ, BK>;
  auto* k2 = flash_bwd_dkdv<T, D, DV, BQ, BK>;
  cudaError_t err = set_smem(k1, b1);
  if (err == cudaSuccess) err = set_smem(k2, b2);
  if (err != cudaSuccess) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  dim3 g1((sh.S + BQ - 1) / BQ, B * sh.H);
  k1<<<g1, NT, b1, stream>>>(qp, kp, vp, static_cast<const T*>(o), gp,
                             static_cast<T*>(dq), mbuf, lbuf, dibuf, st, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g2((sh.Tn + BK - 1) / BK, B * sh.K);
  k2<<<g2, NT, b2, stream>>>(qp, kp, vp, gp, static_cast<T*>(dk),
                             static_cast<T*>(dv), mbuf, lbuf, dibuf, st, sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* o, const void* g, void* dq, void* dk,
                       void* dv, float* mb, float* lb, float* db, int B,
                       int D, int DV, Strides st, Shape sh,
                       cudaStream_t stream) {
#define FLASH_BWD_CASE(DQK, DVV)                                             \
  if (D == DQK && DV == DVV)                                                 \
    return launch<T, DQK, DVV>(q, k, v, o, g, dq, dk, dv, mb, lb, db, B, st, \
                               sh, stream);
  FLASH_BWD_CASE(16, 16)
  FLASH_BWD_CASE(32, 32)
  FLASH_BWD_CASE(64, 64)
  FLASH_BWD_CASE(128, 128)
  FLASH_BWD_CASE(256, 256)
  FLASH_BWD_CASE(192, 128)
#undef FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 f16.  Strides in elements of q, k, v, o (the
// forward's output) and g (its gradient), each (B, rows, heads, dim) with
// the last dim contiguous.  dq (B, S, H, D), dk (B, T, K, D), dv (B, T, K,
// DV) are written contiguous; m, l, di are a (B, H, S) f32 scratch.
// Returns a cudaError_t.
int flash_bwd_launch(const void* q, const void* k, const void* v,
                     const void* o, const void* g, void* dq, void* dk,
                     void* dv, void* m, void* l, void* di, int dtype, int B,
                     int H, int K, int S, int Tn, int D, int DV,
                     long long qb, long long qs, long long qh, long long kb,
                     long long ks, long long kh, long long vb, long long vs,
                     long long vh, long long ob, long long os, long long oh,
                     long long gb, long long gs, long long gh, int causal,
                     int window, float scale, void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || S < 1 || Tn < 1 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh};
  Shape sh{H, K, S, Tn, causal, window, scale};
  float* mb = static_cast<float*>(m);
  float* lb = static_cast<float*>(l);
  float* db = static_cast<float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(q, k, v, o, g, dq, dk, dv, mb, lb, db, B, D, DV, st, sh, s);
    case 1: return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, g, dq, dk, dv, mb, lb, db, B, D, DV, st, sh, s);
    case 2: return (int)dispatch_d<__half>(q, k, v, o, g, dq, dk, dv, mb, lb, db, B, D, DV, st, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
