// Flash attention forward (K5) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_bhsd`, body `_flash_kernel`): online-softmax attention
// with a causal and a sliding-window mask (q_pos - k_pos < window), GQA by
// index (query head h reads kv head h / (H / K); k and v are never
// repeated in memory), f32 running max / sum / accumulator, a row with no
// valid key giving 0, and the output in q's type.  Unlike the Pallas kernel
// it takes any S and T and masks the ragged tail itself, and it reads the
// model layout (B, S, H, D) through strides, so the caller transposes and
// pads nothing.
//
// Design.  One block of 256 threads owns BQ = 64 query rows of one
// (batch, head) and sweeps the key tiles (BK = 64) that its rows can see:
// tiles above the causal diagonal and below the window are skipped, since
// every key in them is masked for every row of the block.  Q, K (transposed)
// and V tiles sit in shared memory as f32; each thread holds a 4 x 4 block
// of the score tile and 4 rows x D/16 columns of the accumulator in
// registers.  The dots are f32 FMAs on the CUDA cores (`fmaf`, no TF32, no
// tensor cores), so the sums differ from the plain version only in their
// order.  A masked key contributes p = 0 exactly (the Pallas kernel gets
// the same 0 from exp(-1e30 - m) once a row has seen a valid key), so a row
// whose first tiles are fully masked (a window below the tile) is exact,
// and a row with no valid key at all ends with l == 0 and gives 0, as the
// reference's closed form `attention_ref` does.
//
// Bound on the H100: at the qwen2-1.5b prefill shape (4 x 12 x 2048 x 128
// queries against 2 kv heads, bf16) the causal products take 2*B*H*S*T*D =
// 52 GFLOP, 0.052 ms at the bf16 tensor-core peak, against 58 MB of
// q/k/v/o (0.017 ms at 3.35 TB/s): bound by operations.  This kernel runs
// on the f32 CUDA cores, whose peak (67 TFLOP/s) alone is 15x further off;
// wgmma with TMA-fed tiles is the later redesign.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
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

struct Strides {                 // in elements; the last dim is contiguous
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int K, int S,
          int Tn, Strides st, int causal, int window, float scale) {
  constexpr int QSTR = D + 1, KSTR = BK + 1, PSTR = BK + 1;
  constexpr int DJ = D / 16;     // accumulator columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][QSTR]
  float* Kt = Qs + BQ * QSTR;             // [D][KSTR]  (transposed)
  float* Vs = Kt + D * KSTR;              // [BK][D]
  float* Ps = Vs + BK * D;                // [BQ][PSTR]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * BQ;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kh * st.kh;
  const T* vp = v + b * st.vb + kh * st.vh;

  for (int e = tid; e < BQ * D; e += NT) {
    int r = e / D, d = e % D;
    Qs[r * QSTR + d] = (q0 + r < S) ? to_f32(qp[(q0 + r) * st.qs + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // the key tiles any row of this block can see
  int k_end = causal ? min(Tn, q0 + BQ) : Tn;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();             // the previous tile's Kt/Vs/Ps are consumed
    for (int e = tid; e < BK * D; e += NT) {
      int c = e / D, d = e % D;
      bool in = k0 + c < Tn;
      Kt[d * KSTR + c] = in ? to_f32(kp[(k0 + c) * st.ks + d]) : 0.f;
      Vs[c * D + d] = in ? to_f32(vp[(k0 + c) * st.vs + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QSTR + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * KSTR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[4];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < Tn && (!causal || kpos <= qpos) &&
                   (window <= 0 || qpos - kpos < window);
        s[i][j] = valid[j] ? s[i][j] * scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      // the 16 lanes of a row group share a half warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PSTR + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = fmaf(alpha[i], l[i], rs);
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PSTR + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // o is (B, S, H, D) contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    T* op = o + (((long long)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      op[tx + 16 * j] = from_f32<T>(l[i] == 0.f ? 0.f : acc[i][j] / l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int K, int S, int Tn, Strides st,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, K, S, Tn, st, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int K, int S, int Tn, int D, Strides st,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, K, S, Tn, st, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, S, Tn, st, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, S, Tn, st, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, S, Tn, st, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, K, S, Tn, st, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 f16.  Strides in elements, q/k/v last dim
// contiguous; o is (B, S, H, D) contiguous.  Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int K, int S,
                           int Tn, int D, long long qb, long long qs,
                           long long qh, long long kb, long long ks,
                           long long kh, long long vb, long long vs,
                           long long vh, int causal, int window, float scale,
                           void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || S < 1 || Tn < 1 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(q, k, v, o, B, H, K, S, Tn, D, st, causal, window, scale, s);
    case 1: return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, K, S, Tn, D, st, causal, window, scale, s);
    case 2: return (int)dispatch_d<__half>(q, k, v, o, B, H, K, S, Tn, D, st, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
