// Persistent allocation epoch for Hopper (sm_90a): one launch runs one whole
// epoch segment, select -> grant -> refresh per grant, with the epoch state
// updated in place in device memory.
//
// Replaces the TPU kernel repro/kernels/epoch_persistent/kernel.py::
// epoch_kernel (pallas_call at ops.py:86, wrapper persistent_epoch).  The
// arithmetic is that kernel's and the engine's plain loop's, step for step:
//   * the global two-pass tie-low select (minimum m, then the first index
//     with masked <= m + (1e-9 + 1e-6 |m|)), masked entries at 3.0e38;
//   * RRR: the first position at or after `pos` of the current permutation
//     whose server has a feasible framework, else the first of the next
//     permutation (wrap).  Scanning positions gives the server of least
//     rank directly, so no rank inversion (the one-hot contraction of the
//     TPU kernel, or a scatter) is needed;
//   * grant, feasibility column j and row n, then the criterion refresh of
//     row n (and, for rPS-DSF, residual column j with the kernel's own
//     3.0e38 sentinel).
// Built with -fmad=false and without fast math, so every product and sum
// rounds as the plain PyTorch version's does.  The two sums whose order
// differs from it (the rPS-DSF residual X[:, j] . D[:, r], block-reduced
// here) are exact on quantized demands, as in the paper's workloads.
//
// Bound on the H100: operations.  Read once, the epoch's inputs and outputs
// are about 55 MB at 512 x 4096 (16 us); its selects compare every cell of
// the (N, J) scores once per grant (2.1M comparisons, 0.031 us a grant at
// the f32 rate), which is the larger.  In practice each grant streams the
// scores and the mask (5 bytes a cell, 10.5 MB) through L2, and on one SM
// that stream is the limit.  Design: ONE block of 1024 threads owns the
// epoch, so select, grant and refresh are separated by __syncthreads()
// instead of grid-wide barriers; the 40 MB of state stays largely in the
// 50 MB L2 across grants.  Float4 / uchar4 loads, a second pass that only
// the threads holding a qualifying entry run (each stopping at its first),
// and early-exit liveness checks keep the passes short.  A cooperative
// multi-block version is the next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // 32: one warp finishes a reduction
constexpr float kBig = 3.0e38f;
constexpr int kIBig = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxR = 8;

enum Kind : int { kDrf = 0, kTsf = 1, kPsdsf = 2, kRpsdsf = 3 };

struct Epoch {
  // constants
  const float* D;          // (N, R) scoring demands
  const float* TD;         // (N, R) true demands
  const float* C;          // (J, R) capacities
  const float* phi;        // (N,)
  const float* wanted;     // (N,)
  const uint8_t* allowed;  // (N, J)
  const int32_t* perms;    // (K, J) RRR server permutations
  const float* aux;        // (N,) DRF unit share / TSF denominator
  // state, updated in place
  float* X;                // (N, J)
  float* tot;              // (N,)
  float* FREE;             // (J, R)
  float* cap;              // (J, R) rPS-DSF residuals
  float* dom;              // (N, J) PS-DSF family dominant shares
  float* s;                // (N,) or (N, J) scores
  uint8_t* feas;           // (N, J)
  int32_t* used;           // (J,) grants per server this epoch
  // outputs
  int32_t* ns;             // (max_steps,) grant sequence, frameworks
  int32_t* js;             // (max_steps,) grant sequence, servers
  int32_t* cnt;            // (count, pidx, pos)
  // scratch
  float* vec;              // (max(N, J),) masked scores of a 1-D select
  uint8_t* ok;             // (J,) server has a feasible framework
  int N, J, R, K;
  int pidx0, pos0, j_real, limit;
  float eps;
  int kind, rrr, lookahead, use_limit, max_steps;
};

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide reductions; every thread receives the result.  Each starts
// with a barrier, so the shared scratch of the previous one is free.
__device__ float block_min(float v, float* sh) {
  v = warp_min(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_min(sh[threadIdx.x & 31]);
}

__device__ int block_min_i(int v, int* sh) {
  v = warp_min_i(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_min_i(sh[threadIdx.x & 31]);
}

__device__ float block_sum(float v, float* sh) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(sh[threadIdx.x & 31]);
}

__device__ __forceinline__ float threshold(float m) {
  return m + (1e-9f + 1e-6f * fabsf(m));
}

__device__ __forceinline__ float masked(uint8_t f, float v) {
  return f ? v : kBig;
}

// Tie-low select over e.vec[0, len) (already masked; written before a
// barrier).  -> the first index within tolerance of the minimum.
__device__ int tie_low_vec(const Epoch& e, int len, float* shf, int* shi) {
  float lm = kBig;
  for (int i = threadIdx.x; i < len; i += kThreads) lm = fminf(lm, e.vec[i]);
  const float thr = threshold(block_min(lm, shf));
  int first = kIBig;
  if (lm <= thr) {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      if (e.vec[i] <= thr) { first = i; break; }
    }
  }
  return block_min_i(first, shi);
}

// Pooled select over the flattened (N, J) scores: -> flat index n * J + j.
__device__ int select_flat(const Epoch& e, float* shf, int* shi) {
  const int n4 = (e.N * e.J) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(e.s);
  const uchar4* f4 = reinterpret_cast<const uchar4*>(e.feas);
  float lm = kBig;
  for (int g = threadIdx.x; g < n4; g += kThreads) {
    const float4 v = s4[g];
    const uchar4 f = f4[g];
    lm = fminf(lm, fminf(fminf(masked(f.x, v.x), masked(f.y, v.y)),
                         fminf(masked(f.z, v.z), masked(f.w, v.w))));
  }
  const float thr = threshold(block_min(lm, shf));
  int first = kIBig;
  if (lm <= thr) {  // this thread holds a qualifying entry: find its first
    for (int g = threadIdx.x; g < n4; g += kThreads) {
      const float4 v = s4[g];
      const uchar4 f = f4[g];
      if (masked(f.x, v.x) <= thr) { first = 4 * g; break; }
      if (masked(f.y, v.y) <= thr) { first = 4 * g + 1; break; }
      if (masked(f.z, v.z) <= thr) { first = 4 * g + 2; break; }
      if (masked(f.w, v.w) <= thr) { first = 4 * g + 3; break; }
    }
  }
  return block_min_i(first, shi);
}

// any(feas): early exit at the first 16 KB chunk holding a feasible pair.
__device__ bool any_feasible(const Epoch& e) {
  const int n16 = (e.N * e.J) >> 4;
  const uint4* f = reinterpret_cast<const uint4*>(e.feas);
  for (int base = 0; base < n16; base += kThreads) {
    const int g = base + threadIdx.x;
    bool hit = false;
    if (g < n16) {
      const uint4 v = f[g];
      hit = (v.x | v.y | v.z | v.w) != 0u;
    }
    if (__syncthreads_or(hit)) return true;
  }
  return false;
}

// Pooled DRF / TSF: the framework by tie-low over rows that fit anywhere,
// then its first feasible server.
__device__ void select_rows(const Epoch& e, float* shf, int* shi, int& n,
                            int& j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = e.J >> 2;
  for (int r = warp; r < e.N; r += kWarps) {
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(e.feas + (size_t)r * e.J);
    uint32_t acc = 0u;
    for (int w = lane; w < words; w += 32) acc |= row[w];
    const bool any = __any_sync(kFull, acc != 0u);
    if (lane == 0) e.vec[r] = any ? e.s[r] : kBig;
  }
  __syncthreads();
  n = tie_low_vec(e, e.N, shf, shi);
  const uint32_t* row =
      reinterpret_cast<const uint32_t*>(e.feas + (size_t)n * e.J);
  int first = kIBig;
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const uint32_t v = row[w];
    if (v != 0u) { first = 4 * w + (__ffs(v) - 1) / 8; break; }
  }
  j = block_min_i(first, shi);
}

// First position k in [from, J) of permutation row `p` whose server is ok.
__device__ int first_ok_position(const Epoch& e, int p, int from, int* shi) {
  const int32_t* perm = e.perms + (size_t)min(p, e.K - 1) * e.J;
  int first = kIBig;
  for (int k = from + threadIdx.x; k < e.J; k += kThreads) {
    if (e.ok[perm[k]]) { first = k; break; }
  }
  return block_min_i(first, shi);
}

// Randomized round-robin: the round's next server with a feasible
// framework, then the best framework on it.
__device__ void select_rrr(const Epoch& e, float* shf, int* shi, int pidx,
                           int pos, int& n, int& j, int& pidx2, int& pos2) {
  // ok[j] = any(feas[:, j]); four columns per thread, early exit
  const int words = e.J >> 2;
  const uint32_t* f = reinterpret_cast<const uint32_t*>(e.feas);
  for (int w = threadIdx.x; w < words; w += kThreads) {
    uint32_t acc = 0u;
    for (int r = 0; r < e.N; ++r) {
      acc |= f[(size_t)r * words + w];
      if ((acc & 0x000000ffu) && (acc & 0x0000ff00u) &&
          (acc & 0x00ff0000u) && (acc & 0xff000000u)) break;
    }
    reinterpret_cast<uint32_t*>(e.ok)[w] =
        ((acc & 0x000000ffu) ? 0x00000001u : 0u) |
        ((acc & 0x0000ff00u) ? 0x00000100u : 0u) |
        ((acc & 0x00ff0000u) ? 0x00010000u : 0u) |
        ((acc & 0xff000000u) ? 0x01000000u : 0u);
  }
  __syncthreads();
  int krank = first_ok_position(e, pidx, pos, shi);
  const bool wrap = krank == kIBig;
  const int p = wrap ? pidx + 1 : pidx;
  if (wrap) krank = first_ok_position(e, p, 0, shi);
  j = e.perms[(size_t)min(p, e.K - 1) * e.J + krank];
  const bool ss = e.kind >= kPsdsf;
  for (int r = threadIdx.x; r < e.N; r += kThreads) {
    e.vec[r] = masked(e.feas[(size_t)r * e.J + j],
                      ss ? e.s[(size_t)r * e.J + j] : e.s[r]);
  }
  __syncthreads();
  n = tie_low_vec(e, e.N, shf, shi);
  const bool last = krank == e.j_real - 1;
  pidx2 = pidx + (wrap ? 1 : 0) + (last ? 1 : 0);
  pos2 = last ? 0 : krank + 1;
}

__device__ void grant(const Epoch& e, int n, int j, int count, float* shf) {
  const int N = e.N, J = e.J, R = e.R;
  if (threadIdx.x == 0) {
    e.X[(size_t)n * J + j] += 1.0f;
    e.tot[n] += 1.0f;
    for (int r = 0; r < R; ++r) e.FREE[j * R + r] += -e.TD[n * R + r];
    e.used[j] += 1;
    e.ns[count] = n;
    e.js[count] = j;
  }
  __syncthreads();
  // feasibility: column j saw FREE change; row n may have hit `wanted`
  const float* fj = e.FREE + j * R;
  const bool under_limit = !e.use_limit || e.used[j] < e.limit;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    bool c = under_limit && e.tot[i] < e.wanted[i] &&
             e.allowed[(size_t)i * J + j] != 0;
    for (int r = 0; r < R; ++r) c = c && e.TD[i * R + r] <= fj[r] + e.eps;
    e.feas[(size_t)i * J + j] = c ? 1 : 0;
  }
  __syncthreads();
  if (!(e.tot[n] < e.wanted[n])) {
    for (int k = threadIdx.x; k < J; k += kThreads) {
      e.feas[(size_t)n * J + k] = 0;
    }
  }
  // score refresh: row n, and for rPS-DSF first residual column j
  const float la = e.lookahead ? 1.0f : 0.0f;
  const float xt_n = e.tot[n] + la;
  if (e.kind == kDrf) {
    if (threadIdx.x == 0) e.s[n] = xt_n * e.aux[n] / e.phi[n];
  } else if (e.kind == kTsf) {
    if (threadIdx.x == 0) e.s[n] = xt_n / e.aux[n];
  } else {
    if (e.kind == kRpsdsf) {
      float capj[kMaxR];
      for (int r = 0; r < R; ++r) {
        float part = 0.0f;
        for (int i = threadIdx.x; i < N; i += kThreads) {
          part += e.X[(size_t)i * J + j] * e.D[i * R + r];
        }
        capj[r] = e.C[j * R + r] - block_sum(part, shf);
      }
      if (threadIdx.x == 0) {
        for (int r = 0; r < R; ++r) e.cap[j * R + r] = capj[r];
      }
      for (int i = threadIdx.x; i < N; i += kThreads) {
        float d = 0.0f;
        for (int r = 0; r < R; ++r) {
          const float dr = e.D[i * R + r];
          const float safe = capj[r] > 1e-12f ? capj[r] : 1e-30f;
          float frac = dr / safe;
          if (capj[r] <= 1e-12f && dr > 0.0f) frac = kBig;
          d = r == 0 ? frac : fmaxf(d, frac);
        }
        e.dom[(size_t)i * J + j] = d;
        e.s[(size_t)i * J + j] = (e.tot[i] + la) / e.phi[i] * d;
      }
      __syncthreads();
    }
    const float xp = xt_n / e.phi[n];
    for (int k = threadIdx.x; k < J; k += kThreads) {
      e.s[(size_t)n * J + k] = xp * e.dom[(size_t)n * J + k];
    }
  }
  // every write of this grant (the feas row n clear above all) lands before
  // the next liveness check and select read feas and s
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) epoch_kernel(Epoch e) {
  __shared__ float shf[kWarps];
  __shared__ int shi[kWarps];
  for (int i = threadIdx.x; i < e.max_steps; i += kThreads) {
    e.ns[i] = -1;
    e.js[i] = -1;
  }
  int pidx = e.pidx0, pos = e.pos0, count = 0;
  const bool ss = e.kind >= kPsdsf;
  while (count < e.max_steps && any_feasible(e)) {
    int n, j, pidx2 = pidx, pos2 = pos;
    if (e.rrr) {
      select_rrr(e, shf, shi, pidx, pos, n, j, pidx2, pos2);
    } else if (ss) {
      const int flat = select_flat(e, shf, shi);
      n = flat / e.J;
      j = flat % e.J;
    } else {
      select_rows(e, shf, shi, n, j);
    }
    grant(e, n, j, count, shf);
    ++count;
    pidx = pidx2;
    pos = pos2;
  }
  if (threadIdx.x == 0) {
    e.cnt[0] = count;
    e.cnt[1] = pidx;
    e.cnt[2] = pos;
  }
}

}  // namespace

extern "C" int epoch_persistent_launch(
    const float* D, const float* TD, const float* C, const float* phi,
    const float* wanted, const uint8_t* allowed, const int32_t* perms,
    const float* aux, float* X, float* tot, float* FREE, float* cap,
    float* dom, float* s, uint8_t* feas, int32_t* used, int32_t* ns,
    int32_t* js, int32_t* cnt, float* vec, uint8_t* ok, int N, int J, int R,
    int K, int pidx0, int pos0, int j_real, int limit, float eps, int kind,
    int rrr, int lookahead, int use_limit, int max_steps, void* stream) {
  if (R < 1 || R > kMaxR || (J & 3) != 0 || ((N * J) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Epoch e{D,    TD,   C,   phi,  wanted, allowed, perms, aux,   X,
          tot,  FREE, cap, dom,  s,      feas,    used,  ns,    js,
          cnt,  vec,  ok,  N,    J,      R,       K,     pidx0, pos0,
          j_real, limit, eps, kind, rrr, lookahead, use_limit, max_steps};
  epoch_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* epoch_persistent_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
