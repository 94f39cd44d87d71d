// Backward of the chunked WKV6 recurrence (K6) for Hopper (sm_90a), CUDA C++.
//
// The gradient of wkv6.cu's function, (y, S_end) = WKV6(r, k, v, lw, u, S_0),
// for the cotangents dy and dS_end: (dr, dk, dv, dlw, du, dS_0).  The
// reference gets it from XLA's autodiff of `repro.nn.ssm.wkv6_chunked`; the
// plain version here is `ref.wkv6_bwd_ref`.  Within a chunk of C tokens,
// with cum the inclusive and cum_prev the exclusive cumulative log-decays,
// total = cum[C - 1], the scores att[t, j] = sum_d r[t,d] k[j,d]
// exp(cum_prev[t,d] - cum[j,d]) for j < t (the bonus r_t . u k_t on the
// diagonal), d_att[t, j] = dy_t . v_j, S the chunk's starting state and G
// the gradient of the next chunk's (G = dS_end after the last chunk):
//
//   dv = att^T dy + (k * exp(total - cum)) G
//   dr = [d_att through the decays] k + d_att[t,t] u k + exp(cum_prev) * (dy S^T)
//   dk = [d_att through the decays]^T r + d_att[t,t] u r + exp(total - cum) * (v G^T)
//   du = sum_t d_att[t,t] r_t k_t,  and the chunk's own G = exp(total) G + (r exp(cum_prev))^T dy
//   dlw[s] = sum_{t>s} r dr'  -  sum_{t>=s} k dk''  +  sum_{t<s} k dk'''  +  exp(total) sum_f S G
//
// where dr' is dr without its bonus share, dk'' dk's intra-chunk share and
// dk''' its state share: the gradients of cum, cum_prev and total gathered
// by sums inside the chunk, never by differences of whole-sequence sums
// (cum reaches -1e4 under strong decay).  Every exponent is <= 0.
//
// Design: the forward's three launches in reverse, plus one for du, on the
// caller's stream, no atomics (two runs give the same bits):
//
//   (a') wkv6_bwd_intra, grid (B*H, nC), one chunk a block: cum, cum_prev
//        and total with the forward's scan_tile (the same bits), att with
//        the forward's strict_scores, d_att = dy v^T (a plain (C, C) product
//        over D, lower triangle); dv's intra and bonus shares, a thread four
//        columns of two rows j and 63 - j (the triangle balanced); dr's and
//        dk's, a thread a channel and eight rows (t and 63 - t), each row a
//        loop over the other index with its exponential recomputed; dlw's
//        intra share and the chunk's part of du, a thread a channel in
//        reverse token order; the chunk's (r * exp(cum_prev))^T dy into a
//        (B, H, nC, D, D) scratch and total into (B, H, nC, D);
//   (b') wkv6_bwd_scan, grid (B*H, D*D / 256): a thread an element of the
//        state's adjoint, over the chunks in reverse from dS_end (or 0): it
//        writes G_{c+1} over chunk c's term, then G = exp(total) G + term,
//        and dS_0 at the end;
//   (c') wkv6_bwd_inter, grid (B*H, nC): from the forward's saved starting
//        states S (the forward's scratch after its scan) and G_{c+1}: the
//        state's shares of dr and dk (a 2 x 4 tile a thread over the
//        transposed states), of dv (over G) and of dlw (a thread a
//        channel), added to what (a') wrote;
//   (d') wkv6_bwd_du, grid H: each head's du, the chunks' parts summed over
//        the batch and the chunks in order.
//
// All arithmetic is f32 on the CUDA cores, `expf` at full precision.  The
// pair decays exp(cum_prev[t] - cum[j]) are computed three times (for att,
// dr and dk), the price of keeping no (C, C, D) tensor; a tensor-core form
// is a later step.  Shared memory: (a') six (64, 68) tiles and two (64, 65)
// ones, 138,240 bytes; (c') nine tiles, 157,184 bytes; one block an SM.
#include "wkv6_tile.cuh"

namespace {

constexpr int LA = MAXC + 1;   // row stride of the (C, C) tiles, floats

struct BwdIntraSmem {
  float R[MAXC * LD];    // r, then r * exp(cum_prev)
  float K[MAXC * LD];    // k
  float V[MAXC * LD];    // v, then k * dk's intra share
  float DY[MAXC * LD];   // dy
  float CP[MAXC * LD];   // cum_prev
  float CU[MAXC * LD];   // lw, then cum
  float ATT[MAXC * LA];  // att, the bonus on its diagonal; then r * dr'
  float DA[MAXC * LA];   // d_att, dy_t . v_t on its diagonal
  float TOT[MAXC];
  float U[MAXC];
};

__global__ void __launch_bounds__(NT, 1)
wkv6_bwd_intra(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, const float* __restrict__ dy,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ q, float* __restrict__ tot,
               float* __restrict__ dup, Shape g) {
  extern __shared__ float4 smem4[];
  BwdIntraSmem& sm = *reinterpret_cast<BwdIntraSmem*>(smem4);
  const int bh = blockIdx.x, c = blockIdx.y, C = g.C, D = g.D, Dp = g.Dp;
  const Stream s = stream_of(g, bh, c);
  const long long off = s.off;
  const int valid = s.valid;
  load_tile(sm.R, s, r + off, D, Dp, g.vec);
  load_tile(sm.K, s, k + off, D, Dp, g.vec);
  load_tile(sm.V, s, v + off, D, Dp, g.vec);
  load_tile(sm.DY, s, dy + off, D, Dp, g.vec);
  load_tile(sm.CU, s, lw + off, D, Dp, g.vec);
  const int h = bh % g.H;
  for (int d = threadIdx.x; d < MAXC; d += NT) {
    sm.U[d] = d < D ? u[h * D + d] : 0.0f;
  }
  __syncthreads();
  scan_tile(sm.CU, sm.CP, sm.TOT, C, Dp);
  strict_scores(sm.R, sm.K, sm.CP, sm.CU, sm.ATT, C, Dp);
  // the bonus on att's diagonal, as the forward has it
  for (int t = threadIdx.x; t < MAXC; t += NT) {
    float a = 0.0f;
    for (int d = 0; d < Dp; ++d) {
      a = fmaf(sm.R[t * LD + d] * sm.U[d], sm.K[t * LD + d], a);
    }
    sm.ATT[t * LA + t] = a;
  }
  // d_att[t, j] = dy_t . v_j for j <= t < valid, zero elsewhere; att zero
  // above its diagonal.  A warp takes 32 neighbouring j of one row t
  for (int e = threadIdx.x; e < MAXC * MAXC; e += NT) {
    const int t = e >> 6, j = e & (MAXC - 1);
    if (j > t) sm.ATT[t * LA + j] = 0.0f;
    float a = 0.0f;
    if (j <= t && t < valid) {
      const float4* yt = reinterpret_cast<const float4*>(sm.DY + t * LD);
      const float4* vj = reinterpret_cast<const float4*>(sm.V + j * LD);
      for (int q4 = 0; q4 < Dp / 4; ++q4) {
        const float4 yy = yt[q4], vv = vj[q4];
        a = fmaf(yy.x, vv.x, a);
        a = fmaf(yy.y, vv.y, a);
        a = fmaf(yy.z, vv.z, a);
        a = fmaf(yy.w, vv.w, a);
      }
    }
    sm.DA[t * LA + j] = a;
  }
  __syncthreads();
  // dv[j] = sum_{t >= j} att[t, j] dy[t]: four columns of rows jj and
  // 63 - jj a thread (65 terms in all)
  {
    const int jj = threadIdx.x >> 4, f0 = (threadIdx.x & 15) * 4;
    if (f0 < Dp) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = half ? MAXC - 1 - jj : jj;
        if (j >= valid) continue;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int t = j; t < valid; ++t) {
          const float w = sm.ATT[t * LA + j];
          const float4 yy = *reinterpret_cast<const float4*>(sm.DY + t * LD + f0);
          a.x = fmaf(w, yy.x, a.x);
          a.y = fmaf(w, yy.y, a.y);
          a.z = fmaf(w, yy.z, a.z);
          a.w = fmaf(w, yy.w, a.w);
        }
        store4(dv + off + j * s.tok + f0, a, D - f0, g.vec);
      }
    }
  }
  __syncthreads();   // att and v are read: they take r * dr' and k * dk''
  // dr[t, d] = sum_{j<t} d_att[t,j] k[j,d] exp(cum_prev[t,d] - cum[j,d])
  // + d_att[t,t] u[d] k[t,d], and dk[j, d] likewise over t > j: a thread a
  // channel d and the rows p, 63 - p of four p; a warp's lanes take
  // neighbouring channels of one row
  {
    const int d = threadIdx.x & (MAXC - 1), p0 = (threadIdx.x >> 6) * 4;
    if (d < D) {
      const float ud = sm.U[d];
      for (int i = 0; i < 8; ++i) {
        const int p = p0 + (i >> 1);
        const int t = (i & 1) ? MAXC - 1 - p : p;
        if (t >= valid) continue;
        const float cpt = sm.CP[t * LD + d];
        const float* dat = sm.DA + t * LA;
        float a = 0.0f;
        for (int j = 0; j < t; ++j) {
          a = fmaf(dat[j] * sm.K[j * LD + d], expf(cpt - sm.CU[j * LD + d]),
                   a);
        }
        sm.ATT[t * LA + d] = sm.R[t * LD + d] * a;
        dr[off + t * s.tok + d] = a + dat[t] * ud * sm.K[t * LD + d];
      }
      for (int i = 0; i < 8; ++i) {
        const int p = p0 + (i >> 1);
        const int j = (i & 1) ? MAXC - 1 - p : p;
        if (j >= valid) continue;
        const float cuj = sm.CU[j * LD + d];
        float a = 0.0f;
        for (int t = j + 1; t < valid; ++t) {
          a = fmaf(sm.DA[t * LA + j] * sm.R[t * LD + d],
                   expf(sm.CP[t * LD + d] - cuj), a);
        }
        sm.V[j * LD + d] = sm.K[j * LD + d] * a;
        dk[off + j * s.tok + d] =
            a + sm.DA[j * LA + j] * ud * sm.R[j * LD + d];
      }
    }
  }
  __syncthreads();
  const long long chunk = (long long)bh * g.nC + c;
  // dlw's intra share, sum_{t>s} r dr' - sum_{t>=s} k dk'', and the
  // chunk's part of du: a thread a channel, in reverse token order
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float after = 0.0f, from = 0.0f, du = 0.0f;
    for (int t = valid - 1; t >= 0; --t) {
      from += sm.V[t * LD + d];
      dw[off + t * s.tok + d] = after - from;
      after += sm.ATT[t * LA + d];
      du = fmaf(sm.DA[t * LA + t] * sm.R[t * LD + d], sm.K[t * LD + d], du);
    }
    dup[chunk * D + d] = du;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < MAXC * MAXC; e += NT) {
    const int t = e >> 6, d = e & (MAXC - 1);
    if (t < C && d < Dp) sm.R[t * LD + d] *= expf(sm.CP[t * LD + d]);
  }
  __syncthreads();
  // the chunk's (r * exp(cum_prev))^T dy, (D, D): a 2 x 4 tile a thread
  float* qc = q + chunk * D * D;
  const int d0 = (threadIdx.x >> 4) * 2, f0 = (threadIdx.x & 15) * 4;
  if (d0 < Dp && f0 < Dp) {
    float acc[2][4] = {};
    for (int t = 0; t < C; ++t) {
      const float2 rd = *reinterpret_cast<const float2*>(sm.R + t * LD + d0);
      const float4 yy = *reinterpret_cast<const float4*>(sm.DY + t * LD + f0);
      const float ra[2] = {rd.x, rd.y};
      const float ya[4] = {yy.x, yy.y, yy.z, yy.w};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(ra[i], ya[jj], acc[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (d0 + i < D && f0 + jj < D) qc[(d0 + i) * D + f0 + jj] = acc[i][jj];
      }
    }
  }
  for (int d = threadIdx.x; d < D; d += NT) tot[chunk * D + d] = sm.TOT[d];
}

// A thread owns element e = (d, f) of a stream's state adjoint and walks
// the chunks in reverse: q[c] <- G_{c+1}; G = exp(total_c[d]) * G + q_c.
// Eight chunks' terms and totals are loaded before any is written over.
__global__ void __launch_bounds__(NS)
wkv6_bwd_scan(float* __restrict__ q, const float* __restrict__ tot,
              const float* __restrict__ ds_end, float* __restrict__ ds0,
              Shape g) {
  constexpr int kAhead = 8;
  const int bh = blockIdx.x, D = g.D;
  const int e = blockIdx.y * NS + threadIdx.x;
  if (e >= D * D) return;
  const int d = e / D;
  const long long dd = (long long)D * D;
  float G = ds_end ? ds_end[bh * dd + e] : 0.0f;
  float* p = q + (long long)bh * g.nC * dd + e;
  const float* w = tot + (long long)bh * g.nC * D + d;
  for (int c0 = g.nC - 1; c0 >= 0; c0 -= kAhead) {
    float add[kAhead], lw[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 - i >= 0) {
        add[i] = p[(c0 - i) * dd];
        lw[i] = w[(c0 - i) * D];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 - i >= 0) {
        p[(c0 - i) * dd] = G;
        G = expf(lw[i]) * G + add[i];
      }
    }
  }
  if (ds0) ds0[bh * dd + e] = G;
}

// A (D, D) state from src, transposed: dst[f * LD + d] = src[d * D + f],
// padded by zeros to Dp.
__device__ __forceinline__ void load_state_t(float* dst, const float* src,
                                             int D, int Dp) {
  for (int e = threadIdx.x; e < MAXC * MAXC; e += NT) {
    const int i = e >> 6, j = e & (MAXC - 1);
    if (i < Dp && j < Dp) {
      dst[j * LD + i] = (i < D && j < D) ? src[i * D + j] : 0.0f;
    }
  }
}

struct BwdInterSmem {
  float R[MAXC * LD];    // r
  float K[MAXC * LD];    // k, then k * exp(total - cum)
  float V[MAXC * LD];    // v, then k * dk's state share
  float DY[MAXC * LD];   // dy, then r * dr's state share, then dlw's
  float CP[MAXC * LD];   // cum_prev
  float CU[MAXC * LD];   // lw, then cum
  float ST[MAXC * LD];   // the chunk's starting state S, transposed
  float GT[MAXC * LD];   // G_{c+1}, transposed
  float G[MAXC * LD];    // G_{c+1}
  float TOT[MAXC];
  float E[MAXC];         // exp(total[d]) sum_f S[d,f] G[d,f]
};

__global__ void __launch_bounds__(NT, 1)
wkv6_bwd_inter(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ dy, const float* __restrict__ sst,
               const float* __restrict__ gst, float* __restrict__ dr,
               float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dw, Shape g) {
  extern __shared__ float4 smem4[];
  BwdInterSmem& sm = *reinterpret_cast<BwdInterSmem*>(smem4);
  const int bh = blockIdx.x, c = blockIdx.y, C = g.C, D = g.D, Dp = g.Dp;
  const Stream s = stream_of(g, bh, c);
  const long long off = s.off;
  const int valid = s.valid;
  load_tile(sm.R, s, r + off, D, Dp, g.vec);
  load_tile(sm.K, s, k + off, D, Dp, g.vec);
  load_tile(sm.V, s, v + off, D, Dp, g.vec);
  load_tile(sm.DY, s, dy + off, D, Dp, g.vec);
  load_tile(sm.CU, s, lw + off, D, Dp, g.vec);
  const long long chunk = (long long)bh * g.nC + c;
  Stream st;
  st.off = 0;
  st.tok = D;
  st.valid = D;
  load_tile(sm.G, st, gst + chunk * D * D, D, Dp, g.vec);
  load_state_t(sm.ST, sst + chunk * D * D, D, Dp);
  load_state_t(sm.GT, gst + chunk * D * D, D, Dp);
  __syncthreads();
  scan_tile(sm.CU, sm.CP, sm.TOT, C, Dp);
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float a = 0.0f;
    for (int f = 0; f < D; ++f) a = fmaf(sm.ST[f * LD + d], sm.GT[f * LD + d], a);
    sm.E[d] = expf(sm.TOT[d]) * a;
  }
  // dy S^T and v G^T: a 2 x 4 tile (rows t, channels d) a thread
  const int t0 = (threadIdx.x >> 4) * 2, c0 = (threadIdx.x & 15) * 4;
  float ar[2][4] = {}, ak[2][4] = {};
  if (t0 < valid && c0 < Dp) {
    for (int f = 0; f < Dp; ++f) {
      const float4 sv = *reinterpret_cast<const float4*>(sm.ST + f * LD + c0);
      const float4 gv = *reinterpret_cast<const float4*>(sm.GT + f * LD + c0);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float yy = sm.DY[(t0 + i) * LD + f], vv = sm.V[(t0 + i) * LD + f];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          ar[i][jj] = fmaf(yy, sa[jj], ar[i][jj]);
          ak[i][jj] = fmaf(vv, ga[jj], ak[i][jj]);
        }
      }
    }
  }
  __syncthreads();   // dy and v are read: they take r * dr''' and k * dk'''
  if (t0 < valid && c0 < Dp) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + i;
      if (t >= valid) break;
      float rs[4], ks[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = c0 + jj;
        rs[jj] = expf(sm.CP[t * LD + d]) * ar[i][jj];
        ks[jj] = expf(sm.TOT[d] - sm.CU[t * LD + d]) * ak[i][jj];
        sm.DY[t * LD + d] = sm.R[t * LD + d] * rs[jj];
        sm.V[t * LD + d] = sm.K[t * LD + d] * ks[jj];
      }
      float* rt = dr + off + t * s.tok + c0;
      float4 a = load4(rt, D - c0, g.vec);
      a.x += rs[0];
      a.y += rs[1];
      a.z += rs[2];
      a.w += rs[3];
      store4(rt, a, D - c0, g.vec);
      float* kt = dk + off + t * s.tok + c0;
      a = load4(kt, D - c0, g.vec);
      a.x += ks[0];
      a.y += ks[1];
      a.z += ks[2];
      a.w += ks[3];
      store4(kt, a, D - c0, g.vec);
    }
  }
  __syncthreads();
  // dlw's state share, sum_{t>s} r dr''' + sum_{t<s} k dk''' + E, into the dy
  // tile: a thread a channel, the first sum in reverse token order, the
  // second in order (added to dw below by every thread, in one pass)
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float after = 0.0f;
    for (int t = valid - 1; t >= 0; --t) {
      const float x = sm.DY[t * LD + d];
      sm.DY[t * LD + d] = after;
      after += x;
    }
    float before = 0.0f;
    for (int t = 0; t < valid; ++t) {
      sm.DY[t * LD + d] = sm.DY[t * LD + d] + before + sm.E[d];
      before += sm.V[t * LD + d];
    }
  }
  for (int e = threadIdx.x; e < MAXC * MAXC; e += NT) {
    const int t = e >> 6, d = e & (MAXC - 1);
    if (t < C && d < Dp) sm.K[t * LD + d] *= expf(sm.TOT[d] - sm.CU[t * LD + d]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < MAXC * (MAXC / 4); e += NT) {
    const int t = e >> 4, d0 = (e & 15) * 4;
    if (t < valid && d0 < Dp) {
      float* wt = dw + off + t * s.tok + d0;
      const float4 add = *reinterpret_cast<const float4*>(sm.DY + t * LD + d0);
      float4 a = load4(wt, D - d0, g.vec);
      a.x += add.x;
      a.y += add.y;
      a.z += add.z;
      a.w += add.w;
      store4(wt, a, D - d0, g.vec);
    }
  }
  // dv += (k * exp(total - cum)) G_{c+1}: a 2 x 4 tile a thread
  if (t0 < valid && c0 < Dp) {
    float acc[2][4] = {};
    for (int d = 0; d < Dp; ++d) {
      const float4 gv = *reinterpret_cast<const float4*>(sm.G + d * LD + c0);
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float kd = sm.K[(t0 + i) * LD + d];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(kd, ga[jj], acc[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (t0 + i >= valid) break;
      float* vt = dv + off + (t0 + i) * s.tok + c0;
      float4 a = load4(vt, D - c0, g.vec);
      a.x += acc[i][0];
      a.y += acc[i][1];
      a.z += acc[i][2];
      a.w += acc[i][3];
      store4(vt, a, D - c0, g.vec);
    }
  }
}

// du[h, d]: the chunks' parts of head h summed over the batch, then the
// chunks, in order.
__global__ void __launch_bounds__(MAXC)
wkv6_bwd_du(const float* __restrict__ dup, float* __restrict__ du, Shape g) {
  const int h = blockIdx.x, d = threadIdx.x;
  if (d >= g.D) return;
  float a = 0.0f;
  for (int b = 0; b < g.B; ++b) {
    const float* p = dup + ((long long)(b * g.H + h) * g.nC) * g.D + d;
    for (int c = 0; c < g.nC; ++c) a += p[(long long)c * g.D];
  }
  du[h * g.D + d] = a;
}

}  // namespace

extern "C" {

// r, k, v, lw, dy: (B, S, H, D) f32 contiguous; u: (H, D); sst: the
// forward's scratch after its launches, each chunk's starting state,
// (B, H, nC, D, D); ds_end: (B, H, D, D) or null (zero).  Writes dr, dk,
// dv, dw (B, S, H, D), du (H, D) and, unless null, ds0 (B, H, D, D).
// Scratch: q (B, H, nC, D, D), tot (B, H, nC, D), dup (B, H, nC, D) f32,
// nC = ceil(S / C).  Four launches on `stream`.  Returns a cudaError_t.
int wkv6_bwd_launch(const float* r, const float* k, const float* v,
                    const float* lw, const float* u, const float* dy,
                    const float* sst, const float* ds_end, float* dr,
                    float* dk, float* dv, float* dw, float* du, float* ds0,
                    float* q, float* tot, float* dup, int B, int S, int H,
                    int D, int C, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > MAXC || C < 1 || C > MAXC)
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const int vec = D % 4 == 0 && aligned(r) && aligned(k) && aligned(v) &&
                  aligned(lw) && aligned(dy) && aligned(q) && aligned(dr) &&
                  aligned(dk) && aligned(dv) && aligned(dw) &&
                  aligned(sst);
  const Shape g{B, S, H, D, C, (S + C - 1) / C, (D + 3) / 4 * 4, vec};
  auto st = static_cast<cudaStream_t>(stream);
  const int intra = (int)sizeof(BwdIntraSmem), inter = (int)sizeof(BwdInterSmem);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_intra, cudaFuncAttributeMaxDynamicSharedMemorySize, intra);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        wkv6_bwd_inter, cudaFuncAttributeMaxDynamicSharedMemorySize, inter);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 chunks(B * H, g.nC);
  wkv6_bwd_intra<<<chunks, NT, intra, st>>>(r, k, v, lw, u, dy, dr, dk, dv,
                                            dw, q, tot, dup, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_scan<<<dim3(B * H, (D * D + NS - 1) / NS), NS, 0, st>>>(
      q, tot, ds_end, ds0, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_inter<<<chunks, NT, inter, st>>>(r, k, v, lw, dy, sst, q, dr, dk,
                                            dv, dw, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_du<<<H, MAXC, 0, st>>>(dup, du, g);
  return (int)cudaGetLastError();
}

const char* wkv6_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
