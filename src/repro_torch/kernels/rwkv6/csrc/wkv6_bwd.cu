// Backward of the chunked WKV6 recurrence (K6) for Hopper (sm_90a), CUDA C++.
//
// The gradient of wkv6.cu's function, (y, S_end) = WKV6(r, k, v, lw, u, S_0),
// for the cotangents dy and dS_end: (dr, dk, dv, dlw, du, dS_0).  It
// replaces no Pallas kernel: the reference has no backward kernel and gets
// the gradient from XLA's autodiff of `repro.nn.ssm.wkv6_chunked`
// (src/repro/nn/ssm.py:118-170); the plain version here is
// `ref.wkv6_bwd_ref`, and `ref.wkv6_bwd_factored` emulates this file's
// algorithm for the CPU tests.  Within a chunk of C tokens, with cum the
// inclusive and cum_prev the exclusive cumulative log-decays, total =
// cum[C - 1], the scores att[t, j] = sum_d r[t,d] k[j,d] exp(cum_prev[t,d]
// - cum[j,d]) for j < t (the bonus r_t . u k_t on the diagonal), d_att[t, j]
// = dy_t . v_j, S the chunk's starting state and G the gradient of the next
// chunk's (G = dS_end after the last chunk):
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
// (cum reaches -1e4 under strong decay).
//
// Design: four launches on the caller's stream, no atomics (two runs give
// the same bits):
//
//   (p) wkv6_bwd_pre, grid (B*H, nC), one chunk a block: r, lw and dy in;
//       cum_prev and total in token order (the forward's scan_tile
//       arithmetic, so the same bits); q = (r * exp(cum_prev))^T dy on the
//       tensor cores into a (B, H, nC, D, D) scratch, total into
//       (B, H, nC, D);
//   (b') wkv6_bwd_scan, grid (B*H, D*D / 256): a thread an element of the
//       state's adjoint, over the chunks in reverse from dS_end (or 0): it
//       writes G_{c+1} over chunk c's q, then G = exp(total) G + q, and dS_0
//       at the end;
//   (f) wkv6_bwd_chunk, grid (B*H, nC), one chunk a block: r, k, v, dy and
//       lw read once, with S (the forward's saved starting state) and
//       G_{c+1}; the intra-chunk and the state's shares together; dr, dk,
//       dv and dlw written once (no read-modify-write), and the chunk's
//       part of du;
//   (d') wkv6_bwd_du, grid H: each head's du, the chunks' parts summed over
//       the batch and the chunks in order.
//
// The factored exponent.  A chunk's rows are cut into sub-chunks of L = 16
// tokens, the 16 rows of an mma.m16n8k8 tile, so that every block pair is
// whole tensor-core tiles (L = 8 would halve the diagonal's exponentials but
// cut each tile across two reference points).  For a query sub-chunk a and
// the keys before it, the pair decay is split at ref_a = cum_prev[16a]:
// exp(cum_prev[t] - ref_a) <= 1 for t in a and exp(ref_a - cum[j]) <= 1 for
// j < 16a; att = (r * the first)(k * the second)^T and dr's share
// exp(cum_prev - ref_a) * (d_att (k * the second)) are tensor-core
// products.  For a key sub-chunk b and the queries after it, dk's share
// exp(ref_b - cum) * (d_att^T (r * exp(cum_prev - ref_b))) at ref_b =
// cum[16b + 15].  As the product is no larger than either factor, a factor
// that underflows loses nothing the exact decay keeps, and nothing
// overflows however strong the decay (one reference for the whole chunk
// would: exp(-cum[j]) passes f32's range once cum < -88).  The diagonal
// 16 x 16 blocks keep the exact pairwise expf(cum_prev[t] - cum[j]) on the
// CUDA cores: for dr and dk one exponential a term, a lane taking one
// column of a sub-chunk's rows and handing each row's sums to the lanes
// whose accumulators hold it (shuffles); for att's diagonal tiles a thread
// a pair.  d_att = dy v^T, att^T dy, dy S^T, v G^T, (k exp(total - cum)) G
// and q are tensor-core products too; the dlw sums stay in-chunk sums,
// every exponent <= 0.
//
// Split TF32.  One TF32 product keeps 11 bits of each operand and reads
// 7e-4 to 2e-3 relative L2 from the plain backward (the emulation, on the
// tests' draws): outside the 1e-4 gate.  So every product is hi*hi + hi*lo
// + lo*hi on mma.sync.m16n8k8 TF32, hi = x with the low 13 mantissa bits
// cleared and lo = (x - hi) cleared the same way: the dropped lo*lo term
// and lo's own rounding are ~2^-21 of each term, and the emulation reads
// 3e-7 to 3e-6 from the plain backward.  The sums are f32 in the tensor
// cores' accumulators.
//
// Bound on the H100 at rwkv6-3b's micro-batch (2, 4096, 40, 64), 5120
// chunks: chip_smoke.k6_bwd_bound's 0.290 ms of f32 operations (the bytes
// that must move, 755 MB, take 0.225 ms).  This design moves 1.43 GB,
// 0.427 ms at 3.35 TB/s: (f) 114,688 bytes in and 65,536 out a chunk, (p)
// 49,152 in and 16,384 out, (b') q read and written; its tensor-core work
// is 3 x 12.6 GFLOP, ~0.08 ms at TF32's 495 TFLOP/s, and its exponentials
// (~119 K a chunk, 61 K of them the diagonal blocks') ~0.1 ms at the SFU's
// 16 a clock a SM.  On the H100 (chip_smoke.py, 700 W) a call takes
// 1.38-1.41 ms, 1.10 of them (f): latency-bound at 16 warps an SM, no one
// part dominant (tests/_torch_wkv6_bwd_variants.py: without the diagonal
// dr/dk terms 0.19 ms less, without att's diagonal tiles 0.16, __expf for
// expf 0.16, one TF32 product for three 0.12).
//
// Residency.  (f) holds six swizzled 64 x 64 f32 tiles (r, k, v, dy, cum,
// cum_prev; 16 KB each, no padding: a row's 16-byte groups are permuted by
// its index so that mma fragments read down a column or along a row meet
// no bank conflict) and one 16 KB region that takes in turn d_att's ten
// 16 x 16 lower tiles, att^T's, S, and the dlw sums: 115,200 bytes with u
// and the dlw's state term, two blocks an SM (128 registers a thread,
// __launch_bounds__(256, 2), no spill: the factored dr/dk and dr's state
// products run in two halves of the warp's columns, 8 accumulators at a
// time).  G takes dy's tile once dr is done,
// and the dlw terms r dr', k dk'' and k dk''' take the tiles of r,
// cum_prev and v.  S and G are prefetched into L2 as the block starts;
// the tiles load by cp.async.  (p) holds three tiles, 49,152 bytes.
#include "wkv6_tile.cuh"

namespace {

constexpr int NTB = 256;          // threads a block of (p) and (f): 8 warps
constexpr int TS = MAXC * MAXC;   // floats of a swizzled 64 x 64 tile
constexpr int LT = 20;            // row stride of a 16 x 16 intra tile
constexpr int TT = 16 * LT;       // floats of one; ten in the intra region
constexpr int DUP_AT = 10 * TT;   // the du parts' place in the intra region
constexpr int CHUNK_SMEM = (7 * TS + 2 * MAXC) * 4;
constexpr int PRE_SMEM = 3 * TS * 4;

// Element (t, d) of a swizzled tile: the 16-byte groups of row t permuted
// by t's low three bits, within each half of the row.
__device__ __forceinline__ int swz(int t, int d) {
  return t * MAXC + (d ^ (((t & 3) << 3) | (t & 4)));
}

// Intra tile (a, b), b <= a, of the ten lower 16 x 16 tiles.
__device__ __forceinline__ int tri(int a, int b) { return a * (a + 1) / 2 + b; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Rows < nrows and columns < D of a (rows, ld) f32 array at src into the
// swizzled tile dst, zeros elsewhere: cp.async of 16 bytes where `vec`
// (D a multiple of 4, every row on 16 bytes), single floats elsewhere.
__device__ __forceinline__ void load_sw(float* dst, const float* src,
                                        long long ld, int nrows, int D,
                                        int vec) {
  for (int e = threadIdx.x; e < MAXC * (MAXC / 4); e += NTB) {
    const int t = e >> 4, c = (e & 15) * 4;
    float* p = dst + swz(t, c);
    if (t < nrows && c < D) {
      const float* s = src + t * ld + c;
      if (vec) {
        cp_async16(p, s);
      } else {
        p[0] = s[0];
        p[1] = c + 1 < D ? s[1] : 0.0f;
        p[2] = c + 2 < D ? s[2] : 0.0f;
        p[3] = c + 3 < D ? s[3] : 0.0f;
      }
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// x = hi + lo + (x - hi - lo), hi and lo TF32 by truncation
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[n] += A B[:, 8n:8n+8] for a warp, A (16 x 8KS) and B (8KS x 8N) read
// element by element through fa(row, k) and fb(k, col), in split TF32: the
// small products first.  acc[n] is the m16n8 accumulator: element e of
// lane (g, q) = (lane / 4, lane % 4) is (row g + 8 (e / 2), col 2q + e % 2).
template <int N, int KS, class FA, class FB>
__device__ __forceinline__ void mma3(float (&acc)[N][4], FA fa, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = ks * 8 + q;
    const float a[4] = {fa(g, k0), fa(g + 8, k0), fa(g, k0 + 4),
                        fa(g + 8, k0 + 4)};
    unsigned ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      unsigned bh0, bl0, bh1, bl1;
      split(fb(k0, n * 8 + g), bh0, bl0);
      split(fb(k0 + 4, n * 8 + g), bh1, bl1);
      mma_tf32(acc[n], al, bh0, bh1);
      mma_tf32(acc[n], ah, bl0, bl1);
      mma_tf32(acc[n], ah, bh0, bh1);
    }
  }
}

// The cumulative log-decays of each channel of the tile `cu` (which holds
// lw on entry), a thread a channel summing its 64 rows in order as the
// forward's scan_tile does (the rows past the chunk are zero): cum into
// `cu` unless it is `cp`, cum_prev = cum - lw into `cp`; -> total, for threads
// below 64.  It must stay bit-identical to scan_tile (wkv6_tile.cuh): the
// same sums in the same order, so the backward's decays are the forward's.
__device__ __forceinline__ float scan_sw(float* cu, float* cp) {
  const int d = threadIdx.x;
  float run = 0.0f;
  if (d < MAXC) {
    for (int t0 = 0; t0 < MAXC; t0 += 16) {
      float w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = cu[swz(t0 + i, d)];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        run += w[i];
        if (cp != cu) cu[swz(t0 + i, d)] = run;
        cp[swz(t0 + i, d)] = run - w[i];
      }
    }
  }
  return run;
}

// Four floats at (t, d), d even, of a warp's accumulator layout as a pair.
__device__ __forceinline__ float2 ld2(const float* tile, int t, int d) {
  return *reinterpret_cast<const float2*>(tile + swz(t, d));
}

__device__ __forceinline__ void st2(float* tile, int t, int d, float x,
                                    float y) {
  *reinterpret_cast<float2*>(tile + swz(t, d)) = make_float2(x, y);
}

// Two neighbouring elements (t, d), (t, d + 1) of a (rows, ld) output, d
// even: one 8-byte store where `vec`.
__device__ __forceinline__ void out2(float* p, int d, int D, float x, float y,
                                     int vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    if (d < D) p[0] = x;
    if (d + 1 < D) p[1] = y;
  }
}

// (p): q = (r * exp(cum_prev))^T dy of a chunk, and its total.
__global__ void __launch_bounds__(NTB, 3)
wkv6_bwd_pre(const float* __restrict__ r, const float* __restrict__ lw,
             const float* __restrict__ dy, float* __restrict__ q,
             float* __restrict__ tot, Shape g) {
  extern __shared__ float4 smem4[];
  float* R = reinterpret_cast<float*>(smem4);
  float* CP = R + TS;
  float* DY = R + 2 * TS;
  const int bh = blockIdx.x, c = blockIdx.y, D = g.D;
  const Stream s = stream_of(g, bh, c);
  load_sw(CP, lw + s.off, s.tok, s.valid, D, g.vec);
  cp_commit();
  load_sw(R, r + s.off, s.tok, s.valid, D, g.vec);
  load_sw(DY, dy + s.off, s.tok, s.valid, D, g.vec);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  const long long chunk = (long long)bh * g.nC + c;
  const float total = scan_sw(CP, CP);
  if (threadIdx.x < D) tot[chunk * D + threadIdx.x] = total;
  cp_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < TS; e += NTB) R[e] *= expf(CP[e]);
  __syncthreads();
  // a warp 16 rows d by 32 columns e of q
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = (warp >> 1) * 16, e0 = (warp & 1) * 32;
  float acc[4][4] = {};
  mma3<4, 8>(acc, [&](int row, int kk) { return R[swz(kk, d0 + row)]; },
             [&](int kk, int col) { return DY[swz(kk, e0 + col)]; });
  float* qc = q + chunk * D * D;
  const int gq = lane >> 2, e1 = e0 + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int d = d0 + gq + 8 * hf, e = e1 + 8 * n;
      if (d < D && e < D) {
        out2(qc + d * D + e, e, D, acc[n][2 * hf], acc[n][2 * hf + 1],
             g.vec);
      }
    }
  }
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

// (f): the fused chunk pass, one chunk a block.  Warp w owns rows
// 16i..16i+15 (i = w / 2, one sub-chunk) and columns 32h..32h+31 (h = w %
// 2) of dr, dk and dv, in the mma accumulators; the ten d_att tiles and
// the att^T tiles are shared products, each computed once and kept in the
// intra region.
__global__ void __launch_bounds__(NTB, 2)
wkv6_bwd_chunk(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, const float* __restrict__ dy,
               const float* __restrict__ sst, const float* __restrict__ gst,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ dup, Shape g) {
  extern __shared__ float4 smem4[];
  float* R = reinterpret_cast<float*>(smem4);   // r, then r dr'
  float* K = R + TS;                            // k
  float* V = R + 2 * TS;                        // v, then k dk'''
  float* DY = R + 3 * TS;                       // dy, then G_{c+1}
  float* CU = R + 4 * TS;                       // lw, then cum
  float* CP = R + 5 * TS;                       // cum_prev, then k dk''
  float* W = R + 6 * TS;   // d_att, then att^T, then S, then the dlw sums
  float* U = R + 7 * TS;
  float* E = U + MAXC;     // exp(total) sum_f S G
  const int bh = blockIdx.x, c = blockIdx.y, D = g.D, vec = g.vec;
  const Stream s = stream_of(g, bh, c);
  const long long chunk = (long long)bh * g.nC + c;
  const float* Sg = sst + chunk * D * D;
  const float* Gg = gst + chunk * D * D;
  for (int e = threadIdx.x * 32; e < D * D; e += NTB * 32) {
    prefetch_l2(Sg + e);
    prefetch_l2(Gg + e);
  }
  load_sw(CU, lw + s.off, s.tok, s.valid, D, vec);
  cp_commit();
  load_sw(R, r + s.off, s.tok, s.valid, D, vec);
  load_sw(K, k + s.off, s.tok, s.valid, D, vec);
  load_sw(V, v + s.off, s.tok, s.valid, D, vec);
  load_sw(DY, dy + s.off, s.tok, s.valid, D, vec);
  cp_commit();
  if (threadIdx.x < MAXC) {
    U[threadIdx.x] = threadIdx.x < D ? u[(bh % g.H) * D + threadIdx.x] : 0.0f;
  }
  cp_wait<1>();
  __syncthreads();
  scan_sw(CU, CP);
  cp_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, qq = lane & 3;
  const int i = warp >> 1, hc = (warp & 1) * 32;   // the warp's rows, columns
  // the warp's accumulator element e of n-tile n: row rw(e), column cl(n, e)
  auto rw = [&](int e) { return 16 * i + gq + 8 * (e >> 1); };
  auto cl = [&](int n, int e) { return hc + 8 * n + 2 * qq + (e & 1); };

  // d_att = dy v^T, its ten lower 16 x 16 tiles, a tile's 8-column halves
  // spread over the warps
  for (int p = warp; p < 20; p += 8) {
    const int t = p >> 1, nh = p & 1;
    int a = 0;
    while ((a + 1) * (a + 2) / 2 <= t) ++a;
    const int b = t - a * (a + 1) / 2;
    float acc[1][4] = {};
    mma3<1, 8>(acc, [&](int row, int kk) { return DY[swz(16 * a + row, kk)]; },
               [&](int kk, int col) { return V[swz(16 * b + 8 * nh + col, kk)]; });
    float* o = W + t * TT + 8 * nh + 2 * qq;
    *reinterpret_cast<float2*>(o + gq * LT) = make_float2(acc[0][0], acc[0][1]);
    *reinterpret_cast<float2*>(o + (gq + 8) * LT) =
        make_float2(acc[0][2], acc[0][3]);
  }
  __syncthreads();

  float adr[4][4] = {}, adk[4][4] = {};
  const float* dii = W + tri(i, i) * TT;   // d_att's diagonal tile
  {
    // dr's and dk's diagonal blocks, exact, one exponential a term: lane l
    // takes column hc + l of the sub-chunk's rows, then hands each row's
    // sums to the lanes that own them (row t: lanes with g = t % 8)
    const int d = hc + lane;
    float cu[16], kj[16], dkd[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      cu[j] = CU[swz(16 * i + j, d)];
      kj[j] = K[swz(16 * i + j, d)];
      dkd[j] = 0.0f;
    }
#pragma unroll 1
    for (int t = 1; t < 16; ++t) {
      const float cpt = CP[swz(16 * i + t, d)], rt = R[swz(16 * i + t, d)];
      const float* x = dii + t * LT;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 15; ++j) {
        if (j < t) {
          const float xj = x[j], e = expf(cpt - cu[j]);
          acc = fmaf(xj * kj[j], e, acc);
          dkd[j] = fmaf(xj * rt, e, dkd[j]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float y = __shfl_sync(0xffffffffu, acc, 8 * n + 2 * qq + cc);
          if (gq == (t & 7)) {
            if (t < 8) {
              adr[n][cc] = y;
            } else {
              adr[n][2 + cc] = y;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float y = __shfl_sync(0xffffffffu, dkd[j], 8 * n + 2 * qq + cc);
          if (gq == (j & 7)) adk[n][(j >> 3) * 2 + cc] = y;
        }
      }
    }
  }
  {
    // dr's factored share, the keys of the sub-chunks before i, in two
    // halves of the warp's columns (8 accumulators at a time)
#pragma unroll 1
    for (int hf = 0; hf < 2 && i > 0; ++hf) {
      float t2[2][4] = {};
      for (int b = 0; b < i; ++b) {
        const float* da = W + tri(i, b) * TT;
        mma3<2, 2>(t2, [&](int row, int kk) { return da[row * LT + kk]; },
                   [&](int kk, int col) {
                     const int j = 16 * b + kk, d = hc + 16 * hf + col;
                     return K[swz(j, d)] *
                            expf(CP[swz(16 * i, d)] - CU[swz(j, d)]);
                   });
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = cl(n, e) + 16 * hf;
          const float x = expf(CP[swz(rw(e), d)] - CP[swz(16 * i, d)]);
          if (hf == 0) {
            adr[n][e] = fmaf(t2[n][e], x, adr[n][e]);
          } else {
            adr[2 + n][e] = fmaf(t2[n][e], x, adr[2 + n][e]);
          }
        }
      }
    }
  }
  {
    // dk's factored share, the queries of the sub-chunks after i, in two
    // halves of the warp's columns
#pragma unroll 1
    for (int hf = 0; hf < 2 && i < 3; ++hf) {
      float t2[2][4] = {};
      for (int a = i + 1; a < 4; ++a) {
        const float* da = W + tri(a, i) * TT;
        mma3<2, 2>(t2, [&](int row, int kk) { return da[kk * LT + row]; },
                   [&](int kk, int col) {
                     const int t = 16 * a + kk, d = hc + 16 * hf + col;
                     return R[swz(t, d)] *
                            expf(CP[swz(t, d)] - CU[swz(16 * i + 15, d)]);
                   });
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = cl(n, e) + 16 * hf;
          const float x = expf(CU[swz(16 * i + 15, d)] - CU[swz(rw(e), d)]);
          if (hf == 0) {
            adk[n][e] = fmaf(t2[n][e], x, adk[n][e]);
          } else {
            adk[2 + n][e] = fmaf(t2[n][e], x, adk[2 + n][e]);
          }
        }
      }
    }
  }
  // d_att's diagonal (dy_t . v_t), for the bonus; the sub-chunk's part of
  // du, summed over its rows by the warp
  const float dd[2] = {dii[gq * LT + gq], dii[(gq + 8) * LT + gq + 8]};
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int d = cl(n, cc);
      float part = 0.0f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = rw(2 * hf);
        part = fmaf(dd[hf] * R[swz(t, d)], K[swz(t, d)], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      part += __shfl_xor_sync(0xffffffffu, part, 8);
      part += __shfl_xor_sync(0xffffffffu, part, 16);
      if (gq == 0) W[DUP_AT + i * MAXC + d] = part;
    }
  }
  __syncthreads();   // d_att is read: the region takes att^T

  // att^T off the diagonal, tile (a, b) = att[a's rows, b's columns]^T,
  // its 8-column halves spread over the warps
  for (int p = warp; p < 12; p += 8) {
    const int pair = p >> 1, nh = p & 1;
    int a = 1;
    while (a * (a + 1) / 2 <= pair) ++a;
    const int b = pair - a * (a - 1) / 2;
    float acc[1][4] = {};
    mma3<1, 8>(acc,
               [&](int row, int kk) {
                 const int j = 16 * b + row;
                 return K[swz(j, kk)] * expf(CP[swz(16 * a, kk)] - CU[swz(j, kk)]);
               },
               [&](int kk, int col) {
                 const int t = 16 * a + 8 * nh + col;
                 return R[swz(t, kk)] * expf(CP[swz(t, kk)] - CP[swz(16 * a, kk)]);
               });
    float* o = W + tri(a, b) * TT + 8 * nh + 2 * qq;
    *reinterpret_cast<float2*>(o + gq * LT) = make_float2(acc[0][0], acc[0][1]);
    *reinterpret_cast<float2*>(o + (gq + 8) * LT) =
        make_float2(acc[0][2], acc[0][3]);
  }
  // att^T's diagonal tiles, exact: 120 pairs j < t a sub-chunk, the bonus
  // on the diagonal, zeros above it
  for (int it = threadIdx.x; it < 4 * 136; it += NTB) {
    const int a = it / 136, p = it % 136;
    float* o = W + tri(a, a) * TT;
    if (p < 120) {
      int tl = 1;
      while (tl * (tl + 1) / 2 <= p) ++tl;
      const int jl = p - tl * (tl - 1) / 2, t = 16 * a + tl, j = 16 * a + jl;
      float a4[4] = {};
      for (int d = 0; d < MAXC; d += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(R + swz(t, d));
        const float4 cp = *reinterpret_cast<const float4*>(CP + swz(t, d));
        const float4 kk = *reinterpret_cast<const float4*>(K + swz(j, d));
        const float4 cu = *reinterpret_cast<const float4*>(CU + swz(j, d));
        a4[0] = fmaf(rr.x * kk.x, expf(cp.x - cu.x), a4[0]);
        a4[1] = fmaf(rr.y * kk.y, expf(cp.y - cu.y), a4[1]);
        a4[2] = fmaf(rr.z * kk.z, expf(cp.z - cu.z), a4[2]);
        a4[3] = fmaf(rr.w * kk.w, expf(cp.w - cu.w), a4[3]);
      }
      o[jl * LT + tl] = (a4[0] + a4[1]) + (a4[2] + a4[3]);
      o[tl * LT + jl] = 0.0f;
    } else {
      const int t = 16 * a + p - 120;
      float acc = 0.0f;
      for (int d = 0; d < MAXC; ++d) {
        acc = fmaf(R[swz(t, d)] * U[d], K[swz(t, d)], acc);
      }
      o[(p - 120) * (LT + 1)] = acc;
    }
  }
  if (threadIdx.x < D) {
    const float* pp = W + DUP_AT + threadIdx.x;
    dup[chunk * D + threadIdx.x] = ((pp[0] + pp[MAXC]) + pp[2 * MAXC]) +
                                   pp[3 * MAXC];
  }
  __syncthreads();

  // dv's intra share, att^T dy, over the query sub-chunks a >= i
  float adv[4][4] = {};
  for (int a = i; a < 4; ++a) {
    const float* at = W + tri(a, i) * TT;
    mma3<4, 2>(adv, [&](int row, int kk) { return at[row * LT + kk]; },
               [&](int kk, int col) { return DY[swz(16 * a + kk, hc + col)]; });
  }
  __syncthreads();   // att^T is read: the region takes S
  load_sw(W, Sg, D, D, D, vec);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const long long off = s.off;
  const long long tok = s.tok;
  {
    // dr's state share exp(cum_prev) * (dy S^T); r dr' for dlw; dr out
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float t2[2][4] = {};
      mma3<2, 8>(t2, [&](int row, int kk) { return DY[swz(16 * i + row, kk)]; },
                 [&](int kk, int col) { return W[swz(hc + 16 * hf + col, kk)]; });
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = expf(CP[swz(rw(e), cl(n, e) + 16 * hf)]);
          if (hf == 0) {
            adr[n][e] = fmaf(t2[n][e], x, adr[n][e]);
          } else {
            adr[2 + n][e] = fmaf(t2[n][e], x, adr[2 + n][e]);
          }
        }
      }
    }
    float t4[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = rw(e), d = cl(n, e);
        t4[n][e] = R[swz(t, d)] * adr[n][e];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = rw(2 * hf), d = cl(n, 0);
        if (t < s.valid && d < D) {
          const float2 kk = ld2(K, t, d);
          out2(dr + off + t * tok + d, d, D,
               fmaf(dd[hf] * U[d], kk.x, adr[n][2 * hf]),
               fmaf(dd[hf] * U[d + 1], kk.y, adr[n][2 * hf + 1]), vec);
        }
      }
    }
    // k dk'' for dlw, then dk's bonus (it reads r, which the region of
    // r dr' takes next)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = rw(e), d = cl(n, e);
        adr[n][e] = K[swz(t, d)] * adk[n][e];
        adk[n][e] = fmaf(dd[e >> 1] * U[d], R[swz(t, d)], adk[n][e]);
      }
    }
    __syncthreads();   // r, dy and cum_prev are read
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = rw(2 * hf), d = cl(n, 0);
        st2(R, t, d, t4[n][2 * hf], t4[n][2 * hf + 1]);
        st2(CP, t, d, adr[n][2 * hf], adr[n][2 * hf + 1]);
      }
    }
  }
  load_sw(DY, Gg, D, D, D, vec);   // G_{c+1} takes dy's tile
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  {
    // dlw's state term, a channel's sum over S G by four threads
    const int d = threadIdx.x >> 2, part = threadIdx.x & 3;
    float a = 0.0f;
    for (int f = 16 * part; f < 16 * part + 16; ++f) {
      a = fmaf(W[swz(d, f)], DY[swz(d, f)], a);
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    if (part == 0) E[d] = expf(CU[swz(MAXC - 1, d)]) * a;
  }
  // dv's state share (k exp(total - cum)) G; dv out
  mma3<4, 8>(adv,
             [&](int row, int kk) {
               const int j = 16 * i + row;
               return K[swz(j, kk)] *
                      expf(CU[swz(MAXC - 1, kk)] - CU[swz(j, kk)]);
             },
             [&](int kk, int col) { return DY[swz(kk, hc + col)]; });
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = rw(2 * hf), d = cl(n, 0);
      if (t < s.valid && d < D) {
        out2(dv + off + t * tok + d, d, D, adv[n][2 * hf],
             adv[n][2 * hf + 1], vec);
      }
    }
  }
  float t4[4][4] = {};
  {
    // dk's state share exp(total - cum) * (v G^T); k dk''' for dlw; dk out
    mma3<4, 8>(t4, [&](int row, int kk) { return V[swz(16 * i + row, kk)]; },
               [&](int kk, int col) { return DY[swz(hc + col, kk)]; });
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = rw(e), d = cl(n, e);
        const float x =
            t4[n][e] * expf(CU[swz(MAXC - 1, d)] - CU[swz(t, d)]);
        adk[n][e] += x;
        t4[n][e] = K[swz(t, d)] * x;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = rw(2 * hf), d = cl(n, 0);
        if (t < s.valid && d < D) {
          out2(dk + off + t * tok + d, d, D, adk[n][2 * hf],
               adk[n][2 * hf + 1], vec);
        }
      }
    }
  }
  __syncthreads();   // v, G and S are read
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      st2(V, rw(2 * hf), cl(n, 0), t4[n][2 * hf], t4[n][2 * hf + 1]);
    }
  }
  __syncthreads();
  // dlw[s] = sum_{t>s} r dr' - sum_{t>=s} k dk'' + sum_{t<s} k dk''' + E: a
  // thread a channel and sub-chunk, the sub-chunks' sums first
  const int d = threadIdx.x & (MAXC - 1), blk = threadIdx.x >> 6;
  {
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    for (int t = 16 * blk; t < 16 * blk + 16; ++t) {
      sx += R[swz(t, d)];
      sy += CP[swz(t, d)];
      sz += V[swz(t, d)];
    }
    W[blk * MAXC + d] = sx;
    W[(4 + blk) * MAXC + d] = sy;
    W[(8 + blk) * MAXC + d] = sz;
  }
  __syncthreads();
  float after = 0.0f, from = 0.0f, before = 0.0f;
  for (int b = 3; b > blk; --b) {
    after += W[b * MAXC + d];
    from += W[(4 + b) * MAXC + d];
  }
  for (int b = 0; b < blk; ++b) before += W[(8 + b) * MAXC + d];
  for (int t = 16 * blk + 15; t >= 16 * blk; --t) {
    from += CP[swz(t, d)];
    const float x = R[swz(t, d)];
    R[swz(t, d)] = after - from;
    after += x;
  }
  const float ed = E[d];
  for (int t = 16 * blk; t < 16 * blk + 16; ++t) {
    if (t < s.valid && d < D) dw[off + t * tok + d] = R[swz(t, d)] + before + ed;
    before += V[swz(t, d)];
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
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, CHUNK_SMEM);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(wkv6_bwd_chunk,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(wkv6_bwd_pre,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 chunks(B * H, g.nC);
  wkv6_bwd_pre<<<chunks, NTB, PRE_SMEM, st>>>(r, lw, dy, q, tot, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_scan<<<dim3(B * H, (D * D + NS - 1) / NS), NS, 0, st>>>(
      q, tot, ds_end, ds0, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_chunk<<<chunks, NTB, CHUNK_SMEM, st>>>(
      r, k, v, lw, u, dy, sst, q, dr, dk, dv, dw, dup, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_du<<<H, MAXC, 0, st>>>(dup, du, g);
  return (int)cudaGetLastError();
}

// Blocks of (p) (which = 0) or (f) (which = 1) resident on one SM, or a
// negative cudaError_t.
int wkv6_bwd_residency(int which) {
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, CHUNK_SMEM);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        which ? (const void*)wkv6_bwd_chunk : (const void*)wkv6_bwd_pre,
        cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  }
  if (err == cudaSuccess) {
    err = which ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &n, wkv6_bwd_chunk, NTB, CHUNK_SMEM)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &n, wkv6_bwd_pre, NTB, PRE_SMEM);
  }
  return err == cudaSuccess ? n : -(int)err;
}

const char* wkv6_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
