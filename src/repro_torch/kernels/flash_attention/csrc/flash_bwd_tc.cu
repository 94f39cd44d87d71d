// Flash attention backward (K5's gradient) on Hopper's tensor cores
// (sm_90a), CUDA C++: every product on wgmma, its bf16 / f16 tiles brought
// into shared memory by TMA, p taken from the forward's log-sum-exp.
//
// Replaces no Pallas kernel: the JAX package trains through the XLA twin of
// its flash kernel (src/repro/nn/layers.py:104-176) and lets autodiff take
// the gradient; its Pallas kernel (kernels/flash_attention/kernel.py) has no
// VJP.  It takes what csrc/flash_bwd.cu takes at bf16 and f16 with (q/k, v)
// head dims (64, 64), (128, 128) and (192, 128) (ops.bwd_variant), and
// computes the same function: with s = q k^T (unscaled), scale_log2 =
// log2(e) / sqrt(D) and lse2 each row's log-sum-exp in the log2 domain as
// flash_tc.cu writes it (+inf for a row with no valid key),
//
//   p   = exp2(s * scale_log2 - lse2)       (0 on a masked key)
//   Di  = rowsum(dO * O)                    (O the forward's output)
//   dS  = p * (dO v^T - Di)
//   dQ  = dS k / sqrt(D)
//   dK  = dS^T q / sqrt(D)                  summed over the G query heads
//   dV  = p^T dO                            of each kv head (GQA)
//
// Bound on the H100: at qwen2-1.5b's training shape, (2, 4096, 12, 128)
// against (2, 4096, 2, 128) bf16 causal, the five products (s, dP, dQ, dK,
// dV) over the 8.39 M visible pairs a head are 2 * 24 * 8.39e6 * 5 * 128 =
// 258 GFLOP, 0.26 ms at the 989 TFLOP/s bf16 peak, against 117 MB of q, k,
// v, O, dO, dq, dk and dv (0.035 ms at 3.35 TB/s): bound by operations.
// This kernel runs seven products (s and dP once in each of launches A and
// B), 361 GFLOP, all on the tensor cores.
//
// Design: three launches, no atomics, so a run repeats bit for bit.
//
// A. `flash_bwd_tc_dq`: one CTA owns 128 query rows of one (b, h), the
//    heaviest causal tiles first.  Its prologue takes Di for its rows from
//    O and dO (each thread of a quad a quarter of a row, summed across the
//    quad) and writes Di to a (B, H, SP) f32 scratch.  Two warpgroups and
//    no producer (see Registers): thread 0 loads Q and dO once and streams
//    64-key tiles of K and V through a 3-stage ring (full and empty
//    mbarriers), refilling at the top of each turn the stage that both
//    warpgroups released a turn earlier.  Each warpgroup owns 64 rows and
//    runs three products a key tile: S = Q K^T and dP = dO V^T (SS,
//    K-major, one commit group), then p, dS = p (dP - Di) in registers, dS
//    rounded to the input type and packed into wgmma's A fragment as the
//    forward packs P, and dQ += dS K (RS, K read MN-major through the
//    transpose bit, as the forward reads V).  dQ is scaled by 1/sqrt(D) and
//    written in q's type.
// B. `flash_bwd_tc_dkdv`: one CTA owns 128 keys of one (b, query head h):
//    B*H*ceil(T/128) CTAs (768 at the training shape), the first key tiles
//    (the most query tiles under a causal mask) first.  As in launch A,
//    thread 0 loads K and V of kv head h / G once and streams 64-row tiles
//    of Q and dO, with their rows' lse2 and Di (bulk copies), through the
//    ring.  Each warpgroup owns 64 keys, wgmma's M dimension, so P and dS
//    come out transposed in registers: S^T = K Q^T and dP^T = V dO^T (SS), P^T
//    and dS^T = P^T (dP^T - Di) in registers, rounded and packed as A 16
//    query rows at a time, then dV_h += P^T dO and dK_h += dS^T Q (RS, dO
//    and Q read MN-major).  P and dS never pass through shared memory.
//    Each CTA writes its head's f32 partials of dK and dV to (B, T, H, D)
//    and (B, T, H, DV) scratch.
// C. `flash_bwd_tc_sum`: each kv head's G partials summed in head order,
//    dK scaled by 1/sqrt(D), both cast to the inputs' type.
//
// Masks as in the forward: tiles that cross the diagonal, the window's edge
// or a ragged tail are masked in registers (a masked score is -inf, so p is
// 0 exactly; lse2 = +inf gives p = 0 on a row with no valid key and on the
// rows past S); the window's first tile and the causal tiles that no row
// can see are skipped; TMA zero-fills rows past S and T, and the stores
// skip them.  q, k, v and dO are read through their strides (the (B, S, H,
// D) model layout), O and dO's Di rows by 16-byte loads.
//
// Sizes: launch A, Q 128 x DQK and dO 128 x DV plus 3 stages of K 64 x DQK
// and V 64 x DV; launch B, K 128 x DQK and V 128 x DV plus 3 stages of Q 64
// x DQK and dO 64 x DV (and 3 x 512 B of lse2 and Di); both 160 KB at
// (128, 128), 200 KB at (192, 128) and 80 KB at (64, 64), plus 1024 to
// align the swizzle atoms.
//
// Registers.  ptxas holds every thread of a kernel to its launch bound's
// share of the register file (168 at 384 threads) whatever setmaxnreg
// gives a warpgroup at run time; past it, it spills wgmma accumulators to
// local memory and serializes the wgmma.  Launch B's warpgroups hold dK and
// dV across the query loop (DQK / 2 + DV / 2 f32 a thread) beside the S^T
// and dP^T fragments (32 each): 192 at (128, 128), 224 at (192, 128); so
// both launches run two warpgroups, 256 threads of up to 255 registers,
// with thread 0 as the producer, and ptxas reports no spill.
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;           // query rows of a launch-A CTA
constexpr int BKB = 128;          // keys of a launch-B CTA
constexpr int TILE = 64;          // keys (A) or query rows (B) of a ring tile
constexpr int WG_ROWS = 64;       // rows of a consumer warpgroup
constexpr int NTHREADS = 256;     // two warpgroups; thread 0 issues loads
constexpr int STAGES = 3;         // the ring of K/V (A) or Q/dO (B) tiles
constexpr int CONSUMER_WARPS = 8;

// Two f32 of shared memory, read where they are used (an asm keeps the
// compiler from hoisting a tile's 16 pairs of lse2 and Di into registers).
__device__ __forceinline__ float2 lds2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(smem_u32(p)));
  return v;
}

// A base address the compiler must take as new each turn, so that the
// wgmma descriptors built from it are not hoisted out of the loop into
// registers that stay live across it.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

template <int DQK, int DV>
struct Cfg {
  static constexpr int NC_QK = DQK / CHUNK, NC_V = DV / CHUNK;
  // launch A: Q and dO once, then K and V tiles
  static constexpr int A_Q = BQ * DQK * 2, A_G = BQ * DV * 2;
  static constexpr int A_K = TILE * DQK * 2, A_V = TILE * DV * 2;
  static constexpr int A_STAGE = A_K + A_V;
  static constexpr int A_SMEM = A_Q + A_G + STAGES * A_STAGE + 1024;
  // launch B: K and V once, then Q and dO tiles
  static constexpr int B_K = BKB * DQK * 2, B_V = BKB * DV * 2;
  static constexpr int B_Q = TILE * DQK * 2, B_G = TILE * DV * 2;
  static constexpr int B_STAGE = B_Q + B_G;
  static constexpr int B_SMEM = B_K + B_V + STAGES * B_STAGE + 1024;
};

struct Shape {
  int H, K, S, Tn, SP, causal, window;   // SP: S rounded up to BQ
  float scale_log2, scale;              // log2(e) / sqrt(D), 1 / sqrt(D)
};

// Strides in elements of O and dO (the last dim contiguous).
struct RowStrides {
  long long ob, os, oh, gb, gs, gh;
};

__device__ __forceinline__ bool visible(int qp, int kp, const Shape& sh) {
  return qp < sh.S && kp < sh.Tn && (!sh.causal || kp <= qp) &&
         (sh.window <= 0 || qp - kp < sh.window);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t w) {
  return __half22float2(*reinterpret_cast<__half2*>(&w));
}

// sum over n elements (a multiple of 8) of a[i] * b[i], in order, from
// 16-byte loads
template <typename T>
__device__ __forceinline__ float dot_row(const T* a, const T* b, int n) {
  float acc = 0.f;
  for (int e = 0; e < n; e += 8) {
    const uint4 wa = *reinterpret_cast<const uint4*>(a + e);
    const uint4 wb = *reinterpret_cast<const uint4*>(b + e);
    const uint32_t va[4] = {wa.x, wa.y, wa.z, wa.w};
    const uint32_t vb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 x = unpack2<T>(va[w]), y = unpack2<T>(vb[w]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// launch A: Di and dQ
// ---------------------------------------------------------------------------

// Launch A's ring: K and V of key tile `it` into its stage, completing on
// the stage's full barrier.
template <int DQK, int DV>
__device__ __forceinline__ void load_kv_tile(const CUtensorMap* tk,
                                             const CUtensorMap* tv,
                                             uint32_t kv_s, uint32_t full,
                                             int it, int k_first, int kh,
                                             int b) {
  using C = Cfg<DQK, DV>;
  const int s = it % STAGES, k0 = k_first + it * TILE;
  const uint32_t kd = kv_s + s * C::A_STAGE, vd = kd + C::A_K;
  const uint32_t bar = full + 8 * s;
  mbar_expect_tx(bar, C::A_STAGE);
#pragma unroll
  for (int c = 0; c < C::NC_QK; ++c)
    tma_load_4d(kd + c * TILE * ROW_BYTES, tk, bar, c * CHUNK, kh, k0, b);
#pragma unroll
  for (int c = 0; c < C::NC_V; ++c)
    tma_load_4d(vd + c * TILE * ROW_BYTES, tv, bar, c * CHUNK, kh, k0, b);
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_tc_dq(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tg,
                const T* __restrict__ o, const T* __restrict__ g,
                const float* __restrict__ lse, float* __restrict__ di_out,
                T* __restrict__ dq, RowStrides rs, Shape sh) {
  using C = Cfg<DQK, DV>;
  constexpr int NC_QK = C::NC_QK, NC_V = C::NC_V;
  constexpr bool F16 = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  // barriers: Q and dO full; per stage full, empty
  __shared__ uint64_t bars[1 + 2 * STAGES];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                  // NC_QK x [BQ][64]
  const uint32_t g_s = q_s + C::A_Q;          // NC_V x [BQ][64]
  const uint32_t kv_s = g_s + C::A_G;         // stage: K, then V, [TILE][64]
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t full = q_full + 8, empty = full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int H = sh.H, S = sh.S, Tn = sh.Tn;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / sh.K);
  // the key tiles that some row of this CTA can see
  int k_first = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  k_first -= k_first % TILE;
  const int k_last = sh.causal ? min(Tn, q0 + BQ) : Tn;
  const int n_tiles =
      k_last > k_first ? (k_last - k_first + TILE - 1) / TILE : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid == 0) {
    mbar_expect_tx(q_full, C::A_Q + C::A_G);
#pragma unroll
    for (int c = 0; c < NC_QK; ++c)
      tma_load_4d(q_s + c * BQ * ROW_BYTES, &tq, q_full, c * CHUNK, h, q0, b);
#pragma unroll
    for (int c = 0; c < NC_V; ++c)
      tma_load_4d(g_s + c * BQ * ROW_BYTES, &tg, q_full, c * CHUNK, h, q0, b);
    for (int it = 0; it < min(STAGES, n_tiles); ++it)
      load_kv_tile<DQK, DV>(&tk, &tv, kv_s, full, it, k_first, kh, b);
  }

  // -- two consumer warpgroups, 64 query rows each ----------------------------
  const int cw = tid / 128, ct = tid - 128 * cw;
  const int warp = ct / 32, lane = ct % 32;
  const int r_lo = q0 + cw * WG_ROWS;
  const int ra = r_lo + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t q_wg = q_s + cw * WG_ROWS * ROW_BYTES;
  const uint32_t g_wg = g_s + cw * WG_ROWS * ROW_BYTES;
  const long long stat = (static_cast<long long>(b) * H + h) * sh.SP;

  // Di and lse2 of the thread's rows ra and ra + 8; each thread of the
  // quad sums a quarter of each row, the quad sums the quarters
  float di[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = ra + 8 * i;
    float acc = 0.f;
    if (qp < S) {
      const int d0 = (lane % 4) * (DV / 4);
      acc = dot_row<T>(g + b * rs.gb + qp * rs.gs + h * rs.gh + d0,
                       o + b * rs.ob + qp * rs.os + h * rs.oh + d0, DV / 4);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    di[i] = acc;
    if (lane % 4 == 0) di_out[stat + qp] = acc;
    lse2[i] = lse[stat + qp];
  }

  float acc[NC_QK][32];
#pragma unroll
  for (int c = 0; c < NC_QK; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  uint32_t fa[TILE / 16][4];

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = k_first + it * TILE;
    const uint32_t kd = kv_s + s * C::A_STAGE, vd = kd + C::A_K;
    // thread 0 refills the stage of tile it - 1 with tile it + STAGES - 1
    // once both warpgroups have released it
    if (tid == 0 && it > 0 && it + STAGES - 1 < n_tiles) {
      mbar_wait(empty + 8 * ((it - 1) % STAGES), ((it - 1) / STAGES) & 1);
      load_kv_tile<DQK, DV>(&tk, &tv, kv_s, full, it + STAGES - 1, k_first,
                            kh, b);
    }
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    const uint32_t qa = opaque(q_wg), ga = opaque(g_wg);
    // S = Q K^T and dP = dO V^T, fragments that live within the turn
    float sc[TILE / 2], dp[TILE / 2];
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) sc[i] = dp[i] = 0.f;
    reg_fence(sc);
    reg_fence(dp);
    wgmma_fence();
    qk_tile<F16, DQK, TILE>(sc, qa, kd);
    qk_tile<F16, DV, TILE>(dp, ga, vd);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);
    reg_fence(dp);
    // dS = p (dP - Di), p from lse2; masked where some key of the tile is
    // hidden from some row of the warpgroup
    const bool edge =
        k0 + TILE > Tn || (sh.causal && k0 + TILE - 1 > r_lo) ||
        (sh.window > 0 && r_lo + WG_ROWS - 1 - k0 >= sh.window);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = sc[4 * j + r];
        if (edge && !visible(ra + 8 * (r >> 1), k0 + 8 * j + cq + (r & 1),
                             sh))
          x = -INFINITY;
        const float p = ex2(fmaf(x, sh.scale_log2, -lse2[r >> 1]));
        sc[4 * j + r] = p * (dp[4 * j + r] - di[r >> 1]);
      }
    pack_p<T, TILE>(sc, fa);
    // dQ += dS K
#pragma unroll
    for (int c = 0; c < NC_QK; ++c) reg_fence(acc[c]);
    wgmma_fence();
    pv_tile<F16, NC_QK, TILE>(acc, fa, kd);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC_QK; ++c) reg_fence(acc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // dq (B, S, H, DQK) contiguous, rows >= S skipped
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = ra + 8 * i;
    if (qp >= S) continue;
    T* row = dq + ((static_cast<long long>(b) * S + qp) * H + h) * DQK;
#pragma unroll
    for (int c = 0; c < NC_QK; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(row + c * CHUNK + 8 * j + cq) =
            pack2<T>(acc[c][4 * j + 2 * i] * sh.scale,
                     acc[c][4 * j + 2 * i + 1] * sh.scale);
  }
}

// ---------------------------------------------------------------------------
// launch B: each query head's dK and dV partials
// ---------------------------------------------------------------------------

// Launch B's ring: Q and dO of query tile `it` into its stage, and its
// rows' lse2 and Di into the stage's stats (stats: STAGES x [lse2, Di] x
// TILE f32; lse and di at this (b, h)'s first row), completing on the
// stage's full barrier.
template <int DQK, int DV>
__device__ __forceinline__ void load_q_tile(
    const CUtensorMap* tq, const CUtensorMap* tg, uint32_t qg_s,
    uint32_t full, float* stats, const float* lse, const float* di, int it,
    int q_first, int h, int b) {
  using C = Cfg<DQK, DV>;
  const int s = it % STAGES, t0 = q_first + it * TILE;
  const uint32_t qd = qg_s + s * C::B_STAGE, gd = qd + C::B_Q;
  const uint32_t bar = full + 8 * s;
  mbar_expect_tx(bar, C::B_STAGE + 2 * TILE * 4);
#pragma unroll
  for (int c = 0; c < C::NC_QK; ++c)
    tma_load_4d(qd + c * TILE * ROW_BYTES, tq, bar, c * CHUNK, h, t0, b);
#pragma unroll
  for (int c = 0; c < C::NC_V; ++c)
    tma_load_4d(gd + c * TILE * ROW_BYTES, tg, bar, c * CHUNK, h, t0, b);
  bulk_load(smem_u32(stats + (2 * s) * TILE), lse + t0, TILE * 4, bar);
  bulk_load(smem_u32(stats + (2 * s + 1) * TILE), di + t0, TILE * 4, bar);
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_tc_dkdv(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tg,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  float* __restrict__ dk_part, float* __restrict__ dv_part,
                  Shape sh) {
  using C = Cfg<DQK, DV>;
  constexpr int NC_QK = C::NC_QK, NC_V = C::NC_V;
  constexpr bool F16 = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  // barriers: K and V full; per stage full, empty
  __shared__ uint64_t bars[1 + 2 * STAGES];
  // per stage: the tile's rows' lse2, then their Di
  __shared__ __align__(16) float stats[STAGES][2][TILE];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base;                  // NC_QK x [BKB][64]
  const uint32_t v_s = k_s + C::B_K;          // NC_V x [BKB][64]
  const uint32_t qg_s = v_s + C::B_V;         // stage: Q, then dO, [TILE][64]
  const uint32_t kv_full = smem_u32(&bars[0]);
  const uint32_t full = kv_full + 8, empty = full + 8 * STAGES;

  const int tid = threadIdx.x, cw = tid / 128;
  const int H = sh.H, S = sh.S, Tn = sh.Tn;
  const int k0 = blockIdx.y * BKB;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / sh.K);
  // the query tiles that can see a key of this CTA
  const int q_first = sh.causal ? min(k0, S) : 0;
  const int q_last =
      sh.window > 0 ? min(S, k0 + BKB - 1 + sh.window) : S;
  const int n_tiles =
      q_last > q_first ? (q_last - q_first + TILE - 1) / TILE : 0;
  const long long stat = (static_cast<long long>(b) * H + h) * sh.SP;

  if (tid == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(kv_full, C::B_K + C::B_V);
#pragma unroll
    for (int c = 0; c < NC_QK; ++c)
      tma_load_4d(k_s + c * BKB * ROW_BYTES, &tk, kv_full, c * CHUNK, kh, k0,
                  b);
#pragma unroll
    for (int c = 0; c < NC_V; ++c)
      tma_load_4d(v_s + c * BKB * ROW_BYTES, &tv, kv_full, c * CHUNK, kh, k0,
                  b);
    for (int it = 0; it < min(STAGES, n_tiles); ++it)
      load_q_tile<DQK, DV>(&tq, &tg, qg_s, full, &stats[0][0][0], lse + stat,
                           di + stat, it, q_first, h, b);
  }

  // -- two consumer warpgroups, 64 keys each --------------------------------
  const int ct = tid - 128 * cw;
  const int warp = ct / 32, lane = ct % 32;
  const int k_lo = k0 + cw * WG_ROWS;
  const int ka = k_lo + warp * 16 + lane / 4;     // keys ka and ka + 8
  const int cq = 2 * (lane % 4);
  const uint32_t k_wg = k_s + cw * WG_ROWS * ROW_BYTES;
  const uint32_t v_wg = v_s + cw * WG_ROWS * ROW_BYTES;

  float dk[NC_QK][32], dv[NC_V][32];
#pragma unroll
  for (int c = 0; c < NC_QK; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = 0.f;
#pragma unroll
  for (int c = 0; c < NC_V; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[c][i] = 0.f;
  uint32_t fp[TILE / 16][4], fd[TILE / 16][4];

  if (n_tiles > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int t0 = q_first + it * TILE;
    const uint32_t qd = qg_s + s * C::B_STAGE, gd = qd + C::B_Q;
    // thread 0 refills the stage of tile it - 1 with tile it + STAGES - 1
    // once both warpgroups have released it
    if (tid == 0 && it > 0 && it + STAGES - 1 < n_tiles) {
      mbar_wait(empty + 8 * ((it - 1) % STAGES), ((it - 1) / STAGES) & 1);
      load_q_tile<DQK, DV>(&tq, &tg, qg_s, full, &stats[0][0][0], lse + stat,
                           di + stat, it + STAGES - 1, q_first, h, b);
    }
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns query rows
    float st[TILE / 2], dpt[TILE / 2];
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) st[i] = dpt[i] = 0.f;
    reg_fence(st);
    reg_fence(dpt);
    wgmma_fence();
    qk_tile<F16, DQK, TILE>(st, opaque(k_wg), qd);
    qk_tile<F16, DV, TILE>(dpt, opaque(v_wg), gd);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(st);
    reg_fence(dpt);
    // P^T and dS^T = P^T (dP^T - Di), masked where some pair of the tile
    // is hidden, rounded and packed one k-step (16 query rows) at a time
    const bool edge = t0 + TILE > S || k_lo + WG_ROWS > Tn ||
                      (sh.causal && k_lo + WG_ROWS - 1 > t0) ||
                      (sh.window > 0 && t0 + TILE - 1 - k_lo >= sh.window);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 l2 = lds2(&stats[s][0][8 * j + cq]);
      const float2 d2 = lds2(&stats[s][1][8 * j + cq]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = st[4 * j + r];
        if (edge && !visible(t0 + 8 * j + cq + (r & 1), ka + 8 * (r >> 1),
                             sh))
          x = -INFINITY;
        const float p = ex2(fmaf(x, sh.scale_log2, -(r & 1 ? l2.y : l2.x)));
        st[4 * j + r] = p;
        dpt[4 * j + r] = p * (dpt[4 * j + r] - (r & 1 ? d2.y : d2.x));
      }
      if (j & 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * (j - 1) + 2 * i;
          fp[j / 2][i] = pack2<T>(st[e], st[e + 1]);
          fd[j / 2][i] = pack2<T>(dpt[e], dpt[e + 1]);
        }
      }
    }
    // dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int c = 0; c < NC_V; ++c) reg_fence(dv[c]);
#pragma unroll
    for (int c = 0; c < NC_QK; ++c) reg_fence(dk[c]);
    wgmma_fence();
    pv_tile<F16, NC_V, TILE>(dv, fp, gd);
    pv_tile<F16, NC_QK, TILE>(dk, fd, qd);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC_V; ++c) reg_fence(dv[c]);
#pragma unroll
    for (int c = 0; c < NC_QK; ++c) reg_fence(dk[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // this head's f32 partials, (B, T, H, DQK) and (B, T, H, DV); keys >= T
  // skipped
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = ka + 8 * i;
    if (kp >= Tn) continue;
    const long long row = (static_cast<long long>(b) * Tn + kp) * H + h;
    float* rk = dk_part + row * DQK;
    float* rv = dv_part + row * DV;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < NC_QK; ++c)
        *reinterpret_cast<float2*>(rk + c * CHUNK + 8 * j + cq) =
            make_float2(dk[c][4 * j + 2 * i], dk[c][4 * j + 2 * i + 1]);
#pragma unroll
      for (int c = 0; c < NC_V; ++c)
        *reinterpret_cast<float2*>(rv + c * CHUNK + 8 * j + cq) =
            make_float2(dv[c][4 * j + 2 * i], dv[c][4 * j + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch C: the group sum
// ---------------------------------------------------------------------------

// dk[r] = scale * sum_g dk_part[r * G + g] and dv[r] = sum_g dv_part[r * G +
// g] over the rows r of (B, T, K), g in head order, four elements a thread.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_tc_sum(const float* __restrict__ dk_part,
                 const float* __restrict__ dv_part, T* __restrict__ dk,
                 T* __restrict__ dv, long long rows, int G, int DQK, int DV,
                 float scale) {
  const long long nk = rows * (DQK / 4), n = nk + rows * (DV / 4);
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n;
       i += 256ll * gridDim.x) {
    const bool is_k = i < nk;
    const long long e = is_k ? i : i - nk;
    const int D = is_k ? DQK : DV;
    const long long r = e / (D / 4), c = 4 * (e % (D / 4));
    const float* src = (is_k ? dk_part : dv_part) + r * G * D + c;
    float4 a = *reinterpret_cast<const float4*>(src);
    for (int j = 1; j < G; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(src + j * D);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float m = is_k ? scale : 1.f;
    uint2 w;
    w.x = pack2<T>(a.x * m, a.y * m);
    w.y = pack2<T>(a.z * m, a.w * m);
    *reinterpret_cast<uint2*>((is_k ? dk : dv) + r * D + c) = w;
  }
}

// -- host ---------------------------------------------------------------------

struct Strides {                 // in elements; the last dim is contiguous
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh;
};

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const float* lse, void* dq, void* dk, void* dv,
           float* di, float* dk_part, float* dv_part, int B, Strides st,
           Shape sh, cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int H = sh.H, K = sh.K, S = sh.S, Tn = sh.Tn;
  // launch A: Q and dO in 128-row boxes, K and V in 64; launch B the other
  // way round
  CUtensorMap aq, ag, ak, av, bk, bv, bq, bg;
  int rc = current_context();
  if (rc == 0) rc = make_map(&aq, type, q, DQK, H, S, B, st.qh, st.qs, st.qb,
                             BQ);
  if (rc == 0) rc = make_map(&ag, type, g, DV, H, S, B, st.gh, st.gs, st.gb,
                             BQ);
  if (rc == 0) rc = make_map(&ak, type, k, DQK, K, Tn, B, st.kh, st.ks, st.kb,
                             TILE);
  if (rc == 0) rc = make_map(&av, type, v, DV, K, Tn, B, st.vh, st.vs, st.vb,
                             TILE);
  if (rc == 0) rc = make_map(&bk, type, k, DQK, K, Tn, B, st.kh, st.ks, st.kb,
                             BKB);
  if (rc == 0) rc = make_map(&bv, type, v, DV, K, Tn, B, st.vh, st.vs, st.vb,
                             BKB);
  if (rc == 0) rc = make_map(&bq, type, q, DQK, H, S, B, st.qh, st.qs, st.qb,
                             TILE);
  if (rc == 0) rc = make_map(&bg, type, g, DV, H, S, B, st.gh, st.gs, st.gb,
                             TILE);
  if (rc != 0) return rc;
  auto* ka = flash_bwd_tc_dq<T, DQK, DV>;
  auto* kb = flash_bwd_tc_dkdv<T, DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, C::A_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kb, cudaFuncAttributeMaxDynamicSharedMemorySize, C::B_SMEM);
  if (err != cudaSuccess) return (int)err;
  const RowStrides rs{st.ob, st.os, st.oh, st.gb, st.gs, st.gh};
  ka<<<dim3(B * H, sh.SP / BQ), NTHREADS, C::A_SMEM, stream>>>(
      aq, ak, av, ag, static_cast<const T*>(o), static_cast<const T*>(g), lse,
      di, static_cast<T*>(dq), rs, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kb<<<dim3(B * H, (Tn + BKB - 1) / BKB), NTHREADS, C::B_SMEM, stream>>>(
      bk, bv, bq, bg, lse, di, dk_part, dv_part, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = static_cast<long long>(B) * Tn * K;
  const long long n = rows * (DQK + DV) / 4;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  flash_bwd_tc_sum<T><<<blocks, 256, 0, stream>>>(
      dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), rows, H / K,
      DQK, DV, sh.scale);
  return (int)cudaGetLastError();
}

// The (DQK, DV) instances: equal head dims 64 and 128, and MLA's (192, 128).
template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* o,
               const void* g, const float* lse, void* dq, void* dk, void* dv,
               float* di, float* dkp, float* dvp, int B, int D, int DV,
               Strides st, Shape sh, cudaStream_t stream) {
  switch (D * 1000 + DV) {
    case 64064: return launch<T, 64, 64>(q, k, v, o, g, lse, dq, dk, dv, di, dkp, dvp, B, st, sh, stream);
    case 128128: return launch<T, 128, 128>(q, k, v, o, g, lse, dq, dk, dv, di, dkp, dvp, B, st, sh, stream);
    case 192128: return launch<T, 192, 128>(q, k, v, o, g, lse, dq, dk, dv, di, dkp, dvp, B, st, sh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 1 bf16, 2 f16.  D is the head dim of q and k, DV that of v.
// Strides in elements of q, k, v, o (the forward's output) and g (its
// gradient), each (B, rows, heads, dim) with the last dim contiguous, every
// other stride and each base address a multiple of 16 bytes (TMA, and the
// 16-byte loads of o and g).  lse: the forward's (B, H, SP) log-sum-exp
// (flash_tc_launch), SP = S rounded up to 128; di: a (B, H, SP) f32
// scratch; dk_part (B, T, H, D) and dv_part (B, T, H, DV) f32 scratch.  dq
// (B, S, H, D), dk (B, T, K, D), dv (B, T, K, DV) are written contiguous.
// scale_log2 = log2(e) / sqrt(D), scale = 1 / sqrt(D).  Returns 0, a
// cudaError_t, or a code that flash_bwd_tc_error explains.
int flash_bwd_tc_launch(const void* q, const void* k, const void* v,
                        const void* o, const void* g, const void* lse,
                        void* dq, void* dk, void* dv, void* di,
                        void* dk_part, void* dv_part, int dtype, int B, int H,
                        int K, int S, int Tn, int D, int DV, long long qb,
                        long long qs, long long qh, long long kb,
                        long long ks, long long kh, long long vb,
                        long long vs, long long vh, long long ob,
                        long long os, long long oh, long long gb,
                        long long gs, long long gh, int causal, int window,
                        float scale_log2, float scale, void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || S < 1 || Tn < 1 ||
      (S + BQ - 1) / BQ > 65535 || (Tn + BKB - 1) / BKB > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh};
  Shape sh{H, K, S, Tn, (S + BQ - 1) / BQ * BQ, causal, window, scale_log2,
           scale};
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(di);
  float* pk = static_cast<float*>(dk_part);
  float* pv = static_cast<float*>(dv_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, g, l, dq, dk, dv, d, pk, pv, B, D, DV, st, sh, s);
    case 2: return dispatch_d<__half>(q, k, v, o, g, l, dq, dk, dv, d, pk, pv, B, D, DV, st, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_bwd_tc_error(int code) { return launch_error(code); }

}  // extern "C"
