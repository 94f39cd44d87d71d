// Flash attention forward (K5) on Hopper's tensor cores (sm_90a), CUDA C++:
// wgmma on bf16 / f16 tiles that TMA brings into shared memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_bhsd` :80, body `_flash_kernel` :27, `pallas_call`
// :107), as the CUDA-core kernel csrc/flash.cu does, and computes what
// `flash_attention_ref` computes: online-softmax attention with a causal and
// a sliding-window mask (q_pos - k_pos < window), GQA by index (query head h
// reads kv head h / (H / K); k and v are never repeated in memory), any S
// and T with the ragged tail masked here, a row with no valid key giving 0,
// inputs read in the model layout (B, S, H, D) through their strides and
// the output written (B, S, H, DV) contiguous in q's type.  It takes bf16
// and f16 at (DQK, DV), the head dims of q/k and of v, in {(64, 64),
// (128, 128), (256, 256)} and MLA's (192, 128) (deepseek-v2: 128 no-RoPE +
// 64 RoPE dims of q and k, 128 of v); f32 stays on flash.cu (no TF32
// enters).
//
// Bound on the H100.  At the qwen2-1.5b prefill shape, q (4, 2048, 12, 128)
// against k, v (4, 2048, 2, 128) bf16, causal: 2*B*H*S*T*D = 51.5 GFLOP of
// QK^T and PV (half of each square), 0.0521 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 58.7 MB of q, k, v and o (0.0175 ms at 3.35
// TB/s): bound by operations, so the products must run on the tensor cores
// and the loads and the softmax must hide behind them.  At deepseek-v2's
// MLA prefill, q and k (4, 2048, 128, 192) and v (4, 2048, 128, 128):
// B*H*S*T*(DQK + DV) = 687.2 GFLOP, 0.695 ms, against 1.34 GB of q, k, v
// and o (0.40 ms): bound by operations as well.
//
// Design.
// - One CTA per (128-row query tile, b*h), heads fastest in blockIdx.x and
//   the query tiles reversed in blockIdx.y, so the heaviest causal tiles of
//   every head start first and the tail of the grid is short.
// - Three warpgroups.  Warpgroup 0 is the producer: after `setmaxnreg` drops
//   it to 40 registers, one thread starts the TMA loads, Q once and then K
//   and V tiles into a ring of 2 stages, each guarded by a full and an empty
//   mbarrier.  Warpgroups 1 and 2 are consumers (232 registers each), one per
//   64 query rows; both read the same K/V stage and release it, one arrival
//   per warp, once their wgmma on it has completed.
// - At D <= 128 the consumers take turns on the tensor cores (two named
//   barriers): a turn starts tile it - 1's PV and then tile it's QK^T, and
//   each warpgroup's masks and softmax run while the other holds its turn.
//   The first turn (tile 0's QK^T) and the last (the last tile's PV) are
//   peeled off the loop, so no wgmma sits on a divergent path, which would
//   make ptxas serialize them.  At D = 256 (a 128-register O accumulator)
//   the turns cost more in spills than they win and are compiled out.
//   The accumulators are sized by DV and the QK^T's k-steps by DQK, so
//   (192, 128) keeps D = 128's registers (S and O 64 f32 a thread each),
//   its BK and its turns, with 12 k16 steps in QK^T instead of 8.
// - QK^T: wgmma m64nBKk16, Q and K both from shared memory, K-major, f32
//   accumulate.  bf16 x bf16 (and f16 x f16) products are exact in f32, so S
//   differs from the plain version only in the order of the sums.
// - Masks in registers, only on the tiles that cross the diagonal, the
//   window's edge or the ragged tail; tiles that no row of the CTA can see
//   are never loaded.  A masked key is -inf, so its p is 0 exactly, and a
//   row that has seen no valid key keeps m = -inf, l = 0 and O = 0.
// - Softmax: running max and sum in f32; the scale and log2(e) fold into one
//   fmaf before a single-instruction ex2.approx.
// - PV: P is rounded to the input type in registers and fed as wgmma's A
//   operand from registers (the f32 accumulator fragment of m64nBK maps
//   onto the 16-bit A fragment once pairs are packed); V is read from shared
//   memory as an MN-major B operand through the transpose bit, so it is
//   never transposed in memory.  One m64n64k16 per 64-wide chunk of DV.  The
//   f32 O accumulator stays in registers and is rescaled by alpha.  The
//   rounding of P is the only error beyond the order of sums and ex2's
//   2^-22: |out - ref| <= u * sum(p |v|) / l <= u * max|v|, u = 2^-8
//   (bf16) or 2^-11 (f16), the tolerance that ops.py states.
// - Sizes: BK = 128 keys at DV <= 128, BK = 64 at DV = 256 (there the 64 x
//   256 f32 O accumulator is 128 registers a thread).  Shared memory, in
//   bytes: Q 128*DQK*2 plus 2 stages of K, 2*BK*DQK*2, and of V, 2*BK*DV*2,
//   plus 1024 to align the swizzle atoms: (64, 64): 16384 + 65536 + 1024 =
//   82944; (128, 128): 32768 + 131072 + 1024 = 164864; (256, 256): 65536 +
//   131072 + 1024 = 197632; (192, 128): 49152 + 98304 + 65536 + 1024 =
//   214016; all within the 232448 a block may use.  (A third stage fits at
//   D <= 128 but measured no faster.)
// - Layout (sm90.cuh, which holds the PTX wrappers this kernel shares with
//   flash_bwd_tc.cu): every tile is kept as 64-element (128-byte) column
//   chunks of [rows][64] in the 128-byte swizzle; a D = 128 row is two TMA
//   boxes, a DQK = 192 row three.  The tensor maps are 4-D, (DQK, H, S, B)
//   for q, (DQK, K, T, B) for k and (DV, K, T, B) for v, built on the host
//   from the wrapper's strides; TMA zero-fills rows past S and T, and the
//   store skips rows >= S.
// - The log-sum-exp, only when asked (a non-null lse, under autograd): each
//   row's lse2 = m * scale_log2 + log2(l), in the kernel's own log2 domain,
//   +inf for a row with no valid key and for the rows of the last tile past
//   S, into a (B, H, SP) f32 buffer, SP = S rounded up to BQ.  The
//   backward (flash_bwd_tc.cu) takes p = exp2(s * scale_log2 - lse2) from
//   it.  With a null lse the output's bits are the same.
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;           // query rows of a CTA
constexpr int WG_ROWS = 64;       // query rows of a consumer warpgroup
constexpr int NTHREADS = 384;     // producer + two consumer warpgroups
constexpr int STAGES = 2;         // K/V ring
constexpr int CONSUMER_WARPS = 8;

template <int DQK, int DV>
struct Cfg {
  static constexpr int BK = DV <= 128 ? 128 : 64;
  static constexpr int NC_QK = DQK / CHUNK;           // chunks of a q/k row
  static constexpr int NC_V = DV / CHUNK;             // chunks of a v/o row
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int K_BYTES = BK * DQK * 2;        // one K stage
  static constexpr int V_BYTES = BK * DV * 2;         // one V stage
  static constexpr int SMEM = Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 1024;
};

// -- the consumers' turns and softmax -----------------------------------------

// Named barriers between the two consumer warpgroups (id 0 is
// __syncthreads): a turn starts with bar_sync on one's own barrier and
// ends with bar_arrive on the other's.
template <bool ON>
__device__ __forceinline__ void bar_sync(int id) {
  if constexpr (ON) asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
template <bool ON>
__device__ __forceinline__ void bar_arrive(int id) {
  if constexpr (ON) asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// Whether key tile [k0, k0 + BK) holds a key hidden from some row of the
// warpgroup's 64 rows from r_lo: past T, above the diagonal, or beyond the
// window.  Only such tiles are masked.
__device__ __forceinline__ bool is_edge(int k0, int BK, int r_lo, int Tn,
                                        int causal, int window) {
  return k0 + BK > Tn || (causal && k0 + BK - 1 > r_lo) ||
         (window > 0 && r_lo + WG_ROWS - 1 - k0 >= window);
}

// The online-softmax step of one key tile, in registers.  Masks the scores
// where some key of the tile is hidden from some row of the warpgroup (a
// masked key is -inf, so its p is 0 exactly); sc becomes p in f32, the
// running max and sum advance, and alpha is what rescales the earlier O.
// The thread's rows are ra and ra + 8; its columns of every 8-wide group
// are cq and cq + 1 (the wgmma accumulator fragment).
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], float (&m_run)[2], float (&l_run)[2],
    float (&alpha)[2], bool edge, int k0, int ra, int cq, int Tn, int causal,
    int window, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kp = k0 + 8 * j + cq + (r & 1);
        const int qp = ra + 8 * (r >> 1);
        const bool ok = kp < Tn && (!causal || kp <= qp) &&
                        (window <= 0 || qp - kp < window);
        if (!ok) sc[4 * j + r] = -INFINITY;
      }
  }
  // the row's max over the quad of threads that holds it
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // a row with no valid key yet keeps m = -inf: its p and alpha are 0
    mc[i] = (mx[i] == -INFINITY ? 0.f : mx[i]) * scale_log2;
    alpha[i] = ex2(m_run[i] * scale_log2 - mc[i]);
    m_run[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p = ex2(fmaf(sc[4 * j + r], scale_log2, -mc[r >> 1]));
      sc[4 * j + r] = p;
      rs[r >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
}

// -- the kernel ---------------------------------------------------------------

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_tc_fwd(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
             float* __restrict__ lse, int H, int K, int S, int Tn, int causal,
             int window, float scale_log2) {
  using C = Cfg<DQK, DV>;
  constexpr int BK = C::BK, NC_QK = C::NC_QK, NC_V = C::NC_V;
  constexpr bool F16 = std::is_same<T, __half>::value;
  constexpr bool TURNS = DV <= 128;
  extern __shared__ uint8_t smem_raw[];
  // barriers: q full; per stage k full, k empty, v full, v empty
  __shared__ uint64_t bars[1 + 4 * STAGES];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                       // NC_QK x [BQ][64]
  const uint32_t k_s = base + C::Q_BYTES;          // stage s: NC_QK x [BK][64]
  const uint32_t v_s = k_s + STAGES * C::K_BYTES;  // stage s: NC_V x [BK][64]
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t k_full = q_full + 8, k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES, v_empty = v_full + 8 * STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  // the key tiles that some row of this CTA can see
  int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  k_first -= k_first % BK;
  const int k_last = causal ? min(Tn, q0 + BQ) : Tn;
  const int n_tiles = k_last > k_first ? (k_last - k_first + BK - 1) / BK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer: one thread keeps the TMA loads in flight ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NC_QK; ++c)
        tma_load_4d(q_s + c * BQ * ROW_BYTES, &tq, q_full, c * CHUNK, h, q0,
                    b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = k_first + it * BK;
        const uint32_t kd = k_s + s * C::K_BYTES, vd = v_s + s * C::V_BYTES;
        mbar_wait(k_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(k_full + 8 * s, C::K_BYTES);
#pragma unroll
        for (int c = 0; c < NC_QK; ++c)
          tma_load_4d(kd + c * BK * ROW_BYTES, &tk, k_full + 8 * s,
                      c * CHUNK, kh, k0, b);
        mbar_wait(v_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(v_full + 8 * s, C::V_BYTES);
#pragma unroll
        for (int c = 0; c < NC_V; ++c)
          tma_load_4d(vd + c * BK * ROW_BYTES, &tv, v_full + 8 * s,
                      c * CHUNK, kh, k0, b);
      }
    }
  } else {
    // -- consumers: 64 query rows each --------------------------------------
    // At DV <= 128 the two warpgroups take turns on the tensor cores (named
    // barriers 1 and 2, warpgroup 0 first): a turn starts tile it - 1's PV
    // and tile it's QK^T, and each warpgroup's softmax runs while the other
    // holds its turn.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, ct = tid - 128 * wg;
    const int warp = ct / 32, lane = ct % 32;
    const int r_lo = q0 + cw * WG_ROWS;
    const int ra = r_lo + warp * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const uint32_t q_wg = q_s + cw * WG_ROWS * ROW_BYTES;

    float acc[NC_V][32];
#pragma unroll
    for (int c = 0; c < NC_V; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    float sc[BK / 2], alpha[2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      if (cw == 1) bar_arrive<TURNS>(1);
      // tile 0: its QK^T alone in the first turn
      mbar_wait(k_full, 0);
      bar_sync<TURNS>(1 + cw);
      reg_fence(sc);
      wgmma_fence();
      qk_tile<F16, DQK, BK>(sc, q_wg, k_s);
      wgmma_commit();
      bar_arrive<TURNS>(2 - cw);
      wgmma_wait_all();
      reg_fence(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty);
      softmax_tile<BK>(sc, m_run, l_run, alpha,
                       is_edge(k_first, BK, r_lo, Tn, causal, window),
                       k_first, ra, cq, Tn, causal, window, scale_log2);
      pack_p<T, BK>(sc, pa);

      for (int it = 1; it < n_tiles; ++it) {
        const int s = it % STAGES, sp = (it - 1) % STAGES;
        const int k0 = k_first + it * BK;
        mbar_wait(k_full + 8 * s, (it / STAGES) & 1);
        mbar_wait(v_full + 8 * sp, ((it - 1) / STAGES) & 1);
        bar_sync<TURNS>(1 + cw);
#pragma unroll
        for (int c = 0; c < NC_V; ++c) reg_fence(acc[c]);
        wgmma_fence();
        pv_tile<F16, NC_V, BK>(acc, pa, v_s + sp * C::V_BYTES);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NC_V; ++c) reg_fence(acc[c]);
        reg_fence(sc);
        wgmma_fence();
        qk_tile<F16, DQK, BK>(sc, q_wg, k_s + s * C::K_BYTES);
        wgmma_commit();
        bar_arrive<TURNS>(2 - cw);
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty + 8 * sp);
        wgmma_wait_all();
        reg_fence(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty + 8 * s);
        softmax_tile<BK>(sc, m_run, l_run, alpha,
                         is_edge(k0, BK, r_lo, Tn, causal, window), k0, ra,
                         cq, Tn, causal, window, scale_log2);
#pragma unroll
        for (int c = 0; c < NC_V; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
        pack_p<T, BK>(sc, pa);
      }

      // the last tile's PV in the last turn
      const int s = (n_tiles - 1) % STAGES;
      mbar_wait(v_full + 8 * s, ((n_tiles - 1) / STAGES) & 1);
      bar_sync<TURNS>(1 + cw);
#pragma unroll
      for (int c = 0; c < NC_V; ++c) reg_fence(acc[c]);
      wgmma_fence();
      pv_tile<F16, NC_V, BK>(acc, pa, v_s + s * C::V_BYTES);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NC_V; ++c) reg_fence(acc[c]);
      if (cw == 0) bar_arrive<TURNS>(2);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + 8 * s);
    }

    // out = O / l, rows >= S skipped; a row with no valid key gives 0.
    // lse2 (if asked) for every row of the tile, +inf where l = 0 or past S
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qp = ra + 8 * i;
      if (lse != nullptr && lane % 4 == 0)
        lse[(static_cast<long long>(b) * H + h) * (gridDim.y * BQ) + qp] =
            qp >= S || l == 0.f ? INFINITY
                                : m_run[i] * scale_log2 + log2f(l);
      if (qp >= S) continue;
      T* orow = o + ((static_cast<long long>(b) * S + qp) * H + h) * DV;
#pragma unroll
      for (int c = 0; c < NC_V; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float a0 = l == 0.f ? 0.f : acc[c][4 * j + 2 * i] / l;
          const float a1 = l == 0.f ? 0.f : acc[c][4 * j + 2 * i + 1] / l;
          *reinterpret_cast<uint32_t*>(orow + c * CHUNK + 8 * j + cq) =
              pack2<T>(a0, a1);
        }
    }
  }
}

// -- host ---------------------------------------------------------------------

struct Strides {                 // in elements; the last dim is contiguous
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int K, int S, int Tn, Strides st, int causal,
           int window, float scale_log2, cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  int rc = current_context();
  if (rc == 0) rc = make_map(&tq, type, q, DQK, H, S, B, st.qh, st.qs, st.qb,
                             BQ);
  if (rc == 0) rc = make_map(&tk, type, k, DQK, K, Tn, B, st.kh, st.ks,
                             st.kb, C::BK);
  if (rc == 0) rc = make_map(&tv, type, v, DV, K, Tn, B, st.vh, st.vs, st.vb,
                             C::BK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_fwd<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_tc_fwd<T, DQK, DV><<<grid, NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(o), lse, H, K, S, Tn, causal, window,
      scale_log2);
  return (int)cudaGetLastError();
}

// The (DQK, DV) instances: equal head dims 64, 128, 256, and MLA's
// (192, 128).
template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int K, int S, int Tn, int D, int DV,
               Strides st, int causal, int window, float scale_log2,
               cudaStream_t stream) {
  switch (D * 1000 + DV) {
    case 64064: return launch<T, 64, 64>(q, k, v, o, lse, B, H, K, S, Tn, st, causal, window, scale_log2, stream);
    case 128128: return launch<T, 128, 128>(q, k, v, o, lse, B, H, K, S, Tn, st, causal, window, scale_log2, stream);
    case 256256: return launch<T, 256, 256>(q, k, v, o, lse, B, H, K, S, Tn, st, causal, window, scale_log2, stream);
    case 192128: return launch<T, 192, 128>(q, k, v, o, lse, B, H, K, S, Tn, st, causal, window, scale_log2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 1 bf16, 2 f16.  D is the head dim of q and k, DV that of v.
// Strides in elements, q/k/v last dim contiguous, every other stride and
// each base address a multiple of 16 bytes (TMA); o is (B, S, H, DV)
// contiguous.  scale_log2 = log2(e) / sqrt(D).  lse: null, or a (B, H, SP)
// f32 buffer, SP = S rounded up to 128, that receives each row's
// log-sum-exp in the log2 domain (+inf past S and where no key is valid).
// Returns 0, a cudaError_t, or a code that flash_tc_error explains.
int flash_tc_launch(const void* q, const void* k, const void* v, void* o,
                    void* lse, int dtype, int B, int H, int K, int S, int Tn,
                    int D, int DV, long long qb, long long qs, long long qh,
                    long long kb, long long ks, long long kh, long long vb,
                    long long vs, long long vh, int causal, int window,
                    float scale_log2, void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || S < 1 || Tn < 1 ||
      (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, l, B, H, K, S, Tn, D, DV, st, causal, window, scale_log2, s);
    case 2: return dispatch_d<__half>(q, k, v, o, l, B, H, K, S, Tn, D, DV, st, causal, window, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_tc_error(int code) { return launch_error(code); }

}  // extern "C"
