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
// - Layout: every tile is kept as 64-element (128-byte) column chunks of
//   [rows][64], written by TMA with the 128-byte swizzle that the wgmma
//   descriptors name; a D = 128 row is two TMA boxes, a DQK = 192 row
//   three.  The tensor maps are 4-D, (DQK, H, S, B) for q, (DQK, K, T, B)
//   for k and (DV, K, T, B) for v, built on the host
//   from the wrapper's strides with cuTensorMapEncodeTiled, looked up at run
//   time through the CUDA runtime (no -lcuda); TMA zero-fills rows past S
//   and T, and the store skips rows >= S.
// - A barrier wait that has not completed after about 10 s of clock traps,
//   so a fault in the pipeline ends the launch with an error instead of
//   hanging the card.
#include <cuda.h>                 // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

namespace {

constexpr int BQ = 128;           // query rows of a CTA
constexpr int WG_ROWS = 64;       // query rows of a consumer warpgroup
constexpr int NTHREADS = 384;     // producer + two consumer warpgroups
constexpr int STAGES = 2;         // K/V ring
constexpr int CHUNK = 64;         // elements of a 128-byte swizzled row
constexpr int ROW_BYTES = 128;
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

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// One TMA box of a 4-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of a wgmma operand across
// the asynchronous instructions that use it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

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

// 2^x in one MUFU op (relative error about 2^-22; results below 2^-126 are
// 0, as they are for every masked key)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- wgmma ------------------------------------------------------------------

// d (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), A and B in shared
// memory, both K-major.
#define MMA_SS_N64(TY)                                             \
  asm volatile(                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                   \
      "%24, %25, %26, %27, %28, %29, %30, %31"                     \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                           \
      :                                                            \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),            \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])         \
      : "l"(da), "l"(db), "r"(accumulate))
template <bool F16>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (F16) MMA_SS_N64("f16"); else MMA_SS_N64("bf16");
}
#undef MMA_SS_N64

// d (64 x 128, f32) (+)= A (64 x 16) . B (16 x 128), A and B in shared
// memory, both K-major.
#define MMA_SS_N128(TY)                                             \
  asm volatile(                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                            \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                    \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                    \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                    \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                    \
      "%56, %57, %58, %59, %60, %61, %62, %63"                      \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                            \
      :                                                             \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])          \
      : "l"(da), "l"(db), "r"(accumulate))
template <bool F16>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (F16) MMA_SS_N128("f16"); else MMA_SS_N128("bf16");
}
#undef MMA_SS_N128

// d (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), A in registers (the
// 16-bit fragment), B in shared memory MN-major (the transpose bit, which
// 16-bit wgmma allows).
#define MMA_RS_N64(TY)                                             \
  asm volatile(                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                   \
      "%24, %25, %26, %27, %28, %29, %30, %31"                     \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"             \
      :                                                            \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),            \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),       \
        "r"(accumulate))
template <bool F16>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  if constexpr (F16) MMA_RS_N64("f16"); else MMA_RS_N64("bf16");
}
#undef MMA_RS_N64

template <bool F16, int N>
__device__ __forceinline__ void mma_qk(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (N == 128) mma_ss_n128<F16>(d, da, db, accumulate);
  else mma_ss_n64<F16>(d, da, db, accumulate);
}

// Whether key tile [k0, k0 + BK) holds a key hidden from some row of the
// warpgroup's 64 rows from r_lo: past T, above the diagonal, or beyond the
// window.  Only such tiles are masked.
__device__ __forceinline__ bool is_edge(int k0, int BK, int r_lo, int Tn,
                                        int causal, int window) {
  return k0 + BK > Tn || (causal && k0 + BK - 1 > r_lo) ||
         (window > 0 && r_lo + WG_ROWS - 1 - k0 >= window);
}

// S = Q K^T of one key tile: DQK / 16 k-steps, 16 elements (32 bytes) each
// along the 64-element chunks of Q and K.
template <bool F16, int DQK, int BK>
__device__ __forceinline__ void qk_tile(float (&sc)[BK / 2], uint32_t q_wg,
                                         uint32_t kd) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    mma_qk<F16, BK>(
        sc, desc_sw128(q_wg + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024),
        desc_sw128(kd + (kk / 4) * BK * ROW_BYTES + off, 16, 1024), kk > 0);
  }
}

// O += P V of one key tile: one m64n64k16 per k-step and 64-wide chunk of
// DV; V's chunks are BK * 128 bytes apart (the leading byte offset of an
// MN-major operand), its 8-key groups 1024 (the stride byte offset).
template <bool F16, int NC, int BK>
__device__ __forceinline__ void pv_tile(float (&acc)[NC][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vd) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      mma_rs_n64<F16>(
          acc[c], pa[t],
          desc_sw128(vd + c * BK * ROW_BYTES + t * 16 * ROW_BYTES,
                     BK * ROW_BYTES, 1024),
          1);
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

// P rounded to the input type: the A fragment of k-step t is the
// accumulator's 8-wide groups 2t and 2t + 1, packed in pairs.
template <typename T, int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[t][i] = pack2<T>(sc[8 * t + 2 * i], sc[8 * t + 2 * i + 1]);
}

// -- the kernel ---------------------------------------------------------------

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_tc_fwd(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, T* __restrict__ o, int H,
             int K, int S, int Tn, int causal, int window, float scale_log2) {
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

    // out = O / l, rows >= S skipped; a row with no valid key gives 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qp = ra + 8 * i;
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

constexpr int ERR_NO_ENCODE = 20000;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 10000;      // + the CUresult of a refused map

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (D, heads, rows, B) of a (B, rows, heads, D) tensor whose
// strides (in elements) are given; boxes of 64 x 1 x box_rows x 1.
int make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
             int D, int heads, int rows, int B, long long s_head,
             long long s_row, long long s_b, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_head * 2, (cuuint64_t)s_row * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {CHUNK, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                  elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

struct Strides {                 // in elements; the last dim is contiguous
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, int Tn, Strides st, int causal, int window,
           float scale_log2, cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, type, q, DQK, H, S, B, st.qh, st.qs, st.qb, BQ);
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
      tq, tk, tv, static_cast<T*>(o), H, K, S, Tn, causal, window,
      scale_log2);
  return (int)cudaGetLastError();
}

// The (DQK, DV) instances: equal head dims 64, 128, 256, and MLA's
// (192, 128).
template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int H, int K, int S, int Tn, int D, int DV, Strides st,
               int causal, int window, float scale_log2, cudaStream_t stream) {
  switch (D * 1000 + DV) {
    case 64064: return launch<T, 64, 64>(q, k, v, o, B, H, K, S, Tn, st, causal, window, scale_log2, stream);
    case 128128: return launch<T, 128, 128>(q, k, v, o, B, H, K, S, Tn, st, causal, window, scale_log2, stream);
    case 256256: return launch<T, 256, 256>(q, k, v, o, B, H, K, S, Tn, st, causal, window, scale_log2, stream);
    case 192128: return launch<T, 192, 128>(q, k, v, o, B, H, K, S, Tn, st, causal, window, scale_log2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 1 bf16, 2 f16.  D is the head dim of q and k, DV that of v.
// Strides in elements, q/k/v last dim contiguous, every other stride and
// each base address a multiple of 16 bytes (TMA); o is (B, S, H, DV)
// contiguous.  scale_log2 = log2(e) / sqrt(D).  Returns 0, a cudaError_t,
// or a code that flash_tc_error explains.
int flash_tc_launch(const void* q, const void* k, const void* v, void* o,
                    int dtype, int B, int H, int K, int S, int Tn, int D,
                    int DV, long long qb, long long qs, long long qh,
                    long long kb, long long ks, long long kh, long long vb,
                    long long vs, long long vh, int causal, int window,
                    float scale_log2, void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || S < 1 || Tn < 1 ||
      (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, K, S, Tn, D, DV, st, causal, window, scale_log2, s);
    case 2: return dispatch_d<__half>(q, k, v, o, B, H, K, S, Tn, D, DV, st, causal, window, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_tc_error(int code) {
  static char msg[96];
  if (code == ERR_NO_ENCODE)
    return "cuTensorMapEncodeTiled not found";
  if (code >= ERR_ENCODE) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused a map (CUresult %d)",
             code - ERR_ENCODE);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
