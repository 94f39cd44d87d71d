// Hopper (sm_90a) building blocks shared by K5's tensor-core kernels,
// flash_tc.cu (the forward) and flash_bwd_tc.cu (the backward): mbarriers,
// TMA loads, wgmma on bf16 / f16 tiles kept in shared memory in the
// 128-byte swizzle, the accumulator-to-A-fragment packing, and the host's
// tensor maps.
//
// Tile layout: every tile is kept as 64-element (128-byte) column chunks
// of [rows][64], written by TMA with the 128-byte swizzle that the wgmma
// descriptors name; a D = 128 row is two TMA boxes, a D = 192 row three.
// The A operand of every SS product is a 128-row tile (A_ROWS: a CTA's two
// consumer warpgroups of 64 rows each), its B operand an N-row tile.
#pragma once

#include <cuda.h>                 // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int CHUNK = 64;         // elements of a 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr int A_ROWS = 128;       // rows of an SS product's A tile

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

// Wait until the barrier has completed the phase of the given parity.  A
// wait that has not completed after about 10 s of clock traps, so a fault
// in a pipeline ends the launch with an error instead of hanging the card.
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

// A contiguous run of bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory by the bulk-copy engine, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// d = A B^T of one tile, both K-major in shared memory: A the warpgroup's
// 64 rows of an A_ROWS-row tile from a_wg, B an N-row tile from b; DK / 16
// k-steps, 16 elements (32 bytes) each along the 64-element chunks.
// (S = Q K^T in the forward; S, dP and their transposes in the backward.)
template <bool F16, int DK, int N>
__device__ __forceinline__ void qk_tile(float (&d)[N / 2], uint32_t a_wg,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    mma_qk<F16, N>(
        d, desc_sw128(a_wg + (kk / 4) * A_ROWS * ROW_BYTES + off, 16, 1024),
        desc_sw128(b + (kk / 4) * N * ROW_BYTES + off, 16, 1024), kk > 0);
  }
}

// acc += A B of one tile: A the 16-bit fragments of a 64 x BK operand in
// registers, B a BK-row tile of NC 64-wide chunks in shared memory, read
// MN-major.  One m64n64k16 per k-step and chunk; B's chunks are BK * 128
// bytes apart (the leading byte offset of an MN-major operand), its 8-row
// groups 1024 (the stride byte offset).  (O += P V in the forward; dQ +=
// dS K, dV += P^T dO and dK += dS^T Q in the backward.)
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

// An f32 accumulator of m64nBK rounded to the input type as wgmma's A
// operand: the A fragment of k-step t is the accumulator's 8-wide groups
// 2t and 2t + 1, packed in pairs.  The thread's rows of the accumulator
// are lane / 4 and lane / 4 + 8 of its warp's 16, its columns of every
// 8-wide group 2 * (lane % 4) and the next.
template <typename T, int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[t][i] = pack2<T>(sc[8 * t + 2 * i], sc[8 * t + 2 * i + 1]);
}

// -- host: tensor maps ---------------------------------------------------------

constexpr int ERR_NO_ENCODE = 20000;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 10000;      // + the CUresult of a refused map

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// looked up at run time through the CUDA runtime (no -lcuda)
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

// Makes the current device's primary context current on the calling
// thread.  The driver's map encoder needs one, and a thread that has made
// no runtime call yet (autograd's backward thread) may have none.
int current_context() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  return (int)err;
}

// A 4-D map over (D, heads, rows, B) of a (B, rows, heads, D) tensor whose
// strides (in elements) are given; boxes of 64 x 1 x box_rows x 1.  TMA
// zero-fills the rows of a box past `rows`.
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

// The message of a code that a launch function returned: a cudaError_t or
// one of the tensor maps' codes.
const char* launch_error(int code) {
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

}  // namespace
