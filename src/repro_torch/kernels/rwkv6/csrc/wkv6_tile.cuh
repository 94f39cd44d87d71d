// Tiles and the cumulative log-decays of WKV6's chunks, for the forward
// (wkv6.cu).  The backward (wkv6_bwd.cu) takes only the constants, Shape
// and Stream from here: its scan_sw sums the log-decays of its swizzled
// tiles in scan_tile's order, so cum, cum_prev and total carry the
// forward's bits.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;     // threads a block, (a) and (c)
constexpr int NS = 256;     // threads a block, (b)
constexpr int MAXC = 64;    // chunk and head dimension, at most
constexpr int LD = 68;      // row stride of the (C, D) tiles, floats

// Chunk c of stream (b, h): the element offset of its first token, the
// stride of a token and the tokens before S.
struct Stream {
  long long off;
  long long tok;  // H * D
  int valid;
};

struct Shape {
  int B, S, H, D, C, nC, Dp;
  int vec;  // D a multiple of 4 and every input on 16 bytes
};

__device__ __forceinline__ Stream stream_of(const Shape& g, int bh, int c) {
  const int b = bh / g.H, h = bh % g.H;
  Stream s;
  s.tok = (long long)g.H * g.D;
  s.off = ((long long)b * g.S + (long long)c * g.C) * s.tok +
          (long long)h * g.D;
  s.valid = min(g.C, g.S - c * g.C);
  return s;
}

// Four floats of a row at p, n of them inside it (n >= 1): one 16-byte
// access where `vec`.
__device__ __forceinline__ float4 load4(const float* p, int n, int vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], n > 1 ? p[1] : 0.0f, n > 2 ? p[2] : 0.0f,
                     n > 3 ? p[3] : 0.0f);
}

__device__ __forceinline__ void store4(float* p, float4 a, int n, int vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = a;
    return;
  }
  p[0] = a.x;
  if (n > 1) p[1] = a.y;
  if (n > 2) p[2] = a.z;
  if (n > 3) p[3] = a.w;
}

// The chunk's tokens from src (the chunk's first element) as the 64 tile
// rows t, D padded to a multiple of 4 (Dp) by zeros, the rows past S or C
// zero: 16-byte loads where `vec` (then every row starts on 16 bytes),
// single floats elsewhere.
__device__ __forceinline__ void load_tile(float* dst, const Stream& s,
                                          const float* src, int D, int Dp,
                                          int vec) {
  if (vec) {
    for (int e = threadIdx.x; e < MAXC * (MAXC / 4); e += NT) {
      const int t = e >> 4, d = (e & 15) * 4;
      if (d < Dp) {
        *reinterpret_cast<float4*>(dst + t * LD + d) =
            t < s.valid ? *reinterpret_cast<const float4*>(src + t * s.tok + d)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < MAXC * MAXC; e += NT) {
      const int t = e >> 6, d = e & (MAXC - 1);
      if (d < Dp) {
        dst[t * LD + d] = (t < s.valid && d < D) ? src[t * s.tok + d] : 0.0f;
      }
    }
  }
}

// cum (inclusive) and cum_prev = cum - lw of each channel of the tile
// `cu` (which holds lw on entry), into `cu` and `cp`, and total = cum[C - 1].
// One thread a channel sums its tokens in order, as torch.cumsum does: the
// exponents take differences of cum, which reaches -1e4 under strong
// decay, so a sum in another order (a scan in runs) moves them by ~1e-3,
// outside the tolerance.  The loads come first, 16 in flight.
__device__ __forceinline__ void scan_tile(float* cu, float* cp,
                                          float* total, int C, int Dp) {
  const int d = threadIdx.x;
  if (d < Dp) {
    float run = 0.0f;
    for (int t0 = 0; t0 < C; t0 += 16) {
      float w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = cu[(t0 + i) * LD + d];  // rows < 64
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (t0 + i < C) {
          run += w[i];
          cu[(t0 + i) * LD + d] = run;
          cp[(t0 + i) * LD + d] = run - w[i];
        }
      }
    }
    total[d] = run;
  }
  __syncthreads();
}

// The strict lower triangle of a chunk's scores into ATT (rows MAXC + 1
// floats apart), att[t, j] = sum_d r[t,d] k[j,d] exp(cum_prev[t,d] -
// cum[j,d]), j < t < C, as items: for each pair of rows
// (2m, 2m + 1), a "double" per j < 2m (both rows against k[j], cum[j],
// read once for the two), then a "single" (2m + 1, 2m).  Neighbouring
// threads take neighbouring j of one row pair: the rows' loads are
// broadcasts, and k's and cum's rows (68 floats apart) meet no bank
// conflict.
__device__ __forceinline__ void strict_scores(const float* R, const float* K,
                                              const float* CP,
                                              const float* CU, float* ATT,
                                              int C, int Dp) {
  const int M = (C + 1) / 2, doubles = M * (M - 1), items = doubles + C / 2;
  for (int it = threadIdx.x; it < items; it += NT) {
    int ta, tb, j;
    if (it < doubles) {
      int m = static_cast<int>((1.0f + sqrtf(1.0f + 4.0f * it)) * 0.5f);
      while (m * (m - 1) > it) --m;
      while ((m + 1) * m <= it) ++m;
      ta = 2 * m;
      tb = 2 * m + 1;
      j = it - m * (m - 1);
    } else {
      const int m = it - doubles;
      ta = tb = 2 * m + 1;
      j = 2 * m;
    }
    const float4* ra = reinterpret_cast<const float4*>(R + ta * LD);
    const float4* pa = reinterpret_cast<const float4*>(CP + ta * LD);
    const float4* rb = reinterpret_cast<const float4*>(R + tb * LD);
    const float4* pb = reinterpret_cast<const float4*>(CP + tb * LD);
    const float4* kj = reinterpret_cast<const float4*>(K + j * LD);
    const float4* cj = reinterpret_cast<const float4*>(CU + j * LD);
    float a0 = 0.0f, a1 = 0.0f;
    for (int q = 0; q < Dp / 4; ++q) {
      const float4 kk = kj[q], cc = cj[q];
      const float4 r0 = ra[q], p0 = pa[q], r1 = rb[q], p1 = pb[q];
      a0 = fmaf(r0.x * kk.x, expf(p0.x - cc.x), a0);
      a1 = fmaf(r1.x * kk.x, expf(p1.x - cc.x), a1);
      a0 = fmaf(r0.y * kk.y, expf(p0.y - cc.y), a0);
      a1 = fmaf(r1.y * kk.y, expf(p1.y - cc.y), a1);
      a0 = fmaf(r0.z * kk.z, expf(p0.z - cc.z), a0);
      a1 = fmaf(r1.z * kk.z, expf(p1.z - cc.z), a1);
      a0 = fmaf(r0.w * kk.w, expf(p0.w - cc.w), a0);
      a1 = fmaf(r1.w * kk.w, expf(p1.w - cc.w), a1);
    }
    // a row 2m + 1 past the chunk (C odd) is computed and not kept
    if (ta != tb) ATT[ta * (MAXC + 1) + j] = a0;
    if (tb < C) ATT[tb * (MAXC + 1) + j] = a1;
  }
}

}  // namespace
