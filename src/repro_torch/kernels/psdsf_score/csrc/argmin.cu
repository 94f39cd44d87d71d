// Masked argmins of the allocation epoch's selects for Hopper (sm_90a), CUDA
// C++: K2 over the (N, J) score matrix, K1 over a score vector and K4, the
// per-grant pick that scores as it goes; each ONE launch that writes its
// result into outputs the caller keeps.
//
// Replaces the TPU kernels of repro/kernels/psdsf_score/kernel.py:
//   * K2 masked_argmin2d_tiles (pallas_call at :149): the pooled PS-DSF /
//     rPS-DSF select.  The TPU kernel takes the first minimum of each
//     (bn, bj) tile in row-major cell order, then the first tile holding the
//     global minimum in row-major tile order;
//   * K1 masked_argmin1d_tiles (pallas_call at :98): the RRR server visit and
//     the DRF/TSF select, the first minimum of a vector;
//   * K4 psdsf_argmin_tiles (pallas_call at :180, body _score_tile_kernel
//     at :43): the per-grant backend's fused PS-DSF / rPS-DSF score
//     (x / phi) * max_r d / res, feasibility d <= res and the same tile-order
//     minimum, from raw (x, phi, d, res).
//
// The tie order is carried by a key, not by the block shape.  Each cell's
// key is its place in the reference's order:
//     K2: ((n / bn) * tj + j / bj) * (bn * bj) + (n % bn) * bj + j % bj
//     K1: i
// (bn, bj powers of two, so shifts and masks).  A cell's masked value is its
// score where the mask is set and BIG (3.4e38f, the f32 rounding of the
// reference's sentinel) elsewhere; the pair packs into one u64 as
//     ordered_bits(value + 0.0f) << 32 | key,
// whose unsigned order is (value, key) lexicographic.  Adding +0.0 turns
// -0.0 into +0.0 first, so the two zeros tie and the lower key wins, as
// torch.argmin has it.  The minimum of packed words does not depend on how
// the cells are split among threads and blocks, so any grid gives the
// reference's pick.  The value written out is the source element at the
// winner (its own sign of zero), or, where nothing is feasible, the minimum
// value itself (BIG, or inf where every cell is a feasible inf), clamped to
// BIG where the reference pads the shape with masked cells.  A NaN at a
// feasible cell packs below every value (ordered bits 0), as jnp.argmin and
// torch.argmin order a NaN first: the first feasible NaN in tile order wins,
// and the value written out is that NaN.
//
// K2, one launch: a fixed grid of about two blocks a SM streams the rows
// with 16-byte loads (float4 scores, uchar4 mask, four of each in flight a
// thread), or one cell at a time where a row stride, J or a base address is
// not a multiple of the vector width.  Each block reduces its packed
// minimum by warp shuffles, then one thread makes one atomicMin into the
// caller's workspace slot, a fence, and an atomicAdd on the ticket; the
// block that draws the last ticket reads the slot (atomically, resetting it
// to all ones), writes (val, n, j) and resets the ticket.  So the workspace
// is ready for the next launch without a memset or a host sync, and the
// call can be captured in a CUDA graph.  The workspace belongs to the
// caller's output holder, so two launches share it only where they share
// their outputs too.
//
// K1, one launch of one block of 1024 threads, any stride (the RRR visit
// passes a column): the same packed minimum, no workspace.
//
// K4, one launch a pick: a fixed grid of about four blocks a SM.  A thread
// owns a column j, with res[j] in registers (the threads of a block read
// neighbouring rows: coalesced), and walks its block's range of rows, whose
// x / phi and d rows the block stages in shared memory.  A cell computes
// what _score_tile_kernel computes, in its order (IEEE divisions, no fused
// multiply-add: the picks equal the plain version's bit for bit), and packs
// as K2's cells do; an infeasible cell counts as BIG.  The blocks meet as
// K2's do.  The launch also carries the previous grant's mirror update (its
// row n and units, its column j and new res row, whether row n is now
// exhausted): every thread reads row n and column j as updated, and the
// last block, which runs when every block has read its inputs, writes the
// update back to the mirrors (x[n] += units as one f32 add, d[n] = 3e38,
// res[j] = the row) and (n, j) into the holder's pinned host pair.  So a
// pick costs one launch and one stream sync, and nothing else on the
// device.
//
// The reference's tile rule (the clamped bn, bj and whether the shape is
// padded) is decided by the Python wrapper, which passes log2(bn),
// log2(bj), tj and `pad` (K1 only `pad`); nothing here repeats it.
//
// Bound on the H100: bytes.  K2 reads each score (4 bytes) and mask byte
// once and writes 12 bytes: 10.5 MB at 512 x 4096, 3.13 us at 3.35 TB/s.
// K1 at (512,) reads 2.5 KB, 0.77 ns, far below what any launch costs;
// argmin_noop_launch launches an empty kernel through the same interface,
// so that floor can be measured.  K4 at (512, 4096, R = 2) reads 40 KB and
// does about 13 operations a cell, two of them IEEE divisions (a dozen
// instructions each): 0.4 us at 67 TFLOP/s by the count of operations, a
// few us by the count of instructions; the launch and the host's sync are
// most of a pick.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;
constexpr int kThreads2d = 256;
constexpr int kBlocksPerSm = 2;
constexpr int kUnroll = 4;
constexpr int kThreads1d = 1024;

struct Workspace {
  unsigned long long slot;  // packed minimum so far; all ones between calls
  unsigned int ticket;      // blocks done; 0 between calls
  unsigned int pad;
};

struct Geom {
  const float* s;
  const uint8_t* m;
  long long ss, ms;  // row strides of scores and mask, in elements
  int N, J, lbn, lbj, tj;
};

__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ unsigned long long pack(float v, bool ok,
                                                   unsigned key) {
  const unsigned o = !ok     ? ordered_bits(kBig)
                     : v == v ? ordered_bits(v)
                              : 0u;  // a feasible NaN: first
  return (static_cast<unsigned long long>(o) << 32) | key;
}

// A feasible cell won: its value is below BIG, or a NaN (packed first).
__device__ __forceinline__ bool feasible_win(float v) { return !(v >= kBig); }

__device__ __forceinline__ unsigned long long umin(unsigned long long a,
                                                   unsigned long long b) {
  return b < a ? b : a;
}

// -> the block's minimum, valid in thread 0.
template <int NT>
__device__ __forceinline__ unsigned long long block_min(unsigned long long x) {
  __shared__ unsigned long long part[NT / 32];
#pragma unroll
  for (int o = 16; o; o >>= 1) x = umin(x, __shfl_xor_sync(kFull, x, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) part[w] = x;
  __syncthreads();
  if (w == 0) {
    x = l < NT / 32 ? part[l] : kNone;
#pragma unroll
    for (int o = 16; o; o >>= 1) x = umin(x, __shfl_xor_sync(kFull, x, o));
  }
  return x;
}

__device__ __forceinline__ unsigned tile_key(unsigned n, unsigned j, int lbn,
                                             int lbj, int tj) {
  const unsigned t = (n >> lbn) * tj + (j >> lbj);
  return (t << (lbn + lbj)) | ((n & ((1u << lbn) - 1)) << lbj) |
         (j & ((1u << lbj) - 1));
}

__device__ __forceinline__ unsigned tile_key(unsigned n, unsigned j,
                                             const Geom& g) {
  return tile_key(n, j, g.lbn, g.lbj, g.tj);
}

// The key back to its cell: (n, j) of a tile-order key.
__device__ __forceinline__ void tile_cell(unsigned key, int lbn, int lbj,
                                          int tj, int* n, int* j) {
  const unsigned t = key >> (lbn + lbj), cell = key & ((1u << (lbn + lbj)) - 1);
  *n = static_cast<int>((t / tj) << lbn | (cell >> lbj));
  *j = static_cast<int>((t % tj) << lbj | (cell & ((1u << lbj) - 1)));
}

// The blocks' join, thread 0 of each block: one atomicMin of the block's
// minimum into the workspace slot, a fence, then a ticket.  -> true in the
// block that draws the last ticket, with *w the grid's packed minimum; that
// block has reset the slot to all ones and the ticket to 0, so the
// workspace is ready for the next launch.
__device__ __forceinline__ bool join(unsigned long long best, Workspace* ws,
                                     unsigned long long* w) {
  if (best != kNone) atomicMin(&ws->slot, best);
  __threadfence();  // the slot update lands before this block's ticket
  if (atomicAdd(&ws->ticket, 1u) != gridDim.x - 1) return false;
  // the last block: every other block's atomicMin is in the slot
  *w = atomicExch(&ws->slot, kNone);
  ws->ticket = 0;
  return true;
}

// The minimum over this thread's share of the cells: chunk c of the
// flattened (N, J / W) grid of W-cell chunks, c = tid, tid + stride, ...
template <bool kVec>
__device__ __forceinline__ unsigned long long thread_min(const Geom& g) {
  constexpr unsigned W = kVec ? 4 : 1;
  // unsigned: total < 2^31 (the wrapper's key check), so c + 3 * stride
  // cannot wrap
  const unsigned cpr = g.J / W;  // chunks a row
  const unsigned total = g.N * cpr;
  const unsigned stride = gridDim.x * blockDim.x;
  unsigned long long best = kNone;
  unsigned c = blockIdx.x * blockDim.x + threadIdx.x;
  for (; c < total; c += kUnroll * stride) {
    float4 v[kUnroll];
    uchar4 k[kUnroll];
    unsigned n[kUnroll], j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load first: four in flight
      const unsigned cu = c + u * stride;
      n[u] = cu / cpr;
      j[u] = (cu - n[u] * cpr) * W;
      if (cu < total) {
        const float* sp = g.s + n[u] * g.ss + j[u];
        const uint8_t* mp = g.m + n[u] * g.ms + j[u];
        if (kVec) {
          v[u] = __ldg(reinterpret_cast<const float4*>(sp));
          k[u] = __ldg(reinterpret_cast<const uchar4*>(mp));
        } else {
          v[u].x = __ldg(sp);
          k[u].x = __ldg(mp);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * stride < total) {
        // a chunk starts at a multiple of 4 and bj >= 8: one tile, keys
        // consecutive
        const unsigned key = tile_key(n[u], j[u], g);
        best = umin(best, pack(v[u].x, k[u].x, key));
        if (kVec) {
          best = umin(best, pack(v[u].y, k[u].y, key + 1));
          best = umin(best, pack(v[u].z, k[u].z, key + 2));
          best = umin(best, pack(v[u].w, k[u].w, key + 3));
        }
      }
    }
  }
  return best;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads2d)
argmin2d_kernel(Geom g, int pad, float* __restrict__ out_val,
                int* __restrict__ out_n, int* __restrict__ out_j,
                Workspace* ws) {
  const unsigned long long best = block_min<kThreads2d>(thread_min<kVec>(g));
  unsigned long long w;
  if (threadIdx.x != 0 || !join(best, ws, &w)) return;
  const float v = from_ordered(static_cast<unsigned>(w >> 32));
  if (feasible_win(v)) {
    int n, j;
    tile_cell(static_cast<unsigned>(w), g.lbn, g.lbj, g.tj, &n, &j);
    *out_val = g.s[n * g.ss + j];
    *out_n = n;
    *out_j = j;
  } else {
    *out_val = pad ? fminf(v, kBig) : v;
    *out_n = -1;
    *out_j = -1;
  }
}

__global__ void __launch_bounds__(kThreads1d)
argmin1d_kernel(const float* __restrict__ s, const uint8_t* __restrict__ ok,
                int n, long long ss, long long os, int pad,
                float* __restrict__ out_val, int* __restrict__ out_idx) {
  unsigned long long best = kNone;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads1d) {
    best = umin(best, pack(__ldg(s + i * ss), __ldg(ok + i * os),
                           static_cast<unsigned>(i)));
  }
  best = block_min<kThreads1d>(best);
  if (threadIdx.x != 0) return;
  const float v = from_ordered(static_cast<unsigned>(best >> 32));
  if (feasible_win(v)) {
    const int i = static_cast<int>(static_cast<unsigned>(best));
    *out_val = s[i * ss];
    *out_idx = i;
  } else {
    *out_val = pad ? fminf(v, kBig) : v;
    *out_idx = -1;
  }
}

// -- K4: the per-grant pick ---------------------------------------------------

constexpr int kThreadsPick = 256;  // threads a block, along j
constexpr int kPickBlocksPerSm = 4;  // measured: 2 and 8 are slower
constexpr int kMaxR = 8;
constexpr float kExhausted = 3.0e38f;  // the per-grant backend's unsatisfiable
                                       // demand row (engine.py _KBIG)

// One launch's inputs, by value: the mirrors, the outputs, the tile words
// and the previous grant's pending mirror update.
struct Pick {
  float* x;          // (N,) tot mirror; the pending add lands here
  const float* phi;  // (N,)
  float* d;          // (N, R) demand rows, unit column stride
  float* res;        // (J, R) residual rows, unit column stride
  float* out_val;
  int* out_n;
  int* out_j;
  Workspace* ws;
  int* host_nj;      // the holder's pinned (n, j), as the device sees it
  int N, J, ds, rs, lbn, lbj, tj, pad;
  int rows;          // rows a block
  int pn, pj, pexh;  // pending: row, column (-1: none), row now exhausted
  float punits;      // pending: units granted, added to x[pn]
  float pres[kMaxR]; // pending: the new res[pj] row
};

// The inputs as this launch sees them: the pending update applied.  x[pn]
// is read as memory holds it and the units added; d[pn] (when exhausted)
// and res[pj] are not read.  Only the last block writes the update back,
// once every block has read what it needs: x[pn] += units is an add, so
// no block may see it twice.
__device__ __forceinline__ float pick_x(const Pick& p, int n) {
  const float x = p.x[n];
  return n == p.pn ? __fadd_rn(x, p.punits) : x;
}

__device__ __forceinline__ float pick_d(const Pick& p, int n, int r) {
  return n == p.pn && p.pexh ? kExhausted : p.d[n * p.ds + r];
}

__device__ __forceinline__ float pick_res(const Pick& p, int j, int r) {
  return j == p.pj ? p.pres[r] : p.res[j * p.rs + r];
}

// The reference's cell: feasibility d <= res in every resource; the
// quotients (BIG where res <= 0, 0 where also d == 0), their running
// maximum from 0 (NaN-propagating, the first operand on a tie, as
// torch.maximum), then (x / phi) * dom.  -> false where infeasible.
template <int R>
__device__ __forceinline__ bool pick_cell(float xs, const float* dn,
                                          const float* rj, float* score) {
  bool feas = true;
#pragma unroll
  for (int r = 0; r < R; ++r) feas &= dn[r] <= rj[r];
  if (!feas) return false;
  float dom = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool ok = rj[r] > 0.0f;
    const float q = __fdiv_rn(dn[r], ok ? rj[r] : 1.0f);
    const float frac = ok ? q : (dn[r] == 0.0f ? 0.0f : kBig);
    dom = (frac != frac) ? frac : (dom < frac ? frac : dom);
  }
  *score = __fmul_rn(xs, dom);
  return true;
}

// One cell into a thread's first minimum: strict <, a NaN before every
// value (as pack() orders it), the first cell taken whatever its value.
__device__ __forceinline__ void pick_first_min(float score, int n,
                                               float* best_v, int* best_n) {
  if (*best_n < 0 || score < *best_v ||
      (score != score && *best_v == *best_v)) {
    *best_v = score;
    *best_n = n;
  }
}

// Grid: blockIdx.x = row group * column chunks + column chunk.  A thread
// owns one column j (its res row in registers, loaded coalesced) and walks
// its block's rows in increasing n, whose x / phi and d rows sit in shared
// memory, 256 at a time.  A column's tile keys increase with n, so the
// thread's first minimum in that order is its least packed word: the key
// is formed once, for the winner.
template <int R>
__global__ void __launch_bounds__(kThreadsPick)
psdsf_pick_kernel(const Pick p) {
  __shared__ float xs_s[kThreadsPick];
  __shared__ float d_s[kThreadsPick][R];
  const int chunks = (p.J + kThreadsPick - 1) / kThreadsPick;
  const int j = (blockIdx.x % chunks) * kThreadsPick + threadIdx.x;
  const int n0 = (blockIdx.x / chunks) * p.rows;
  const int n1 = min(p.N, n0 + p.rows);
  const bool live = j < p.J;
  float rj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rj[r] = live ? pick_res(p, j, r) : 0.0f;
  float best_v = 0.0f;
  int best_n = -1;
  bool masked = false;
  for (int base = n0; base < n1; base += kThreadsPick) {
    const int rows = min(kThreadsPick, n1 - base);
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < rows) {
      const int n = base + threadIdx.x;
      xs_s[threadIdx.x] = __fdiv_rn(pick_x(p, n), p.phi[n]);
#pragma unroll
      for (int r = 0; r < R; ++r) d_s[threadIdx.x][r] = pick_d(p, n, r);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      float dn[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dn[r] = d_s[i][r];
      float score;
      if (pick_cell<R>(xs_s[i], dn, rj, &score)) {
        pick_first_min(score, base + i, &best_v, &best_n);
      } else {
        masked = true;
      }
    }
  }
  // an infeasible cell counts as BIG (its key plays no part: BIG is never
  // a win), so "nothing feasible" decodes as the reference's value
  unsigned long long best = masked ? pack(kBig, false, 0u) : kNone;
  if (best_n >= 0) {
    best = umin(best, pack(best_v, true,
                           tile_key(best_n, j, p.lbn, p.lbj, p.tj)));
  }
  best = block_min<kThreadsPick>(best);
  unsigned long long w;
  if (threadIdx.x != 0 || !join(best, p.ws, &w)) return;
  // the last block: every block has read its inputs
  const float v = from_ordered(static_cast<unsigned>(w >> 32));
  int n = -1, jw = -1;
  float val = p.pad ? fminf(v, kBig) : v;
  if (feasible_win(v)) {
    tile_cell(static_cast<unsigned>(w), p.lbn, p.lbj, p.tj, &n, &jw);
    val = v;
    if (!(v != 0.0f)) {  // a zero (its sign) or a NaN: the cell itself
      float dn[R], rw[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dn[r] = pick_d(p, n, r);
        rw[r] = pick_res(p, jw, r);
      }
      pick_cell<R>(__fdiv_rn(pick_x(p, n), p.phi[n]), dn, rw, &val);
    }
  }
  *p.out_val = val;
  *p.out_n = n;
  *p.out_j = jw;
  p.host_nj[0] = n;
  p.host_nj[1] = jw;
  if (p.pn >= 0) {  // the pending update, written back to the mirrors
    p.x[p.pn] = __fadd_rn(p.x[p.pn], p.punits);
    if (p.pexh) {
#pragma unroll
      for (int r = 0; r < R; ++r) p.d[p.pn * p.ds + r] = kExhausted;
    }
  }
  if (p.pj >= 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) p.res[p.pj * p.rs + r] = p.pres[r];
  }
}

__global__ void noop_kernel() {}

int sm_count(int dev) {
  static int cached[64];
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || v < 1) {
      v = 132;
    }
    cached[dev] = v;
  }
  return cached[dev];
}

// Runs launch() with `dev` as the current device, then restores it.
template <typename F>
int on_device(int dev, F launch) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cur != dev && (err = cudaSetDevice(dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  launch();
  err = cudaGetLastError();
  if (cur != dev) cudaSetDevice(cur);
  return static_cast<int>(err);
}

}  // namespace

// The wrappers pass a launch's arguments as one array of 64-bit words, a
// pointer or an integer each, in the order of these structs: ctypes
// converts each argument of a call separately, and a K2 call is paced by
// the host, so one array write and a one-argument call is the cheaper
// way across.
struct Argmin2dArgs {
  const float* s;         // (N, J) f32, unit column stride
  const uint8_t* mask;    // (N, J) bytes (bool or uint8), unit column stride
  float* out_val;         // 0-d f32
  int* out_n;             // 0-d int32
  int* out_j;             // 0-d int32
  void* workspace;        // the holder's: slot all ones, ticket 0
  void* stream;
  long long N, J, s_stride, m_stride;
  long long lbn, lbj;     // log2 of the reference's tile (bn, bj)
  long long tj;           // tiles a row of tiles
  long long pad;          // 1 where the tiles overhang (N, J)
  long long dev;
};
static_assert(sizeof(Argmin2dArgs) == 16 * 8, "one 64-bit word a field");

struct Argmin1dArgs {
  const float* s;         // (n,) f32, any stride
  const uint8_t* ok;      // (n,) bytes, any stride
  float* out_val;         // 0-d f32
  int* out_idx;           // 0-d int32
  void* stream;
  long long n, s_stride, ok_stride;
  long long pad;          // 1 where the reference pads n to whole tiles
  long long dev;
};
static_assert(sizeof(Argmin1dArgs) == 10 * 8, "one 64-bit word a field");

struct PickArgs {
  float* x;               // (N,) f32 tot mirror
  const float* phi;       // (N,) f32
  float* d;               // (N, R) f32 demand mirror, unit column stride
  float* res;             // (J, R) f32 residual mirror, unit column stride
  float* out_val;         // 0-d f32
  int* out_n;             // 0-d int32
  int* out_j;             // 0-d int32
  void* workspace;        // the holder's: slot all ones, ticket 0
  int* host_nj;           // the holder's pinned (n, j), device address
  void* stream;
  long long N, J, R, d_stride, res_stride;
  long long lbn, lbj;     // log2 of the reference's tile (bn, bj)
  long long tj;           // tiles a row of tiles
  long long pad;          // 1 where the tiles overhang (N, J)
  long long dev;
  long long pend_n;       // the previous grant's row; -1: nothing pending
  long long pend_j;       // its column; -1: nothing pending
  long long pend_exhausted;  // 1: row pend_n turns into the 3e38 sentinel
  double pend_units;      // added to x[pend_n] as one f32 add
  float pend_res[8];      // the new res[pend_j] row
};
static_assert(sizeof(PickArgs) == 28 * 8, "one 64-bit word a field");

extern "C" {

// K2.  The wrapper has checked that the padded cell count fits the 31-bit
// key; every launch leaves the workspace as it found it.  Returns a
// cudaError_t.
int argmin2d_launch(const Argmin2dArgs* a) {
  const long long N = a->N, J = a->J;
  if (N < 1 || J < 1) return static_cast<int>(cudaErrorInvalidValue);
  Geom g{a->s,
         a->mask,
         a->s_stride,
         a->m_stride,
         static_cast<int>(N),
         static_cast<int>(J),
         static_cast<int>(a->lbn),
         static_cast<int>(a->lbj),
         static_cast<int>(a->tj)};
  const bool vec = (J % 4 == 0) && (a->s_stride % 4 == 0) &&
                   (a->m_stride % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(a->s) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a->mask) % 4 == 0);
  const long long want = (N * (vec ? J / 4 : J) + kThreads2d - 1) / kThreads2d;
  const int dev = static_cast<int>(a->dev);
  const int cap = kBlocksPerSm * sm_count(dev);
  const int grid = static_cast<int>(want < cap ? want : cap);
  const int pad = static_cast<int>(a->pad);
  auto* ws = static_cast<Workspace*>(a->workspace);
  auto st = static_cast<cudaStream_t>(a->stream);
  return on_device(dev, [&] {
    if (vec) {
      argmin2d_kernel<true><<<grid, kThreads2d, 0, st>>>(
          g, pad, a->out_val, a->out_n, a->out_j, ws);
    } else {
      argmin2d_kernel<false><<<grid, kThreads2d, 0, st>>>(
          g, pad, a->out_val, a->out_n, a->out_j, ws);
    }
  });
}

// K1.  Returns a cudaError_t.
int argmin1d_launch(const Argmin1dArgs* a) {
  if (a->n < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(a->stream);
  return on_device(static_cast<int>(a->dev), [&] {
    argmin1d_kernel<<<1, kThreads1d, 0, st>>>(
        a->s, a->ok, static_cast<int>(a->n), a->s_stride, a->ok_stride,
        static_cast<int>(a->pad), a->out_val, a->out_idx);
  });
}

// K4.  The wrapper has checked shapes, strides, R <= 8, the 31-bit key and
// the pending words.  Grid: the column chunks of 256 times enough row groups
// for about two blocks a SM.  Returns a cudaError_t.
int psdsf_pick_launch(const PickArgs* a) {
  const long long N = a->N, J = a->J, R = a->R;
  if (N < 1 || J < 1 || R < 1 || R > kMaxR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pick p;
  p.x = a->x;
  p.phi = a->phi;
  p.d = a->d;
  p.res = a->res;
  p.out_val = a->out_val;
  p.out_n = a->out_n;
  p.out_j = a->out_j;
  p.ws = static_cast<Workspace*>(a->workspace);
  p.host_nj = a->host_nj;
  p.N = static_cast<int>(N);
  p.J = static_cast<int>(J);
  p.ds = static_cast<int>(a->d_stride);
  p.rs = static_cast<int>(a->res_stride);
  p.lbn = static_cast<int>(a->lbn);
  p.lbj = static_cast<int>(a->lbj);
  p.tj = static_cast<int>(a->tj);
  p.pad = static_cast<int>(a->pad);
  p.pn = static_cast<int>(a->pend_n);
  p.pj = static_cast<int>(a->pend_j);
  p.pexh = static_cast<int>(a->pend_exhausted);
  p.punits = static_cast<float>(a->pend_units);
  for (int r = 0; r < kMaxR; ++r) p.pres[r] = r < R ? a->pend_res[r] : 0.0f;
  const int dev = static_cast<int>(a->dev);
  const int chunks = static_cast<int>((J + kThreadsPick - 1) / kThreadsPick);
  const int cap = kPickBlocksPerSm * sm_count(dev);
  const int groups_want = cap / chunks > 1 ? cap / chunks : 1;
  const int groups = static_cast<int>(groups_want < N ? groups_want : N);
  p.rows = static_cast<int>((N + groups - 1) / groups);
  const int grid = chunks * static_cast<int>((N + p.rows - 1) / p.rows);
  auto st = static_cast<cudaStream_t>(a->stream);
  return on_device(dev, [&] {
    switch (R) {
      case 1: psdsf_pick_kernel<1><<<grid, kThreadsPick, 0, st>>>(p); break;
      case 2: psdsf_pick_kernel<2><<<grid, kThreadsPick, 0, st>>>(p); break;
      case 3: psdsf_pick_kernel<3><<<grid, kThreadsPick, 0, st>>>(p); break;
      case 4: psdsf_pick_kernel<4><<<grid, kThreadsPick, 0, st>>>(p); break;
      case 5: psdsf_pick_kernel<5><<<grid, kThreadsPick, 0, st>>>(p); break;
      case 6: psdsf_pick_kernel<6><<<grid, kThreadsPick, 0, st>>>(p); break;
      case 7: psdsf_pick_kernel<7><<<grid, kThreadsPick, 0, st>>>(p); break;
      default: psdsf_pick_kernel<8><<<grid, kThreadsPick, 0, st>>>(p); break;
    }
  });
}

// Waits for `stream` (a K4 pick's answer is then in the holder's pinned
// pair).  Returns a cudaError_t: a fault in the launch shows here.
int psdsf_pick_wait(void* stream) {
  return static_cast<int>(
      cudaStreamSynchronize(static_cast<cudaStream_t>(stream)));
}

// The device's address of pinned host memory (the same address where
// memory is unified, as on every 64-bit platform CUDA supports).  Returns a
// cudaError_t.
int argmin_host_device_ptr(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
}

// An empty kernel through the same interface: the launch floor.
int argmin_noop_launch(int dev, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return on_device(dev, [&] { noop_kernel<<<1, 32, 0, st>>>(); });
}

const char* argmin_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
