// Persistent allocation epoch for Hopper (sm_90a): one cooperative launch
// runs one whole epoch segment, select -> grant -> refresh per grant, with
// the epoch state updated in place in device memory.
//
// Replaces the TPU kernel repro/kernels/epoch_persistent/kernel.py::
// epoch_kernel (pallas_call at ops.py:86, wrapper persistent_epoch).  The
// arithmetic is that kernel's and the engine's plain loop's, step for step:
//   * the global two-pass tie-low select (minimum m, then the first index
//     with masked <= m + (1e-9 + 1e-6 |m|)), masked entries at 3.0e38;
//   * RRR: the first position at or after `pos` of the current permutation
//     whose server has a feasible framework, else the first of the next
//     permutation (wrap).  Scanning positions gives the server of least
//     rank directly, so no rank inversion is needed;
//   * grant, feasibility column j and row n, then the criterion refresh of
//     row n (and, for rPS-DSF, residual column j with the kernel's own
//     3.0e38 sentinel).
// Built with -fmad=false and without fast math, so every product and sum
// rounds as the plain PyTorch version's does.  The one sum whose order
// differs from it (the rPS-DSF residual X[:, j] . D[:, r], reduced by one
// block) is exact on quantized demands, as in the paper's workloads.  A
// feasible NaN score is outside the contract: the f32 minimum here skips it
// (fminf) where the plain version's torch.min returns it.
//
// Feasibility counts instead of mask scans.  rowcnt[N] and colcnt[J] (and
// their total) are counted from `feas` at the start of every launch and
// kept in the grant: column j's rewrite moves each rowcnt[i] by new - old
// and sets colcnt[j]; row n's clear takes one from colcnt[k] for each k it
// clears and zeroes rowcnt[n].  So liveness is total > 0, the DRF/TSF
// select's row_ok is rowcnt > 0 and RRR's server_ok is colcnt > 0: those
// selects cost O(N + J) a grant, and the mask is read only in row n and
// column j.  Counts are integers, so no grant can change.
//
// Two shapes of one kernel.  The pooled PS-DSF / rPS-DSF select reads every
// cell of the (N, J) scores and mask (10.5 MB at 512 x 4096) and runs over
// the whole card: a cooperative grid of co-resident blocks (one a SM).
// Block 0 applies grants; blocks 1.. own contiguous slices of the cells.
// A slice's masked scores stay in the block's shared memory (64 KB at 512 x
// 4096) from grant to grant, and the block reads again, with 16-byte loads
// through L2, only the row and column the last grant wrote; a slice too
// large for shared memory is streamed from L2 at every pick.  Loads of
// what another block wrote go through L2 (__ldcg: never the SM's own L1
// or the non-coherent path).  One grid barrier a grant:
//   phase 1: block 0 applies the grant picked last (only row n and column
//     j change) and takes that row and column as its part; the other
//     blocks meanwhile take their slices without row n and column j, which
//     are all that can change under them.  Each block publishes its part's
//     least masked score, the first cell within the tolerance of THAT
//     score, and the cell's score (a slot a block, by the parity of the
//     grant count, so no slot is reset);
//   grid.sync();
//   the pick: every block reads the slots and takes the least score m and
//     the least first cell among the parts within 1e-9 + 1e-6 |m| of m.  A
//     part's first cell within its own tolerance is its first within m's
//     (which is no wider), unless its score lies between the two: a
//     near-tie across parts, after which one more round (each part's first
//     cell within m's tolerance, a barrier) gives the global two-pass
//     tie-low rule's pick in every case.
// The liveness check reads the feasible count block 0 publishes in its
// slot.  The other six criterion / policy pairs select in O(N + J) with
// the counts, and barriers across the grid would cost more than they save:
// they run the same source as a grid of ONE block, whose select, grant and
// refresh are separated by __syncthreads().
//
// The grant (one block, either shape) forms in every thread the scalars it
// needs from the grant (tot[n] + 1, FREE[j] - TD[n], used[j] + 1, with the
// rounding thread 0 stores), and loads row n and column j before it stores
// anything, so those loads travel together; one barrier joins the column
// sums (count, and the residual for rPS-DSF), a second the rPS-DSF column
// refresh's minimum.
//
// Bound on the H100: the operations of the selects.  Read once, the
// epoch's inputs and outputs are about 55 MB at 512 x 4096 (16 us); its
// pooled selects compare every cell once per grant (2.1M comparisons,
// 0.031 us a grant at the f32 rate).  What bounds it on this card is one
// dependent chain of grants, each paying a grid barrier (epoch_barrier_
// floor measures it) and block 0's grant (a few L2 round trips and block
// barriers); the slices' work runs beside the grant.  A separate
// instantiation of the grid shape (kProf) splits a launch's time by phase;
// the production one carries none of it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// 512 threads a block, 128 registers a thread (one block a SM): at 1024
// threads and 64 registers the grant spilled 216 B and every pair ran
// 1.1-1.2x slower on the card.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;  // <= 32: one warp ends a reduction
constexpr float kBig = 3.0e38f;
constexpr int kIBig = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;
constexpr int kMaxR = 8;
constexpr int kUnroll = 4096 / kThreads;  // a slice's loads in flight
constexpr int kMaxGrid = 256;             // slots the pick reads
constexpr int kMaxCache = 200 * 1024;     // a slice's shared-memory cache

enum Kind : int { kDrf = 0, kTsf = 1, kPsdsf = 2, kRpsdsf = 3 };

// The grid shape's scratch `sync`: for each parity of the grant count, one
// slot a block (its part's least masked score as ordered bits, the first
// flat index whose score is within the tolerance of that least one, that
// score's bits, and in block 0's the feasible count), then one word a
// block for the near-tie round.  9 words a block.
struct Slot {
  unsigned least, first, score, total;
};

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
  int32_t* rowcnt;         // (N,) feasible servers of each framework
  int32_t* colcnt;         // (J,) feasible frameworks of each server
  unsigned* sync;          // (9 x grid,) the grid shape's slots, see Slot
  long long* prof;         // (10,) per-phase clocks (kProf only)
  int N, J, R, K;
  int pidx0, pos0, j_real, limit;
  float eps;
  int kind, rrr, lookahead, use_limit, max_steps;
  int cached;              // the grid shape's slices in shared memory
};

struct Shared {
  float f[kWarps];                 // per-warp partials of block_min
  int i[kWarps];                   // ... of block_min_i and block_sum_i
  unsigned long long q[kWarps];    // ... of block_min_u64
  uint4 slots[kMaxGrid];           // the pick's copy of the grid's slots
  int pick, near_tie, picked_total;  // the pick, for every thread
  float thr;
  // the grant's own, so that it needs no barrier before writing them
  float gf[(kMaxR + 1) * kWarps];  // residual sums and row n's minima
  int gi[kWarps];                  // column j's feasible count
  float gm[kWarps];                // the rPS-DSF column refresh's minima
  int removed;                     // cells row n's clear took besides (n, j)
  int total;                       // feasible cells, kept by thread 0
};

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The xor butterfly leaves the same sum, bit for bit, in every lane.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long warp_min_u64(
    unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(kFull, v, o);
    v = x < v ? x : v;
  }
  return v;
}

// Block-wide reductions; every thread receives the result.  Each starts
// with a barrier, so the shared scratch of the previous one is free.
__device__ float block_min(float v, Shared& sh) {
  const int lane = threadIdx.x & 31;
  v = warp_min(v);
  __syncthreads();
  if (lane == 0) sh.f[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_min(lane < kWarps ? sh.f[lane] : kBig);
}

__device__ int block_min_i(int v, Shared& sh) {
  const int lane = threadIdx.x & 31;
  v = warp_min_i(v);
  __syncthreads();
  if (lane == 0) sh.i[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_min_i(lane < kWarps ? sh.i[lane] : kIBig);
}

__device__ int block_sum_i(int v, Shared& sh) {
  const int lane = threadIdx.x & 31;
  v = warp_sum_i(v);
  __syncthreads();
  if (lane == 0) sh.i[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum_i(lane < kWarps ? sh.i[lane] : 0);
}

__device__ unsigned long long block_min_u64(unsigned long long v,
                                            Shared& sh) {
  const int lane = threadIdx.x & 31;
  v = warp_min_u64(v);
  __syncthreads();
  if (lane == 0) sh.q[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_min_u64(lane < kWarps ? sh.q[lane] : kNone);
}

__device__ __forceinline__ float threshold(float m) {
  return m + (1e-9f + 1e-6f * fabsf(m));
}

__device__ __forceinline__ float masked(bool f, float v) {
  return f ? v : kBig;
}

__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// -- counts --------------------------------------------------------------

// ns/js to -1, rowcnt and colcnt from feas; over the whole grid.
__device__ void init_counts(const Epoch& e) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nt = gridDim.x * kThreads;
  for (int i = tid; i < e.max_steps; i += nt) {
    e.ns[i] = -1;
    e.js[i] = -1;
  }
  const int words = e.J >> 2;
  const uint32_t* f = reinterpret_cast<const uint32_t*>(e.feas);
  const int lane = threadIdx.x & 31;
  for (int r = tid >> 5; r < e.N; r += nt >> 5) {  // a warp a row
    int c = 0;
    for (int w = lane; w < words; w += 32) {
      c += __popc(__vcmpne4(f[(size_t)r * words + w], 0u)) >> 3;
    }
    c = warp_sum_i(c);
    if (lane == 0) e.rowcnt[r] = c;
  }
  for (int w = tid; w < words; w += nt) {  // a thread four columns
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    for (int r = 0; r < e.N; ++r) {
      const uint32_t v = f[(size_t)r * words + w];
      c0 += (v & 0x000000ffu) != 0u;
      c1 += (v & 0x0000ff00u) != 0u;
      c2 += (v & 0x00ff0000u) != 0u;
      c3 += (v & 0xff000000u) != 0u;
    }
    e.colcnt[4 * w] = c0;
    e.colcnt[4 * w + 1] = c1;
    e.colcnt[4 * w + 2] = c2;
    e.colcnt[4 * w + 3] = c3;
  }
}

// The feasible cells, from rowcnt (after a barrier over its writers).
__device__ int count_total(const Epoch& e, Shared& sh) {
  int c = 0;
  for (int i = threadIdx.x; i < e.N; i += kThreads) c += __ldcg(e.rowcnt + i);
  return block_sum_i(c, sh);
}

// -- the grant ------------------------------------------------------------

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Row n's group of four cells q4 (mask word fw, dominant shares d) in the
// grant: the clear when n is done, and the PS-DSF family's refresh.
// Column j's cell is the column's: its mask byte is not touched here and
// its score is rewritten with the same value (PS-DSF) or after the
// barrier (rPS-DSF); the other three enter this thread's minimum, and
// `kept` (if given) receives the four masked scores, column j's at kBig.
__device__ __forceinline__ void row_group(const Epoch& e, int n, int j,
                                          int q4, unsigned fw, float4 d,
                                          bool done, bool ss, float xp,
                                          float& mn, float* kept = nullptr) {
  const size_t nJ = (size_t)n * e.J;
  const float dv[4] = {d.x, d.y, d.z, d.w};
  float v[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int q = 4 * q4 + l;
    bool f = ((fw >> (8 * l)) & 0xffu) != 0u;
    if (q != j && done && f) {
      e.feas[nJ + q] = 0;
      e.colcnt[q] = __ldcg(e.colcnt + q) - 1;
      f = false;
    }
    v[l] = xp * dv[l];
    const float m = ss && q != j ? masked(f, v[l]) : kBig;
    mn = fminf(mn, m);
    if (kept) kept[l] = m;
  }
  if (ss) {
    reinterpret_cast<float4*>(e.s + nJ)[q4] = make_float4(v[0], v[1], v[2],
                                                          v[3]);
  }
}

// A thread's masked scores of row n and column j after a grant, where its
// registers hold them: its first two row groups (column j's cell at kBig)
// and its first column cell.
struct Kept {
  float row[8];
  float col;
};

// Apply grant k = (n, j) with the calling block: the state, feasibility
// column j and row n with their counts, and the criterion refresh.  R is
// the number of resources.  Thread 0 updates sh.total.  With want_min
// (PS-DSF family) -> in every thread the least masked score of row n and
// column j after the grant, in `own` the least of this thread's cells
// among them (its column cells i = t, t + kThreads, ..., its row groups
// of four q4 = t, ..., (n, j) counted in the column) and in `kept` the
// first of them.  Other blocks never write what this reads, except the
// counts (read through L2).

template <int R>
__device__ float grant(const Epoch& e, Shared& sh, int n, int j, int k,
                       bool want_min, float& own, Kept& kept) {
  const int N = e.N, J = e.J, t = threadIdx.x;
  const bool ss = e.kind >= kPsdsf, rp = e.kind == kRpsdsf;
  const float la = e.lookahead ? 1.0f : 0.0f;
  // the grant's scalars, as thread 0 stores them after the first barrier
  const float tot_n = e.tot[n] + 1.0f;
  const bool done = !(tot_n < e.wanted[n]);
  const int used_j = e.used[j] + 1;
  const bool under_limit = !e.use_limit || used_j < e.limit;
  const float xp = (tot_n + la) / e.phi[n];
  // thread 0's own loads, issued with the rest
  const int colcnt_j = t == 0 ? __ldcg(e.colcnt + j) : 0;
  const float x_nj = t == 0 ? e.X[(size_t)n * J + j] : 0.0f;
  const float aux_n = t == 0 && !ss ? e.aux[n] : 0.0f;
  float free_j[R], part[R], c_j[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    free_j[r] = e.FREE[j * R + r] + -e.TD[n * R + r];
    part[r] = 0.0f;
    c_j[r] = rp ? e.C[j * R + r] : 0.0f;
  }
  // row n's first two groups of four cells (q4 = t, t + kThreads), loaded
  // before any store, so that they travel with the column's loads
  const int J4 = J >> 2, qa = t, qb = t + kThreads;
  const size_t nJ = (size_t)n * J;
  unsigned fa = 0u, fb = 0u;
  float4 da = zero4(), db = zero4();
  {  // whether n is done or not: no load waits on another
    const unsigned* f4 = reinterpret_cast<const unsigned*>(e.feas + nJ);
    const float4* dom4 = reinterpret_cast<const float4*>(e.dom + nJ);
    if (qa < J4) {
      fa = f4[qa];
      if (ss) da = dom4[qa];
    }
    if (qb < J4) {
      fb = f4[qb];
      if (ss) db = dom4[qb];
    }
  }
  int colsum = 0;
  float mn = kBig;
  // what the rPS-DSF column refresh needs after the barrier, kept from
  // this thread's first column cell (i = t)
  float pre_t = 0.0f, d_t[R];
  bool c_t = false;
#pragma unroll
  for (int r = 0; r < R; ++r) d_t[r] = 0.0f;
  // column j: feasibility (row n's clear included: tot_n < wanted[n] fails
  // when n is done), rowcnt, the residual's partial sums; for PS-DSF its
  // masked scores, (n, j) at its refreshed value.  Every load first.
  for (int i = t; i < N; i += kThreads) {
    const size_t ij = (size_t)i * J + j;
    const float tot_i = i == n ? tot_n : e.tot[i];
    const float wanted_i = e.wanted[i];
    const bool allowed_ij = e.allowed[ij] != 0;
    const int old = e.feas[ij] != 0;
    const int rc = __ldcg(e.rowcnt + i);
    float td[R];
#pragma unroll
    for (int r = 0; r < R; ++r) td[r] = e.TD[i * R + r];
    const float x = rp ? e.X[ij] + (i == n ? 1.0f : 0.0f) : 0.0f;
    float dd[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dd[r] = rp ? e.D[i * R + r] : 0.0f;
    const float phi_i = rp ? e.phi[i] : 1.0f;
    const float sv = ss && !rp ? (i == n ? xp * e.dom[ij] : e.s[ij]) : 0.0f;
    bool c = under_limit & (tot_i < wanted_i) & allowed_ij;
#pragma unroll
    for (int r = 0; r < R; ++r) c &= td[r] <= free_j[r] + e.eps;
    e.feas[ij] = c ? 1 : 0;
    const int moved = rc + (static_cast<int>(c) - old);
    if (i == n) {
      sh.removed = done ? moved : 0;
      e.rowcnt[n] = done ? 0 : moved;
    } else if (static_cast<int>(c) != old) {
      e.rowcnt[i] = moved;
    }
    colsum += c ? 1 : 0;
    if (rp) {
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] += x * dd[r];
      if (i == t) {
        pre_t = (tot_i + la) / phi_i;
        c_t = c;
#pragma unroll
        for (int r = 0; r < R; ++r) d_t[r] = dd[r];
      }
    } else if (ss) {
      if (i == n) e.s[ij] = sv;
      mn = fminf(mn, masked(c, sv));
      if (i == t) kept.col = masked(c, sv);
    }
  }
  // row n, four cells a thread, from the loads made above
  if (ss || done) {
    if (qa < J4) row_group(e, n, j, qa, fa, da, done, ss, xp, mn, kept.row);
    if (qb < J4) {
      row_group(e, n, j, qb, fb, db, done, ss, xp, mn, kept.row + 4);
    }
    const unsigned* f4 = reinterpret_cast<const unsigned*>(e.feas + nJ);
    const float4* dom4 = reinterpret_cast<const float4*>(e.dom + nJ);
    for (int q4 = qb + kThreads; q4 < J4; q4 += kThreads) {
      row_group(e, n, j, q4, f4[q4], ss ? dom4[q4] : zero4(), done, ss, xp,
                mn);
    }
  }
  // one barrier joins the column sums (and the minimum, but for rPS-DSF)
  own = mn;
  colsum = warp_sum_i(colsum);
  mn = warp_min(mn);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (rp) part[r] = warp_sum(part[r]);
  }
  const int w = t >> 5, lane = t & 31;
  if (lane == 0) {
    sh.gi[w] = colsum;
    sh.gf[kMaxR * kWarps + w] = mn;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (rp) sh.gf[r * kWarps + w] = part[r];
    }
  }
  __syncthreads();
  const bool part_of = lane < kWarps;
  colsum = warp_sum_i(part_of ? sh.gi[lane] : 0);
  mn = warp_min(part_of ? sh.gf[kMaxR * kWarps + lane] : kBig);
  float capj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    capj[r] = rp ? c_j[r] - warp_sum(part_of ? sh.gf[r * kWarps + lane] : 0.0f)
                 : 0.0f;
  }
  if (t == 0) {
    e.X[(size_t)n * J + j] = x_nj + 1.0f;
    e.tot[n] = tot_n;
#pragma unroll
    for (int r = 0; r < R; ++r) e.FREE[j * R + r] = free_j[r];
    e.used[j] = used_j;
    e.ns[k] = n;
    e.js[k] = j;
    sh.total += colsum - colcnt_j - sh.removed;
    e.colcnt[j] = colsum;
    if (e.kind == kDrf) {
      e.s[n] = (tot_n + la) * aux_n / e.phi[n];
    } else if (e.kind == kTsf) {
      e.s[n] = (tot_n + la) / aux_n;
    } else if (rp) {
#pragma unroll
      for (int r = 0; r < R; ++r) e.cap[j * R + r] = capj[r];
    }
  }
  if (rp) {  // residual column j: dominant shares and scores, (n, j) too
    float cm = kBig;
    for (int i = t; i < N; i += kThreads) {
      const size_t ij = (size_t)i * J + j;
      // the first cell from registers; the others (N > kThreads) reloaded,
      // the mask byte being this thread's own write above
      const bool first = i == t;
      const float pre = first ? pre_t
                              : ((i == n ? tot_n : e.tot[i]) + la) / e.phi[i];
      const bool f = first ? c_t : e.feas[ij] != 0;
      float d = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dr = first ? d_t[r] : e.D[i * R + r];
        const float safe = capj[r] > 1e-12f ? capj[r] : 1e-30f;
        float frac = dr / safe;
        if (capj[r] <= 1e-12f && dr > 0.0f) frac = kBig;
        d = r == 0 ? frac : fmaxf(d, frac);
      }
      e.dom[ij] = d;
      const float v = pre * d;
      e.s[ij] = v;
      cm = fminf(cm, masked(f, v));
      if (first) kept.col = masked(f, v);
    }
    own = fminf(own, cm);
    if (want_min) {
      cm = warp_min(cm);
      if (lane == 0) sh.gm[w] = cm;
      __syncthreads();
      mn = fminf(mn, warp_min(part_of ? sh.gm[lane] : kBig));
    }
  }
  return mn;
}

// -- the grid shape: pooled PS-DSF / rPS-DSF ------------------------------

__device__ __forceinline__ unsigned long long pack_pick(int flat, float v) {
  return (static_cast<unsigned long long>(flat) << 32) | __float_as_uint(v);
}

// The masked scores of float4 group g, read through L2.
__device__ __forceinline__ float4 load_masked(const Epoch& e, int g) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(e.s) + g);
  const unsigned f = __ldcg(reinterpret_cast<const unsigned*>(e.feas) + g);
  return make_float4(masked(f & 0x000000ffu, v.x),
                     masked(f & 0x0000ff00u, v.y),
                     masked(f & 0x00ff0000u, v.z),
                     masked(f & 0xff000000u, v.w));
}

// A select block's slice: the float4 groups [lo, hi), thread t owning lo +
// t, lo + t + kThreads, ...  With `cache` their masked scores stay in
// shared memory from grant to grant, and only the cells the last grant
// wrote are read again; without it (a slice too large for shared memory)
// every pick streams them from L2.
struct Slice {
  int lo, hi;
  float4* cache;
};

__device__ __forceinline__ float4 slice_group(const Epoch& e,
                                              const Slice& sl, int g) {
  return sl.cache ? sl.cache[g - sl.lo] : load_masked(e, g);
}

// Masked scores m of group g with row n and column j at kBig (the granting
// block's, changing under this one).
__device__ __forceinline__ void held_out(int g, const float4& v, int n, int j,
                                         int J4, float m[4]) {
  const int row = g / J4;
  const bool other = row != n;
  const int lj = j - 4 * (g - row * J4);  // column j's lane, if 0..3
  m[0] = other && lj != 0 ? v.x : kBig;
  m[1] = other && lj != 1 ? v.y : kBig;
  m[2] = other && lj != 2 ? v.z : kBig;
  m[3] = other && lj != 3 ? v.w : kBig;
}

// The cache from global memory: every group of the slice (at the start of
// a launch) or those of row n and column j (the last grant's, which block
// 0 wrote before the last barrier).  Ends with a barrier.
__device__ void cache_fill(const Epoch& e, const Slice& sl) {
  for (int g = sl.lo + threadIdx.x; g < sl.hi; g += kThreads) {
    sl.cache[g - sl.lo] = load_masked(e, g);
  }
  __syncthreads();
}

__device__ void cache_refresh(const Epoch& e, const Slice& sl, int n, int j) {
  const int J4 = e.J >> 2;
  const int r0 = max(n * J4, sl.lo), r1 = min((n + 1) * J4, sl.hi);
  for (int g = r0 + threadIdx.x; g < r1; g += kThreads) {
    sl.cache[g - sl.lo] = load_masked(e, g);
  }
  // column j's cells i * J + j, in groups i * J4 + j / 4 of the slice
  const int jg = j >> 2;
  const int i0 = max(0, (sl.lo - jg + J4 - 1) / J4);
  float* lanes = reinterpret_cast<float*>(sl.cache);
  for (int i = i0 + threadIdx.x; i * J4 + jg < sl.hi; i += kThreads) {
    const size_t ij = (size_t)i * e.J + j;
    lanes[4 * (i * J4 + jg - sl.lo) + (j & 3)] =
        masked(__ldcg(e.feas + ij) != 0, __ldcg(e.s + ij));
  }
  __syncthreads();
}

// A select block's part of a pick over its slice, row n and column j left
// out: -> the block's least masked score `least` (every thread), in `lm`
// this thread's, and (every thread) pack_pick of the first cell whose score
// is <= threshold(least) -- kNone if the slice is empty.  The first
// kUnroll groups of a thread stay in registers between the two passes.
__device__ unsigned long long slice_part(const Epoch& e, Shared& sh,
                                         const Slice& sl, int n, int j,
                                         float& least, float& lm) {
  const int J4 = e.J >> 2, g0 = sl.lo + threadIdx.x, hi = sl.hi;
  constexpr int kStep = kUnroll * kThreads;
  float4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {  // every load first
    const int g = g0 + u * kThreads;
    if (g < hi) v[u] = slice_group(e, sl, g);
  }
  lm = kBig;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int g = g0 + u * kThreads;
    if (g < hi) {
      float m[4];
      held_out(g, v[u], n, j, J4, m);
      lm = fminf(lm, fminf(fminf(m[0], m[1]), fminf(m[2], m[3])));
    }
  }
  for (int gb = g0 + kStep; gb < hi; gb += kStep) {  // larger slices
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = gb + u * kThreads;
      if (g < hi) {
        float m[4];
        held_out(g, slice_group(e, sl, g), n, j, J4, m);
        lm = fminf(lm, fminf(fminf(m[0], m[1]), fminf(m[2], m[3])));
      }
    }
  }
  least = block_min(lm, sh);
  const float thr = threshold(least);
  unsigned long long mine = kNone;
  if (lm <= thr) {  // this thread's first cell within the tolerance
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = g0 + u * kThreads;
      if (mine == kNone && g < hi) {
        float m[4];
        held_out(g, v[u], n, j, J4, m);
        for (int l = 0; l < 4; ++l) {
          if (mine == kNone && m[l] <= thr) mine = pack_pick(4 * g + l, m[l]);
        }
      }
    }
    for (int gb = g0 + kStep; mine == kNone && gb < hi; gb += kThreads) {
      float m[4];
      held_out(gb, slice_group(e, sl, gb), n, j, J4, m);
      for (int l = 0; l < 4; ++l) {
        if (mine == kNone && m[l] <= thr) mine = pack_pick(4 * gb + l, m[l]);
      }
    }
  }
  return block_min_u64(mine, sh);
}

// The first cell among this thread's of a select block (as slice_part)
// whose masked score is <= thr, kIBig if none: the near-tie round.
__device__ int slice_first(const Epoch& e, const Slice& sl, int n, int j,
                           float thr) {
  const int J4 = e.J >> 2;
  for (int g = sl.lo + threadIdx.x; g < sl.hi; g += kThreads) {
    float m[4];
    held_out(g, slice_group(e, sl, g), n, j, J4, m);
    for (int l = 0; l < 4; ++l) {
      if (m[l] <= thr) return 4 * g + l;
    }
  }
  return kIBig;
}

// pack_pick of the first cell among this thread's of row n (groups of four
// q4 = t, t + kThreads, ...; column j's cell left to the column) and column
// j (i = t, ...) whose masked score is <= thr, kNone if none: block 0's
// part.  The grant left the first of them in `kept`; the others (J > 8 x
// kThreads, N > kThreads) are read again from what block 0 wrote.
__device__ unsigned long long rowcol_first(const Epoch& e, int n, int j,
                                           float thr, const Kept& kept) {
  const int J = e.J, J4 = J >> 2, t = threadIdx.x;
  unsigned long long first = kNone;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int q4 = t + u * kThreads;
    for (int l = 0; l < 4; ++l) {
      const float m = kept.row[4 * u + l];
      if (first == kNone && q4 < J4 && m <= thr) {
        first = pack_pick(n * J + 4 * q4 + l, m);
      }
    }
  }
  const float4* s4 = reinterpret_cast<const float4*>(e.s + (size_t)n * J);
  const unsigned* f4 =
      reinterpret_cast<const unsigned*>(e.feas + (size_t)n * J);
  for (int q4 = t + 2 * kThreads; q4 < J4 && first == kNone;
       q4 += kThreads) {
    const float4 v = s4[q4];
    const unsigned fu = f4[q4];
    const float m[4] = {masked(fu & 0x000000ffu, v.x),
                        masked(fu & 0x0000ff00u, v.y),
                        masked(fu & 0x00ff0000u, v.z),
                        masked(fu & 0xff000000u, v.w)};
    for (int l = 0; l < 4; ++l) {
      if (first == kNone && 4 * q4 + l != j && m[l] <= thr) {
        first = pack_pick(n * J + 4 * q4 + l, m[l]);
      }
    }
  }
  for (int i = t; i < e.N; i += kThreads) {
    const size_t ij = (size_t)i * J + j;
    const float m = i == t ? kept.col : masked(e.feas[ij] != 0, e.s[ij]);
    if (m <= thr) {
      const unsigned long long c = pack_pick(i * J + j, m);
      first = c < first ? c : first;
      break;
    }
  }
  return first;
}

// After the barrier: the pick from every block's slot, in every thread of
// the block.  Warp 0 copies the slots (one load a lane a 32 blocks), takes
// the least score m over all parts, and the least first index among the
// parts whose least score is <= thr = threshold(m).  A part's first index
// is the first within ITS tolerance; it is the first within thr when its
// score is <= thr (thr <= its threshold), and otherwise (two near-tied
// parts) the pick is redone in a near-tie round.
__device__ void pick(const Slot* slots, Shared& sh) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    unsigned least = kFull;
    for (int b = lane; b < gridDim.x; b += 32) {
      const uint4 s = __ldcg(reinterpret_cast<const uint4*>(slots + b));
      sh.slots[b] = s;
      least = min(least, s.x);
    }
    for (int o = 16; o > 0; o >>= 1) {
      least = min(least, __shfl_xor_sync(kFull, least, o));
    }
    const float thr = threshold(from_ordered(least));
    int first = kIBig;
    bool near_tie = false;
    for (int b = lane; b < gridDim.x; b += 32) {
      const uint4 s = sh.slots[b];  // this lane's own copy
      if (from_ordered(s.x) <= thr && s.y != static_cast<unsigned>(kIBig)) {
        first = min(first, static_cast<int>(s.y));
        near_tie |= !(__uint_as_float(s.z) <= thr);
      }
    }
    first = warp_min_i(first);
    near_tie = __any_sync(kFull, near_tie);
    if (lane == 0) {
      sh.pick = first;
      sh.near_tie = near_tie;
      sh.thr = thr;
      sh.picked_total = static_cast<int>(sh.slots[0].w);
    }
  }
  __syncthreads();
}

// kProf: thread 0 of blocks 0 and 1 writes the per-phase profile.
template <int R, bool kProf>
__device__ void run_grid(const Epoch& e, Shared& sh) {
  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x, t = threadIdx.x, G = gridDim.x;
  init_counts(e);
  grid.sync();
  const int total0 = count_total(e, sh);
  if (t == 0) sh.total = total0;
  // blocks 1.. own contiguous slices of the float4 groups, cached in
  // shared memory where the launch gave it (e.cached)
  extern __shared__ float4 slice_cache[];
  const int n4 = (e.N * e.J) >> 2, nb = G - 1;
  const int per = (n4 + nb - 1) / nb;
  const int lo = min((b - 1) * per, n4);
  const Slice sl{lo, min(lo + per, n4), e.cached ? slice_cache : nullptr};
  if (b > 0 && sl.cache) cache_fill(e, sl);
  Slot* slots[2] = {reinterpret_cast<Slot*>(e.sync),
                    reinterpret_cast<Slot*>(e.sync) + G};
  int* near = reinterpret_cast<int*>(e.sync + 8 * G);
  // the per-phase profile: thread 0 of blocks 0 and 1, SM clock cycles
  const bool timed = kProf && t == 0 && b < 2;
  long long acc[4] = {0, 0, 0, 0}, start = timed ? clock64() : 0;
  int count = 0, n = -1, j = -1;  // (n, j): picked, not yet applied
  int pn = -1, pj = -1;             // the grant applied in the last loop
  for (;;) {
    const long long t0 = timed ? clock64() : 0;
    // phase 1: block 0 grants, the others take their slices; each block
    // publishes its part of the next pick
    float lm = kBig;  // this thread's least cell: its slice, or row / column
    Kept kept;        // block 0: this thread's row and column scores
    Slot mine{ordered_bits(kBig), static_cast<unsigned>(kIBig),
              __float_as_uint(kBig), 0u};
    if (b == 0) {
      if (n >= 0) {
        const float least = grant<R>(e, sh, n, j, count - 1, true, lm, kept);
        const float thr = threshold(least);
        const unsigned long long first = block_min_u64(
            lm <= thr ? rowcol_first(e, n, j, thr, kept) : kNone, sh);
        mine.least = ordered_bits(least);
        if (first != kNone) {
          mine.first = static_cast<unsigned>(first >> 32);
          mine.score = static_cast<unsigned>(first);
        }
      }
      mine.total = static_cast<unsigned>(sh.total);
    } else {
      float least;
      if (sl.cache && pn >= 0) cache_refresh(e, sl, pn, pj);
      const unsigned long long first =
          slice_part(e, sh, sl, n, j, least, lm);
      mine.least = ordered_bits(least);
      if (first != kNone) {
        mine.first = static_cast<unsigned>(first >> 32);
        mine.score = static_cast<unsigned>(first);
      }
    }
    if (t == 0) slots[count & 1][b] = mine;
    const long long t1 = timed ? clock64() : 0;
    grid.sync();
    const long long t2 = timed ? clock64() : 0;
    pick(slots[count & 1], sh);
    const int total = sh.picked_total;
    if (count == e.max_steps || total == 0) break;
    int flat = sh.pick;
    if (sh.near_tie) {  // every part's first cell within thr, then the least
      const float thr = sh.thr;
      int first = kIBig;
      if (b == 0) {
        if (n >= 0 && lm <= thr) {
          const unsigned long long c = rowcol_first(e, n, j, thr, kept);
          first = c == kNone ? kIBig : static_cast<int>(c >> 32);
        }
      } else if (lm <= thr) {
        first = slice_first(e, sl, n, j, thr);
      }
      first = block_min_i(first, sh);
      if (t == 0) near[b] = first;
      grid.sync();
      int f = kIBig;
      for (int q = t & 31; q < G; q += 32) f = min(f, __ldcg(near + q));
      flat = warp_min_i(f);
      if (timed) ++acc[3];
    }
    pn = n;
    pj = j;
    n = flat / e.J;
    j = flat - n * e.J;
    ++count;
    if (timed) {
      acc[0] += t1 - t0;
      acc[1] += t2 - t1;
      acc[2] += clock64() - t2;
    }
  }
  if (b == 0 && t == 0) {
    e.cnt[0] = count;
    e.cnt[1] = e.pidx0;
    e.cnt[2] = e.pos0;
  }
  if (timed) {
    for (int q = 0; q < 4; ++q) e.prof[5 * b + q] = acc[q];
    e.prof[5 * b + 4] = clock64() - start;
  }
}

// -- the one-block shape: DRF / TSF pooled, and RRR -----------------------

// Tie-low over the N masked values that value(i) gives: -> the first index
// within tolerance of their minimum.
template <typename F>
__device__ int tie_low(int len, F value, Shared& sh) {
  float lm = kBig;
  for (int i = threadIdx.x; i < len; i += kThreads) lm = fminf(lm, value(i));
  const float thr = threshold(block_min(lm, sh));
  int first = kIBig;
  if (lm <= thr) {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      if (value(i) <= thr) {
        first = i;
        break;
      }
    }
  }
  return block_min_i(first, sh);
}

// Pooled DRF / TSF: the framework by tie-low over rows that fit anywhere
// (rowcnt > 0), then its first feasible server.
__device__ void select_rows(const Epoch& e, Shared& sh, int& n, int& j) {
  n = tie_low(
      e.N,
      [&](int i) { return masked(__ldcg(e.rowcnt + i) > 0, e.s[i]); }, sh);
  const int words = e.J >> 2;
  const uint32_t* row =
      reinterpret_cast<const uint32_t*>(e.feas + (size_t)n * e.J);
  int first = kIBig;
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const uint32_t v = row[w];
    if (v != 0u) {
      first = 4 * w + (__ffs(v) - 1) / 8;
      break;
    }
  }
  j = block_min_i(first, sh);
}

// First position k in [from, J) of permutation row `p` whose server has a
// feasible framework (colcnt > 0).
__device__ int first_ok_position(const Epoch& e, int p, int from,
                                 Shared& sh) {
  const int32_t* perm = e.perms + (size_t)min(p, e.K - 1) * e.J;
  int first = kIBig;
  for (int k = from + threadIdx.x; k < e.J; k += kThreads) {
    if (__ldcg(e.colcnt + perm[k]) > 0) {
      first = k;
      break;
    }
  }
  return block_min_i(first, sh);
}

// Randomized round-robin: the round's next server with a feasible
// framework, then the best framework on it.
__device__ void select_rrr(const Epoch& e, Shared& sh, int pidx, int pos,
                           int& n, int& j, int& pidx2, int& pos2) {
  int krank = first_ok_position(e, pidx, pos, sh);
  const bool wrap = krank == kIBig;
  const int p = wrap ? pidx + 1 : pidx;
  if (wrap) krank = first_ok_position(e, p, 0, sh);
  const int jj = e.perms[(size_t)min(p, e.K - 1) * e.J + krank];
  const bool ss = e.kind >= kPsdsf;
  const int J = e.J;
  n = tie_low(
      e.N,
      [&](int i) {
        const size_t ij = (size_t)i * J + jj;
        return masked(e.feas[ij] != 0, ss ? e.s[ij] : e.s[i]);
      },
      sh);
  j = jj;
  const bool last = krank == e.j_real - 1;
  pidx2 = pidx + (wrap ? 1 : 0) + (last ? 1 : 0);
  pos2 = last ? 0 : krank + 1;
}

template <int R>
__device__ void run_block(const Epoch& e, Shared& sh) {
  init_counts(e);
  __syncthreads();
  const int total = count_total(e, sh);
  if (threadIdx.x == 0) sh.total = total;
  __syncthreads();
  int pidx = e.pidx0, pos = e.pos0, count = 0;
  while (count < e.max_steps && sh.total > 0) {
    int n, j, pidx2 = pidx, pos2 = pos;
    if (e.rrr) {
      select_rrr(e, sh, pidx, pos, n, j, pidx2, pos2);
    } else {
      select_rows(e, sh, n, j);
    }
    float own;
    Kept kept;
    grant<R>(e, sh, n, j, count, false, own, kept);
    // every write of this grant (sh.total above all) lands before the
    // next liveness check and select
    __syncthreads();
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

// kProf: the grid shape with its per-phase profile (the host launches it
// only for pooled PS-DSF / rPS-DSF).
template <int R, bool kProf>
__global__ void __launch_bounds__(kThreads, 1) epoch_kernel(Epoch e) {
  __shared__ Shared sh;
  if constexpr (kProf) {
    run_grid<R, true>(e, sh);
  } else if (!e.rrr && e.kind >= kPsdsf) {
    run_grid<R, false>(e, sh);
  } else {
    run_block<R>(e, sh);
  }
}

// The instantiation for R resources, R = 1..kMaxR.
template <int R = 1>
const void* kernel_for(int r, bool prof) {
  if constexpr (R < kMaxR) {
    if (r != R) return kernel_for<R + 1>(r, prof);
  }
  return prof ? reinterpret_cast<const void*>(&epoch_kernel<R, true>)
              : reinterpret_cast<const void*>(&epoch_kernel<R, false>);
}

// The barrier floor: only the grid barriers of `steps` grants, one each.
__global__ void __launch_bounds__(kThreads, 1) barrier_kernel(int steps) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < steps; ++i) grid.sync();
}

// Sets `dev` current, runs launch() -> a cudaError_t, restores the device.
template <typename F>
int on_device(int dev, F launch) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cur != dev && (err = cudaSetDevice(dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = launch();
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  if (err == cudaSuccess) err = last;
  if (cur != dev) cudaSetDevice(cur);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The grid of the pooled PS-DSF shape for R resources: the most blocks
// that can be co-resident (occupancy x SMs, at most kMaxGrid) -> *out,
// for both instantiations at the most shared memory a launch asks for
// (kMaxCache), so that every launch's blocks fit on the card together.
// Returns a cudaError_t.
int epoch_grid_size(int dev, int R, int* out) {
  if (R < 1 || R > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(dev, [&] {
    int coop = 0, sms = 0, fit = kMaxGrid;
    cudaError_t err =
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    for (int prof = 0; prof < 2; ++prof) {
      const void* kernel = kernel_for(R, prof == 1);
      int per_sm = 0;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxCache);
      if (err != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, kMaxCache);
      if (err != cudaSuccess) return err;
      fit = min(fit, per_sm * sms);
    }
    *out = fit;
    return cudaSuccess;
  });
}

// One epoch segment.  `grid` is 1 for DRF / TSF pooled and RRR, and 2 up
// to epoch_grid_size for pooled PS-DSF / rPS-DSF; `sync` holds 9 words a
// block.  `prof`, where not null, runs the profiled instantiation (grid
// shape only), which writes 10 words: for thread 0 of blocks 0 and 1, the
// SM clocks of phase 1, the barrier, and the pick with any near-tie round,
// then the number of near-tie rounds, and the clocks of the whole loop.
// Returns a cudaError_t.
int epoch_persistent_launch(
    const float* D, const float* TD, const float* C, const float* phi,
    const float* wanted, const uint8_t* allowed, const int32_t* perms,
    const float* aux, float* X, float* tot, float* FREE, float* cap,
    float* dom, float* s, uint8_t* feas, int32_t* used, int32_t* ns,
    int32_t* js, int32_t* cnt, int32_t* rowcnt, int32_t* colcnt,
    unsigned* sync, long long* prof, int N, int J, int R, int K, int pidx0,
    int pos0,
    int j_real, int limit, float eps, int kind, int rrr, int lookahead,
    int use_limit, int max_steps, int grid, int dev, void* stream) {
  const bool wide = !rrr && kind >= kPsdsf;
  if (N < 1 || J < 4 || R < 1 || R > kMaxR || (J & 3) != 0 ||
      (wide ? grid < 2 || grid > kMaxGrid : grid != 1 || prof != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a slice's masked scores in shared memory, where they fit
  const long long n4 = (static_cast<long long>(N) * J) >> 2;
  const long long slice = wide ? (n4 + grid - 2) / (grid - 1) * 16 : 0;
  const int smem = slice <= kMaxCache ? static_cast<int>(slice) : 0;
  Epoch e{D,      TD,     C,      phi,       wanted,    allowed, perms,
          aux,    X,      tot,    FREE,      cap,       dom,     s,
          feas,   used,   ns,     js,        cnt,       rowcnt,  colcnt,
          sync,   prof,   N,      J,         R,         K,       pidx0,
          pos0,   j_real, limit,  eps,       kind,      rrr,     lookahead,
          use_limit, max_steps, smem > 0};
  void* args[] = {&e};
  return on_device(dev, [&] {
    const void* kernel = kernel_for(R, prof != nullptr);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    return cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads),
                                       args, smem,
                                       static_cast<cudaStream_t>(stream));
  });
}

// The barrier floor: `steps` grid barriers on `grid` blocks of the same
// size, cooperatively launched.  Returns a cudaError_t.
int epoch_barrier_floor(int steps, int grid, int dev, void* stream) {
  void* args[] = {&steps};
  return on_device(dev, [&] {
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&barrier_kernel), dim3(grid),
        dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  });
}

const char* epoch_persistent_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
