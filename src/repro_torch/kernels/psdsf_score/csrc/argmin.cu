// Masked argmins of the allocation epoch's selects for Hopper (sm_90a), CUDA
// C++: K2 over the (N, J) score matrix and K1 over a score vector, each ONE
// launch that writes its result into outputs the caller keeps.
//
// Replaces the TPU kernels of repro/kernels/psdsf_score/kernel.py:
//   * K2 masked_argmin2d_tiles (pallas_call at :149): the pooled PS-DSF /
//     rPS-DSF select.  The TPU kernel takes the first minimum of each
//     (bn, bj) tile in row-major cell order, then the first tile holding the
//     global minimum in row-major tile order;
//   * K1 masked_argmin1d_tiles (pallas_call at :98): the RRR server visit and
//     the DRF/TSF select, the first minimum of a vector.
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
// The reference's tile rule (the clamped bn, bj and whether the shape is
// padded) is decided by the Python wrapper, which passes log2(bn),
// log2(bj), tj and `pad` (K1 only `pad`); nothing here repeats it.
//
// Bound on the H100: bytes.  K2 reads each score (4 bytes) and mask byte
// once and writes 12 bytes: 10.5 MB at 512 x 4096, 3.13 us at 3.35 TB/s.
// K1 at (512,) reads 2.5 KB, 0.77 ns, far below what any launch costs;
// argmin_noop_launch launches an empty kernel through the same interface,
// so that floor can be measured.
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

__device__ __forceinline__ unsigned tile_key(unsigned n, unsigned j,
                                             const Geom& g) {
  const unsigned t = (n >> g.lbn) * g.tj + (j >> g.lbj);
  return (t << (g.lbn + g.lbj)) | ((n & ((1u << g.lbn) - 1)) << g.lbj) |
         (j & ((1u << g.lbj) - 1));
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
  if (threadIdx.x != 0) return;
  if (best != kNone) atomicMin(&ws->slot, best);
  __threadfence();  // the slot update lands before this block's ticket
  if (atomicAdd(&ws->ticket, 1u) != gridDim.x - 1) return;
  // the last block: every other block's atomicMin is in the slot
  const unsigned long long w = atomicExch(&ws->slot, kNone);
  ws->ticket = 0;
  const float v = from_ordered(static_cast<unsigned>(w >> 32));
  if (feasible_win(v)) {
    const unsigned key = static_cast<unsigned>(w);
    const int cell_bits = g.lbn + g.lbj;
    const unsigned t = key >> cell_bits, cell = key & ((1u << cell_bits) - 1);
    const int n = static_cast<int>((t / g.tj) << g.lbn | (cell >> g.lbj));
    const int j = static_cast<int>((t % g.tj) << g.lbj |
                                   (cell & ((1u << g.lbj) - 1)));
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

// An empty kernel through the same interface: the launch floor.
int argmin_noop_launch(int dev, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return on_device(dev, [&] { noop_kernel<<<1, 32, 0, st>>>(); });
}

const char* argmin_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
