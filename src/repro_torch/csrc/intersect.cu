// Windowed sorted-list intersection (the paper's Equalize) for Hopper (sm_90a),
// raw int32 and delta16-compressed streams.
//
// Replaces two TPU kernels of src/repro/kernels/intersect/intersect.py:
// intersect_pallas (pallas_call at :153, body _kernel at :32) and
// intersect_pallas_compressed (pallas_call at :106, body _kernel_compressed
// at :58). It computes what intersect_plain and intersect_compressed_plain in
// src/repro_torch/kernels/intersect/ops.py compute, exactly, on every lane.
//
// Function. Element i of sorted a lies in A-block i / block_a. That block
// searches only the b-blocks min(start + k, nbb - 1), k in [0, k_tiles), of
// b cut into nbb blocks of block_b: start is the b-block that holds the lower
// bound of the A-block's first element. The raw kernel writes mask[i] (a[i]
// is in the window and is not SENTINEL) and idx[i], the first matching
// position in the window or -1. The compressed kernel writes the mask only;
// its streams are int32 bases, one per 64 postings, plus uint16 in-block
// deltas, PAD_DELTA marking a pad slot. A pad slot decodes to base + 65535,
// which need not be sorted (a pad block's base is 0), so the search reads a
// pad as +infinity and a pad never matches; so read, the decoded b must be
// sorted, as the reference's packer leaves sorted postings. The decoded a
// need not be: its pads may sit anywhere, and each tile rests on the min
// and max of its live elements.
//
// Design. Both kernels are a block per tile of one A-block
// (sorted_window.cuh): the block finds the part of its A-block's window that
// its elements can match, stages it in shared memory (a sample of it when
// it is longer than the buffer) and each lane searches there.
// - The raw kernel finds the window itself, by warp searches over all of b
//   for the lower bound of the A-block's first element; idx is the staged
//   range's offset plus the lane's index in it.
// - The compressed kernel takes the window from the starts that the wrapper
//   planned, as given (a truncated k_tiles truncates the answer, as in the
//   reference), with one load, and decodes its tile in registers (base +
//   delta); its tiles are 512, 256 or 128 elements, the smaller where a is
//   the sparser against b. A window of at most kCap slots (qt1_heavy's two b-blocks) is
//   staged whole right away, with no block-wide step before it. A longer
//   one is cut first: the tile's live elements (not pads) reduce to min
//   and max, and two warps find, among the window's 64-block starts (a
//   free 1/64 sample of b, probed through BlockStarts, an all-pad block,
//   whose base is 0, reading +infinity), the 64-blocks that hold the lower
//   bounds of min and of max + 1; the blocks between are staged. Staging
//   decodes each 64-block once into shared memory, each 8-slot chunk from
//   one 16-byte load of deltas and the block's base, a pad as INT_MAX (a
//   lane's INT_MAX confirms its hit in device memory). A range longer than
//   the buffer (a rare a against a frequent b, or a full scan) stages the
//   first slot of every stride-th 64-block instead, stride a multiple of
//   64: each lane then finishes inside one 64-block in device memory, one
//   128-byte line of deltas. The int32 form of the streams never reaches
//   device memory.
// The TPU kernels' (512 x 1024) broadcast compare per grid step is carried
// over by neither: its work grows with Na times the window, which makes the
// full-scan default quadratic.
//
// What bounds it. On an H100 the function is memory-bound: it reads a and b
// once (4 bytes per raw posting, 2.06 per compressed one) and writes 5
// bytes (raw) or 1 byte (compressed) per element of a, against a few dozen
// integer operations per element. Both kernels are bound by each block's
// chain of dependent steps instead: for the raw kernel a load, four search
// rounds over all of b, a staging copy, shared-memory searches and a
// store; for the compressed one at qt1_heavy a load, the staging copy,
// the searches and a store (one search round more, over the block starts,
// where the window is longer than the buffer).
//
// Interface. Plain C functions that launch on the caller's stream and return
// cudaGetLastError(); the Python wrappers allocate the outputs, check
// devices, types, shapes and sizes, and raise when the code is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_window.cuh"

namespace {

namespace sw = sorted_window;

constexpr unsigned kPadDelta = 65535;
constexpr long long kPadKey = 1LL << 40;  // a decoded pad slot: above every int32
constexpr int kBatch = 4;                 // chunks a thread stages per round trip

template <int LANES>
__global__ void __launch_bounds__(sw::kThreads, sw::kMinBlocks) intersect_raw_kernel(
    const int* __restrict__ a, const int* __restrict__ b, uint8_t* __restrict__ mask,
    int* __restrict__ idx, int na, int nb, int block_a, int block_b, int k_tiles) {
  __shared__ sw::Shared sh;
  const sw::Tile t = sw::tile_of<LANES>(na, block_a);
  int x[LANES], at[LANES];
  sw::load_tile(a, t, x);
  sw::Range r;
  bool hit[LANES] = {};
  if (sw::stage_range(a, b, nb, 0, block_b, k_tiles, t, x, sh, r)) {
    const sw::Ints row{b};
    sw::range_bounds(r, row, x, at);
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      hit[i] = x[i] != sw::kSentinel && at[i] < r.n && r.value(row, at[i]) == x[i];
    }
  }
#pragma unroll
  for (int i = 0; i < LANES; ++i) {
    const long long g = t.begin + threadIdx.x + i * sw::kThreads;
    if (g < t.end) {
      mask[g] = hit[i] ? 1 : 0;
      idx[g] = hit[i] ? r.lo + at[i] : -1;
    }
  }
}

template <int LANES>
int launch_raw(const int* a, const int* b, uint8_t* mask, int* idx, int na, int nb,
               int block_a, int block_b, int k_tiles, cudaStream_t stream) {
  const unsigned blocks = sw::grid_blocks(na, block_a, sw::kThreads * LANES);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  intersect_raw_kernel<LANES><<<blocks, sw::kThreads, 0, stream>>>(a, b, mask, idx, na, nb,
                                                                  block_a, block_b, k_tiles);
  return static_cast<int>(cudaGetLastError());
}

// A delta16 stream as the row a search reads: element j is base[j / 64] +
// delta[j] in int32 arithmetic (wrapping as the reference's does), a pad
// slot kPadKey. Sorted wherever the stream is well formed: its real values
// in order, then pad slots only.
struct Delta16 {
  using Key = long long;
  static constexpr long long kTop = kPadKey;
  const int* base;
  const uint16_t* delta;
  __device__ __forceinline__ long long operator()(int j) const {
    const unsigned d = __ldg(delta + j);
    const int v = static_cast<int>(static_cast<unsigned>(__ldg(base + (j >> 6))) + d);
    return d == kPadDelta ? kPadKey : v;
  }
};

// The first slot of each 64-block of a delta16 stream, as a row: a free
// 1/64 sample of it (an all-pad block, whose base is 0, reads +infinity).
struct BlockStarts {
  using Key = long long;
  static constexpr long long kTop = kPadKey;
  Delta16 b;
  __device__ __forceinline__ long long operator()(int j) const { return b(j * 64); }
};

// A slot as a staged int32 key: a pad reads INT_MAX, above every key but
// INT_MAX itself, which a hit then confirms in device memory.
__device__ __forceinline__ int slot(unsigned base, unsigned d) {
  return d == kPadDelta ? INT_MAX : static_cast<int>(base + d);
}

__device__ __forceinline__ int4 decode4(unsigned base, unsigned lo, unsigned hi) {
  return make_int4(slot(base, lo & 0xffffu), slot(base, lo >> 16), slot(base, hi & 0xffffu),
                   slot(base, hi >> 16));
}

// Stages the whole 64-blocks b[lo, hi) (lo, hi multiples of 64) in shared
// memory, each decoded once: 8 slots from one 16-byte load of deltas
// (where the stream is 16-byte aligned; else slot by slot) and the
// block's base, a thread's kBatch chunks loaded before any is decoded, so
// a range costs one round trip. A range longer than kCap stages instead
// the first slot of every stride-th 64-block (stride a multiple of 64);
// those lie below the range's end, so they are real values. Block-uniform;
// every thread of the block must call it.
__device__ __forceinline__ void stage_blocks(const Delta16& b, int lo, int hi, sw::Shared& sh,
                                             sw::Range& r) {
  r.lo = lo;
  r.n = hi - lo;
  r.stride = r.n <= sw::kCap ? 1 : 64 * ((r.n + 64 * sw::kCap - 1) / (64 * sw::kCap));
  r.m = (r.n + r.stride - 1) / r.stride;
  r.s = sh.buf;
  if (r.stride == 1) {
    const int chunks = r.n >> 3;
    const bool vec = (reinterpret_cast<uintptr_t>(b.delta) & 15) == 0;
    for (int j0 = threadIdx.x; j0 < chunks; j0 += kBatch * sw::kThreads) {
      uint4 d[kBatch];
      unsigned base[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = lo + 8 * (j0 + u * sw::kThreads);
        if (vec && j0 + u * sw::kThreads < chunks) {
          d[u] = __ldg(reinterpret_cast<const uint4*>(b.delta + g));
          base[u] = static_cast<unsigned>(__ldg(b.base + (g >> 6)));
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * sw::kThreads;
        if (j >= chunks) break;
        const int g = lo + 8 * j;
        int* dst = sh.buf + 8 * j;
        if (vec) {
          reinterpret_cast<int4*>(dst)[0] = decode4(base[u], d[u].x, d[u].y);
          reinterpret_cast<int4*>(dst)[1] = decode4(base[u], d[u].z, d[u].w);
        } else {
          const unsigned bs = static_cast<unsigned>(__ldg(b.base + (g >> 6)));
          for (int e = 0; e < 8; ++e) dst[e] = slot(bs, __ldg(b.delta + g + e));
        }
      }
    }
  } else {
    for (int j0 = threadIdx.x; j0 < r.m; j0 += kBatch * sw::kThreads) {
      int v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * sw::kThreads;
        if (j < r.m) v[u] = static_cast<int>(b(lo + j * r.stride));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * sw::kThreads;
        if (j < r.m) sh.buf[j] = v[u];
      }
    }
  }
  __syncthreads();
}

template <int LANES>
__global__ void __launch_bounds__(sw::kThreads, sw::kMinBlocks) intersect_compressed_kernel(
    const int* __restrict__ a_base, const uint16_t* __restrict__ a_delta,
    const int* __restrict__ b_base, const uint16_t* __restrict__ b_delta,
    const int* __restrict__ starts, uint8_t* __restrict__ mask, int na, int lb, int block_a,
    int block_b, int k_tiles) {
  __shared__ sw::Shared sh;
  const sw::Tile t = sw::tile_of<LANES>(na, block_a);
  const Delta16 b{b_base, b_delta};
  int w_lo, w_hi;  // whole 64-blocks: block_b and lb are multiples of 64
  sw::window_of(__ldg(starts + t.a0 / block_a), lb, block_b, k_tiles, w_lo, w_hi);
  int x[LANES];
  bool live[LANES];
#pragma unroll
  for (int i = 0; i < LANES; ++i) {
    const long long g = t.begin + threadIdx.x + i * sw::kThreads;
    unsigned d = kPadDelta, base = 0;
    if (g < t.end) {
      d = __ldg(a_delta + g);
      base = static_cast<unsigned>(__ldg(a_base + (g >> 6)));
    }
    live[i] = d != kPadDelta;
    x[i] = static_cast<int>(base + d);
  }
  sw::Range r;
  if (w_hi - w_lo <= sw::kCap) {  // block-uniform: stage the whole window
    stage_blocks(b, w_lo, w_hi, sh, r);
  } else {
    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      if (live[i]) {
        mn = min(mn, x[i]);
        mx = max(mx, x[i]);
      }
    }
    sw::block_min_max(mn, mx, sh);
    // every key a live lane searches for lies in [mn, mx + 1): its lower
    // bound lies in the 64-blocks from the one before the first block
    // starting at or above mn up to the first starting at or above mx + 1
    const int warp = threadIdx.x >> 5;
    if (mn <= mx && warp < 2) {
      const long long key = warp == 0 ? mn : mx + 1LL;
      const int j = sw::warp_lower_bound(BlockStarts{b}, w_lo / 64, w_hi / 64, key);
      if ((threadIdx.x & 31) == 0) sh.pos[warp] = warp == 0 ? max(j - 1, w_lo / 64) : j;
    }
    __syncthreads();
    const int lo = mn <= mx ? 64 * sh.pos[0] : w_lo;
    stage_blocks(b, lo, mn <= mx ? max(64 * sh.pos[1], lo) : lo, sh, r);
  }
  int at[LANES];
  sw::range_bounds(r, b, x, at);
  bool hit[LANES];
#pragma unroll
  for (int i = 0; i < LANES; ++i) {
    hit[i] = live[i] && at[i] < r.n && r.value(b, at[i]) == x[i] &&
             (x[i] != INT_MAX || b(r.lo + at[i]) == x[i]);
  }
#pragma unroll
  for (int i = 0; i < LANES; ++i) {
    const long long g = t.begin + threadIdx.x + i * sw::kThreads;
    if (g < t.end) mask[g] = hit[i] ? 1 : 0;
  }
}

template <int LANES>
int launch_compressed(const int* a_base, const uint16_t* a_delta, const int* b_base,
                      const uint16_t* b_delta, const int* starts, uint8_t* mask, int na, int lb,
                      int block_a, int block_b, int k_tiles, cudaStream_t stream) {
  const unsigned blocks = sw::grid_blocks(na, block_a, sw::kThreads * LANES);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  intersect_compressed_kernel<LANES><<<blocks, sw::kThreads, 0, stream>>>(
      a_base, a_delta, b_base, b_delta, starts, mask, na, lb, block_a, block_b, k_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int intersect_raw(const int* a, const int* b, uint8_t* mask, int* idx, int na,
                             int nb, int block_a, int block_b, int k_tiles, void* stream) {
  auto go = sw::sparse_a(na, nb) ? launch_raw<1> : launch_raw<4>;
  return go(a, b, mask, idx, na, nb, block_a, block_b, k_tiles,
            static_cast<cudaStream_t>(stream));
}

// Lanes per thread of the compressed kernel: as sparse_a chooses, but 2
// (256-element tiles) where a 512-element tile of evenly spread a would
// need more than half the buffer: kernel_bench's 131,072 against
// 1,048,576 then runs 504 blocks, where 252 left most SMs one block.
extern "C" int intersect_compressed(const int* a_base, const uint16_t* a_delta,
                                    const int* b_base, const uint16_t* b_delta,
                                    const int* starts, uint8_t* mask, int na, int lb,
                                    int block_a, int block_b, int k_tiles, void* stream) {
  const bool half = static_cast<long long>(8 * sw::kThreads) * lb >
                    static_cast<long long>(sw::kCap) * na;
  auto go = sw::sparse_a(na, lb) ? launch_compressed<1>
            : half               ? launch_compressed<2>
                                 : launch_compressed<4>;
  return go(a_base, a_delta, b_base, b_delta, starts, mask, na, lb, block_a, block_b, k_tiles,
            static_cast<cudaStream_t>(stream));
}
