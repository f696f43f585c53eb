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
// pad as +infinity and a pad never matches.
//
// Design. The raw kernel is a block per A-block (sorted_window.cuh): the
// block finds its A-block's window once, stages the part of it that its
// elements can match in shared memory (a sample of it when it is longer
// than the buffer) and each lane searches there; idx is the staged range's
// offset plus the lane's index in it. The compressed kernel is one thread
// per element of a and a lower-bound binary search inside its window; it
// takes the starts that the wrapper planned on the host, as the reference
// does, and decodes every probe in registers, so the int32 form never
// reaches device memory. The TPU kernel's (512 x 1024) broadcast compare
// per grid step is carried over by neither: its work grows with Na times
// the window, which makes the full-scan default quadratic.
//
// What bounds it. On an H100 the function is memory-bound: it reads a and b
// once and writes 5 bytes (raw) or 1 byte (compressed) per element of a,
// against a few dozen integer operations per element. The compressed
// kernel is latency-bound instead: each of the ~log2(window) steps of a
// search is a dependent load, and neighbouring threads repeat nearly the
// same path. The raw kernel's chain is per block: a load, four search
// rounds, a staging copy, shared-memory searches and a store.
//
// Interface. Plain C functions that launch on the caller's stream and return
// cudaGetLastError(); the Python wrappers allocate the outputs, check
// devices, types, shapes and sizes, and raise when the code is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_window.cuh"

namespace {

constexpr unsigned kPadDelta = 65535;
constexpr long long kPadKey = 1LL << 40;  // a decoded pad slot: above every int32
constexpr int kThreads = 256;

// [w_lo, w_hi): the b-elements the TPU kernel's clamped index map visits for
// an A-block whose window starts at b-block `start`, cut to the nb elements.
__device__ __forceinline__ void window(long long start, int nbb, int k_tiles, int block_b,
                                       int nb, int* w_lo, int* w_hi) {
  const long long last = nbb - 1;
  const long long lo_blk = min(start, last);
  const long long hi_blk = min(start + k_tiles - 1, last);
  *w_lo = static_cast<int>(lo_blk * block_b);
  *w_hi = static_cast<int>(min((hi_blk + 1) * block_b, static_cast<long long>(nb)));
}

namespace sw = sorted_window;

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
    sw::range_bounds(r, b, x, at);
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      hit[i] = x[i] != sw::kSentinel && at[i] < r.n && r.value(b, at[i]) == x[i];
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

// Element j of a delta16 stream: base + delta in int32 arithmetic (wrapping
// as the reference's does), a pad slot as kPadKey.
__device__ __forceinline__ long long decode(const int* __restrict__ base,
                                            const uint16_t* __restrict__ delta, int j) {
  const unsigned d = __ldg(delta + j);
  if (d == kPadDelta) return kPadKey;
  return static_cast<int>(static_cast<unsigned>(__ldg(base + (j >> 6))) + d);
}

__global__ void __launch_bounds__(kThreads) intersect_compressed_kernel(
    const int* __restrict__ a_base, const uint16_t* __restrict__ a_delta,
    const int* __restrict__ b_base, const uint16_t* __restrict__ b_delta,
    const int* __restrict__ starts, uint8_t* __restrict__ mask, int na, int lb, int block_a,
    int block_b, int k_tiles) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= na) return;
  const long long x = decode(a_base, a_delta, i);
  bool hit = false;
  if (x != kPadKey) {
    int w_lo, w_hi;
    window(__ldg(starts + i / block_a), lb / block_b, k_tiles, block_b, lb, &w_lo, &w_hi);
    while (w_lo < w_hi) {
      const int mid = w_lo + ((w_hi - w_lo) >> 1);
      const long long v = decode(b_base, b_delta, mid);
      if (v < x) {
        w_lo = mid + 1;
      } else if (v == x) {
        hit = true;
        break;
      } else {
        w_hi = mid;
      }
    }
  }
  mask[i] = hit ? 1 : 0;
}

inline unsigned blocks_for(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int intersect_raw(const int* a, const int* b, uint8_t* mask, int* idx, int na,
                             int nb, int block_a, int block_b, int k_tiles, void* stream) {
  auto go = sw::sparse_a(na, nb) ? launch_raw<1> : launch_raw<4>;
  return go(a, b, mask, idx, na, nb, block_a, block_b, k_tiles,
            static_cast<cudaStream_t>(stream));
}

extern "C" int intersect_compressed(const int* a_base, const uint16_t* a_delta,
                                    const int* b_base, const uint16_t* b_delta,
                                    const int* starts, uint8_t* mask, int na, int lb,
                                    int block_a, int block_b, int k_tiles, void* stream) {
  intersect_compressed_kernel<<<blocks_for(na), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      a_base, a_delta, b_base, b_delta, starts, mask, na, lb, block_a, block_b, k_tiles);
  return static_cast<int>(cudaGetLastError());
}
