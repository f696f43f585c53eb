// Proximity window join |a - b| <= d for Hopper (sm_90a).
//
// Replaces the TPU kernel proximity_pallas of
// src/repro/kernels/proximity/proximity.py (pallas_call at :69, body _kernel
// at :29). It computes what proximity_plain in
// src/repro_torch/kernels/proximity/ops.py computes, exactly, on every lane.
//
// Function. Element i of sorted a lies in A-block i / block_a. That block
// searches only the b-blocks min(start + k, nbb - 1), k in [0, k_tiles), of
// b cut into nbb blocks of block_b: start is the b-block that holds the lower
// bound of (the A-block's first element - d). For a[i] != SENTINEL, the
// window's b-values within d of a[i], SENTINEL excluded, form one run; the
// kernel writes whether it is empty, and its least and greatest value (a[i]
// itself where the run is empty, as proximity_join sets them after the TPU
// kernel). Distances are taken in 64 bits: the TPU kernel's int32 a - b can
// wrap, hidden only by its masks.
//
// Design. A block per A-block (sorted_window.cuh): the block finds its
// A-block's window once, stages the part of it that its elements can reach
// in shared memory (a sample of it when it is longer than the buffer), and
// each lane runs its two lower bounds there, for a - d and for
// min(a + d, SENTINEL - 1) + 1, and reads the run's ends from there. A
// negative d gives every lane an empty run and stages nothing. The TPU
// kernel's (512 x 1024) broadcast compare per grid step is not carried
// over: its work grows with Na times the window.
//
// What bounds it. On an H100 the function is memory-bound: it reads a and b
// once and writes 9 bytes per element of a. The kernel is bound by each
// block's chain of dependent steps instead: a load, four search rounds, a
// staging copy, shared-memory searches and a store.
//
// Interface. A plain C function that launches on the caller's stream and
// returns cudaGetLastError(); the Python wrapper allocates the outputs,
// checks devices, types, shapes and sizes, and raises when the code is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_window.cuh"

namespace {

namespace sw = sorted_window;

template <int LANES>
__global__ void __launch_bounds__(sw::kThreads, sw::kMinBlocks) proximity_kernel(
    const int* __restrict__ a, const int* __restrict__ b, uint8_t* __restrict__ mask,
    int* __restrict__ lo_out, int* __restrict__ hi_out, int na, int nb, int d, int block_a,
    int block_b, int k_tiles) {
  __shared__ sw::Shared sh;
  const sw::Tile t = sw::tile_of<LANES>(na, block_a);
  int x[LANES], lo[LANES], hi[LANES];
  sw::load_tile(a, t, x);
  sw::Range r;
  bool hit[LANES] = {};
  // d < 0: every run is empty (d is the same for the whole grid)
  if (d >= 0 && sw::stage_range(a, b, nb, d, block_b, k_tiles, t, x, sh, r)) {
    int key[2 * LANES], at[2 * LANES];  // a - d, then min(a + d, SENTINEL - 1) + 1
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      key[i] = sw::key32(static_cast<long long>(x[i]) - d);
      key[LANES + i] =
          static_cast<int>(min(static_cast<long long>(x[i]) + d, sw::kSentinel - 1LL) + 1);
    }
    const sw::Ints row{b};
    sw::range_bounds(r, row, key, at);
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      const int l = at[i], h = at[LANES + i];
      hit[i] = x[i] != sw::kSentinel && h > l;
      if (hit[i]) {
        lo[i] = r.value(row, l);
        hi[i] = r.value(row, h - 1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < LANES; ++i) {
    const long long g = t.begin + threadIdx.x + i * sw::kThreads;
    if (g < t.end) {
      mask[g] = hit[i] ? 1 : 0;
      lo_out[g] = hit[i] ? lo[i] : x[i];
      hi_out[g] = hit[i] ? hi[i] : x[i];
    }
  }
}

template <int LANES>
int launch(const int* a, const int* b, uint8_t* mask, int* lo, int* hi, int na, int nb, int d,
           int block_a, int block_b, int k_tiles, cudaStream_t stream) {
  const unsigned blocks = sw::grid_blocks(na, block_a, sw::kThreads * LANES);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  proximity_kernel<LANES><<<blocks, sw::kThreads, 0, stream>>>(a, b, mask, lo, hi, na, nb, d,
                                                              block_a, block_b, k_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int proximity_join_raw(const int* a, const int* b, uint8_t* mask, int* lo, int* hi,
                                  int na, int nb, int d, int block_a, int block_b, int k_tiles,
                                  void* stream) {
  auto go = sw::sparse_a(na, nb) ? launch<1> : launch<4>;
  return go(a, b, mask, lo, hi, na, nb, d, block_a, block_b, k_tiles,
            static_cast<cudaStream_t>(stream));
}
