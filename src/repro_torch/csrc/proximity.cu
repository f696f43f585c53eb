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
// Design. One thread per element of a and two lower-bound binary searches
// inside its window, for a - d and for min(a + d, SENTINEL - 1) + 1. The TPU
// kernel's (512 x 1024) broadcast compare per grid step is not carried over:
// its work grows with Na times the window. Each thread finds its A-block's
// start itself; all threads of an A-block search the same value, so their
// loads are broadcasts.
//
// What bounds it. On an H100 the function is memory-bound: it reads a and b
// once and writes 9 bytes per element of a. This first kernel is
// latency-bound instead: each search step is a dependent load, and
// neighbouring threads repeat nearly the same path.
//
// Interface. A plain C function that launches on the caller's stream and
// returns cudaGetLastError(); the Python wrapper allocates the outputs,
// checks devices, types, shapes and sizes, and raises when the code is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 2147483647;
constexpr int kThreads = 256;

// First index in [lo, hi) of the sorted row whose value is >= x (hi if none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ row, int lo, int hi,
                                           long long x) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (static_cast<long long>(__ldg(row + mid)) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) proximity_kernel(
    const int* __restrict__ a, const int* __restrict__ b, uint8_t* __restrict__ mask,
    int* __restrict__ lo_out, int* __restrict__ hi_out, int na, int nb, int d, int block_a,
    int block_b, int k_tiles) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= na) return;
  const int x = a[i];
  const long long first = __ldg(a + (i / block_a) * block_a);
  const long long start = lower_bound(b, 0, nb, first - d) / block_b;
  const long long last = (nb + block_b - 1) / block_b - 1;
  const int w_lo = static_cast<int>(min(start, last) * block_b);
  const int w_hi = static_cast<int>(
      min((min(start + k_tiles - 1, last) + 1) * block_b, static_cast<long long>(nb)));
  const long long top = min(static_cast<long long>(x) + d, kSentinel - 1LL);
  const int l = lower_bound(b, w_lo, w_hi, static_cast<long long>(x) - d);
  const int h = lower_bound(b, l, w_hi, top + 1);
  const bool hit = x != kSentinel && h > l;
  mask[i] = hit ? 1 : 0;
  lo_out[i] = hit ? __ldg(b + l) : x;
  hi_out[i] = hit ? __ldg(b + h - 1) : x;
}

}  // namespace

extern "C" int proximity_join_raw(const int* a, const int* b, uint8_t* mask, int* lo, int* hi,
                                  int na, int nb, int d, int block_a, int block_b, int k_tiles,
                                  void* stream) {
  const unsigned blocks = static_cast<unsigned>((na + kThreads - 1) / kThreads);
  proximity_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, mask, lo, hi, na, nb, d, block_a, block_b, k_tiles);
  return static_cast<int>(cudaGetLastError());
}
