// Weighted embedding bag (sum or mean of table rows per bag) for Hopper
// (sm_90a), float32 and bfloat16 tables.
//
// Replaces the TPU kernel embedding_bag_pallas of
// src/repro/kernels/embedding_bag/embedding_bag.py (pallas_call at :73, body
// _kernel at :30) together with the mean division and the cast of its
// wrapper embedding_bag (src/repro/kernels/embedding_bag/ops.py:42-48). It
// computes what embedding_bag_plain in
// src/repro_torch/kernels/embedding_bag/ops.py computes, bit for bit: both
// add the products in the order s = 0..S-1 in float32.
//
// Function. out[b, :] = sum over s of w'[b, s] * table[ids[b, s], :], where
// ids outside [0, V) contribute nothing and w' is the float32 weight rounded
// to the table's type, as the TPU kernel scales its one-hot rows in that
// type. Products and sums are float32. combine = mean divides by
// max(#{s : ids[b, s] >= 0}, 1). The result is cast to the table's type.
//
// Design. The TPU kernel is a one-hot matrix product over the whole
// vocabulary, because the TPU has no fast gather; at V = 10M that reads the
// whole table per batch block. Here it is a gather: one block per (bag,
// slice of D), one thread per column, a float32 accumulator in a register,
// the rows read in order. __fmul_rn and __fadd_rn keep nvcc from fusing the
// multiply-add, so the sum equals the plain version's.
//
// What bounds it. Memory: each distinct row of the bag ids is read once
// (D x 4 or 2 bytes), against 2 float32 operations per read element. A
// block reads whole rows, so its loads are coalesced; its S loads are
// independent, so the unrolled loop keeps several rows in flight.
//
// Interface. A plain C function that launches on the caller's stream and
// returns cudaGetLastError(); the Python wrapper allocates the output, checks
// devices, types, shapes and sizes, and raises when the code is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const int* __restrict__ ids, const float* __restrict__ weights,
    const T* __restrict__ table, T* __restrict__ out, int S, int V, int D, int mean) {
  const int bag = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= D) return;
  const int* bag_ids = ids + static_cast<int64_t>(bag) * S;
  const float* bag_w = weights == nullptr ? nullptr : weights + static_cast<int64_t>(bag) * S;
  float acc = 0.0f;
  int count = 0;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const int id = __ldg(bag_ids + s);
    count += id >= 0;
    if (id < 0 || id >= V) continue;
    const float w = bag_w == nullptr ? 1.0f : to_float(from_float<T>(__ldg(bag_w + s)));
    const float v = to_float(table[static_cast<int64_t>(id) * D + col]);
    acc = __fadd_rn(acc, __fmul_rn(w, v));
  }
  if (mean) acc = __fdiv_rn(acc, static_cast<float>(max(count, 1)));
  out[static_cast<int64_t>(bag) * D + col] = from_float<T>(acc);
}

template <typename T>
void launch(const int* ids, const float* weights, const void* table, void* out, int B, int S,
            int V, int D, int mean, cudaStream_t stream) {
  const dim3 grid(B, (D + kThreads - 1) / kThreads);
  embedding_bag_kernel<T><<<grid, kThreads, 0, stream>>>(
      ids, weights, static_cast<const T*>(table), static_cast<T*>(out), S, V, D, mean);
}

}  // namespace

// dtype: 0 = float32 table and output, 1 = bfloat16. weights may be null
// (every weight 1).
extern "C" int embedding_bag_fwd(const int* ids, const float* weights, const void* table,
                                 void* out, int B, int S, int V, int D, int mean, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(ids, weights, table, out, B, S, V, D, mean, s);
      break;
    case 1:
      launch<__nv_bfloat16>(ids, weights, table, out, B, S, V, D, mean, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
