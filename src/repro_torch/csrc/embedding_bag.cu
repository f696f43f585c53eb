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
// What bounds it. Memory: each valid id reads D x 4 or 2 bytes of a row
// that is almost never in cache (10M rows), against 2 float32 operations
// per element read. To reach the memory rate the card needs tens of KB of
// row reads in flight per SM, and the first port (one 4-byte column per
// thread, each row load behind its id load and a branch) kept 8 x 4 bytes
// per thread.
//
// Design. One warp per (bag, 512-byte slice of the row): 128 float32 or
// 256 bfloat16 columns, 16 bytes per lane. The warp loads 32 of the bag's
// ids and weights at a time, coalesced; a ballot marks the ids inside the
// vocabulary, and walking its set bits in order compacts out pads and
// out-of-vocabulary ids while keeping the order. For each kUnroll of them
// the ids and weights are shuffled to every lane, all kUnroll row loads are
// issued (16 bytes each, predicated, no branch between them), and only
// then does the in-order sum consume them: a warp keeps 16 KB of rows in
// flight. __fmul_rn and __fadd_rn keep nvcc from fusing the multiply-add,
// so every column's sum equals the plain version's; the bag dimension is
// never split, only D is. A row width that is not a multiple of 16 bytes,
// or a table or output that is not 16-byte aligned, takes the scalar-load
// branch of the same kernel: lane j reads columns j, j + 32, ... of the
// slice with the same order of sums. Tensor cores do not apply: this is a
// gather-sum, and the TPU's one-hot product over all of V is not carried
// over.
//
// Interface. A plain C function that launches on the caller's stream and
// returns cudaGetLastError(); the Python wrapper allocates the output, checks
// devices, types, shapes and sizes, and raises when the code is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // row loads in flight per lane
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kPerLane = 4;  // elements in 16 bytes
  static __device__ float weight(float w) { return w; }
  static __device__ unsigned bits(const float* p) { return __float_as_uint(__ldg(p)); }
  // element e of a lane's 16 bytes
  static __device__ float get(const uint4& raw, int e) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
    return __uint_as_float(w[e]);
  }
  static __device__ void put(uint4& raw, int e, unsigned bits) {
    if (e == 0) raw.x = bits;
    if (e == 1) raw.y = bits;
    if (e == 2) raw.z = bits;
    if (e == 3) raw.w = bits;
  }
  static __device__ unsigned store_bits(float x) { return __float_as_uint(x); }
  static __device__ void store(float* p, float x) { *p = x; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerLane = 8;
  static __device__ float weight(float w) { return __bfloat162float(__float2bfloat16_rn(w)); }
  static __device__ unsigned bits(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ float get(const uint4& raw, int e) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
    return __uint_as_float(((w[e >> 1] >> (16 * (e & 1))) & 0xffffu) << 16);
  }
  static __device__ void put(uint4& raw, int e, unsigned bits) {
    const unsigned v = (bits & 0xffffu) << (16 * (e & 1));
    if ((e >> 1) == 0) raw.x |= v;
    if ((e >> 1) == 1) raw.y |= v;
    if ((e >> 1) == 2) raw.z |= v;
    if ((e >> 1) == 3) raw.w |= v;
  }
  static __device__ unsigned store_bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
};

// A lane's part of one row of the slice starting at column c0: in the
// vector branch the 16 bytes at column c0 + lane * kPerLane, in the scalar
// branch columns c0 + lane + 32 e. Columns past D read as 0.
template <typename T>
__device__ __forceinline__ uint4 load_part(const T* row, int c0, int lane, int D, bool vec) {
  constexpr int kPer = Elem<T>::kPerLane;
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (vec) {
    const int c = c0 + lane * kPer;
    if (c < D) raw = __ldg(reinterpret_cast<const uint4*>(row + c));
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c = c0 + lane + 32 * e;
      if (c < D) Elem<T>::put(raw, e, Elem<T>::bits(row + c));
    }
  }
  return raw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const int* __restrict__ ids, const float* __restrict__ weights,
    const T* __restrict__ table, T* __restrict__ out, int B, int S, int V, int D, int mean,
    int vec) {
  constexpr int kPer = Elem<T>::kPerLane;
  constexpr int kSlice = 32 * kPer;
  const int n_slices = (D + kSlice - 1) / kSlice;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= static_cast<int64_t>(B) * n_slices) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int bag = static_cast<int>(item / n_slices);
  const int c0 = static_cast<int>(item % n_slices) * kSlice;
  const int* bag_ids = ids + static_cast<int64_t>(bag) * S;
  const float* bag_w = weights == nullptr ? nullptr : weights + static_cast<int64_t>(bag) * S;

  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.0f;
  int count = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    int id = -1;
    float w = 1.0f;
    if (s < S) {
      id = __ldg(bag_ids + s);
      if (bag_w != nullptr) w = Elem<T>::weight(__ldg(bag_w + s));
    }
    count += __popc(__ballot_sync(kFull, id >= 0));
    unsigned todo = __ballot_sync(kFull, id >= 0 && id < V);
    while (todo != 0u) {  // warp-uniform
      int src[kUnroll];
      bool has[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // the next kUnroll ids in order
        has[u] = todo != 0u;
        src[u] = has[u] ? __ffs(todo) - 1 : 0;
        todo &= todo - 1u;
      }
      uint4 raw[kUnroll];
      float wu[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rid = __shfl_sync(kFull, id, src[u]);
        wu[u] = __shfl_sync(kFull, w, src[u]);
        raw[u] = has[u] ? load_part<T>(table + static_cast<int64_t>(rid) * D, c0, lane, D, vec)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!has[u]) continue;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          acc[e] = __fadd_rn(acc[e], __fmul_rn(wu[u], Elem<T>::get(raw[u], e)));
        }
      }
    }
  }
  if (mean) {
    const float n = static_cast<float>(max(count, 1));
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[e] = __fdiv_rn(acc[e], n);
  }

  T* out_row = out + static_cast<int64_t>(bag) * D;
  if (vec) {
    const int c = c0 + lane * kPer;
    if (c < D) {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < kPer; ++e) Elem<T>::put(raw, e, Elem<T>::store_bits(acc[e]));
      *reinterpret_cast<uint4*>(out_row + c) = raw;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c = c0 + lane + 32 * e;
      if (c < D) Elem<T>::store(out_row + c, acc[e]);
    }
  }
}

template <typename T>
void launch(const int* ids, const float* weights, const void* table, void* out, int B, int S,
            int V, int D, int mean, cudaStream_t stream) {
  constexpr int kSlice = 32 * Elem<T>::kPerLane;
  const int64_t items = static_cast<int64_t>(B) * ((D + kSlice - 1) / kSlice);
  const bool vec = (D * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t blocks = (items + kWarps - 1) / kWarps;
  embedding_bag_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ids, weights, static_cast<const T*>(table), static_cast<T*>(out), B, S, V, D, mean,
      vec ? 1 : 0);
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
