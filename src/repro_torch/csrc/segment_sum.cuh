// Sorted segment sum for Hopper (sm_90a), float32: the device code that
// csrc/segment_sum.cu (the GNN's scatter-adds) and csrc/embedding_bag.cu
// (the bag's backward) share.
//
// Function. For each output row r in [0, R):
//   out[r, c] = sum over k in [offsets[r], offsets[r + 1]) of
//               w[t_k] * rows[t_k / div, c],   t_k = order[k],
// for c in [0, C), where w is the float32 weight of term t_k (every weight
// 1 when w is null) and div maps a term to the row of `rows` it reads (1
// for the GNN, whose term is an edge and reads its own row; S for the bag,
// whose term is a (b, s) position and reads g'[b]). A row with an empty
// segment is written as zeros, so the caller allocates `out` with
// torch.empty and nothing fills it first.
//
// Order. The caller stable-sorts the terms' keys (torch.sort(stable=True))
// and builds `offsets` with torch.searchsorted, an integer result that no
// order of work can change. So a row's terms come in their index order,
// the order in which index_add_ adds them on the CPU, and the sum starts
// at 0.0f and adds them one by one with __fmul_rn and __fadd_rn, which
// nvcc may not fuse into an FMA. Each output element is therefore the
// CPU's index_add_ result bit for bit, and the same in every run: no
// atomics, and no element is written by two threads.
//
// What bounds it. Memory: every output row is written once (R x C x 4
// bytes, zeros included), every term reads its C x 4 bytes of `rows`, its
// index and its weight, every row two offsets; one multiply and one add
// per term and column. The reads of a term are a dependent chain (offsets,
// then order, then rows), so it needs many rows in flight.
//
// Design, simple first. A group of G lanes of a warp takes one output row,
// G the smallest power of two >= C, at most 32 (C = 1: 32 rows a warp; C =
// 3: 8; C >= 32: one), and its lanes walk the columns c = lane + G e. A lane
// keeps kMaxPer float32 sums, so one pass covers kMaxPer x G columns; a row
// wider than that takes more passes over its segment. Groups of a warp run
// independent rows with no shuffle between them. A lane loads kUnroll
// terms' indices, then their rows, then adds them in order. A segment of
// more than kLong terms (a hub node, the node 0 that every padding edge
// names, a frequent id) would leave one group waiting on a chain of loads
// per kUnroll terms, so its group hands it to the whole block: the block's
// threads stage a chunk of its terms' indices, then their values, in
// shared memory, 16 row loads in flight each, and the thread that owns a column adds them in order from
// there. Its sums are the same: the same products, added in the same
// order. Every block meets one barrier, to learn whether it holds a long
// segment; only such a block meets more. The register budget is set for
// four blocks an SM (64 a thread), which the short path needs to keep
// rows in flight. Speed is later work (PERF.md §6): the staging of a long
// segment is still far from the memory rate, the adds of one segment and
// column are one chain, and a sort of the keys and a search per row run
// before the launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segsum {

constexpr int kThreads = 256;
constexpr int kMaxPer = 8;  // float32 sums a lane keeps per pass
constexpr int kUnroll = 4;  // terms whose rows a lane loads before adding them
constexpr int kLong = 64;   // a segment of more terms is summed by the whole block
constexpr int kStage = 4096;  // float32 values a block stages for a long segment (16 KB)
constexpr int kChunkTerms = 512;  // a long segment's terms staged at a time, at most
constexpr int kBatch = 16;  // staging loads in flight per thread
constexpr int kMinBlocks = 4;  // blocks per SM the register budget is set for (64 a thread)

// lanes per output row: the smallest power of two >= C, at most 32
inline int group_width(int C) {
  int g = 1;
  while (g < C && g < 32) g <<= 1;
  return g;
}

// U terms t_k, ..., t_{k+U-1} of one pass: their indices and weights
// first, then their row values, then the in-order sums, so a lane keeps U
// row loads in flight on a long segment.
template <int U>
__device__ __forceinline__ void add_terms(float (&acc)[kMaxPer], const float* __restrict__ rows,
                                          const int* __restrict__ order,
                                          const float* __restrict__ weights, int k, int C,
                                          int div, int c0, int glane, int G) {
  int t[U];
  float w[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    t[u] = __ldg(order + k + u);
    w[u] = weights == nullptr ? 1.0f : __ldg(weights + t[u]);
  }
  float v[U][kMaxPer];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float* src = rows + static_cast<int64_t>(t[u] / div) * C;
#pragma unroll
    for (int e = 0; e < kMaxPer; ++e) {
      const int c = c0 + glane + G * e;
      v[u][e] = c < C ? __ldg(src + c) : 0.0f;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int e = 0; e < kMaxPer; ++e) {
      // w * v is v exactly when w is 1, as in the plain version's product
      acc[e] = __fadd_rn(acc[e], weights == nullptr ? v[u][e] : __fmul_rn(w[u], v[u][e]));
    }
  }
}

// A long segment's row, summed by the whole block, in chunks of terms: the
// block's threads stage the chunk's term indices in shared memory, then
// its products (or values), kBatch row loads in flight per thread, and
// then the thread owning a column adds the chunk's terms to its sum in
// order, reading 8 ahead of its chain of adds. Every thread of the block
// calls it, with the same arguments.
__device__ __forceinline__ void block_row(float* stage, int* terms, const float* __restrict__ rows,
                                          const int* __restrict__ order,
                                          const float* __restrict__ weights, int lo, int hi,
                                          float* __restrict__ out_row, int C, int div) {
  for (int c0 = 0; c0 < C; c0 += kThreads) {
    const int cols = min(C - c0, kThreads);
    const int chunk = min(kStage / cols, kChunkTerms);  // terms staged at a time
    float acc = 0.0f;
    for (int k0 = lo; k0 < hi; k0 += chunk) {
      const int m = min(chunk, hi - k0);  // terms in this chunk
      const int n = m * cols;  // values in this chunk
      for (int j = threadIdx.x; j < m; j += kThreads) terms[j] = __ldg(order + k0 + j);
      __syncthreads();
#pragma unroll 1
      for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kThreads) {
        // past the chunk's end a thread loads the last value again (no
        // branch between the loads) and does not store it
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = min(i0 + u * kThreads, n - 1);
          const int t = terms[i / cols];
          const float x = __ldg(rows + static_cast<int64_t>(t / div) * C + c0 + i % cols);
          v[u] = weights == nullptr ? x : __fmul_rn(__ldg(weights + t), x);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < n) stage[i] = v[u];
        }
      }
      __syncthreads();
      if (threadIdx.x < cols) {  // 8 reads of shared memory ahead of the chain of adds
        int i = threadIdx.x;
        for (; i + 7 * cols < n; i += 8 * cols) {
          float x[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) x[j] = stage[i + j * cols];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, x[j]);
        }
        for (; i < n; i += cols) acc = __fadd_rn(acc, stage[i]);
      }
      __syncthreads();
    }
    if (threadIdx.x < cols) out_row[c0 + threadIdx.x] = acc;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) sorted_segment_sum_kernel(
    const float* __restrict__ rows, const int* __restrict__ order,
    const float* __restrict__ weights, const int* __restrict__ offsets,
    float* __restrict__ out, int R, int C, int div, int G) {
  __shared__ float stage[kStage];
  __shared__ int terms[kChunkTerms];
  __shared__ int long_rows[kThreads];
  __shared__ int n_long;
  const int per_block = kThreads / G;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t r = first + threadIdx.x / G;
  const int glane = threadIdx.x % G;
  int lo = 0, hi = 0;
  if (r < R) {
    lo = __ldg(offsets + r);
    hi = __ldg(offsets + r + 1);
  }
  const bool is_long = hi - lo > kLong;
  // one barrier for every block; only a block that holds a long segment
  // meets more (below)
  const bool any_long = __syncthreads_or(is_long);
  if (r < R && !is_long) {
    float* out_row = out + r * C;
    for (int c0 = 0; c0 < C; c0 += kMaxPer * G) {
      float acc[kMaxPer];
#pragma unroll
      for (int e = 0; e < kMaxPer; ++e) acc[e] = 0.0f;
      int k = lo;
      for (; k + kUnroll <= hi; k += kUnroll) {
        add_terms<kUnroll>(acc, rows, order, weights, k, C, div, c0, glane, G);
      }
      for (; k < hi; ++k) add_terms<1>(acc, rows, order, weights, k, C, div, c0, glane, G);
#pragma unroll
      for (int e = 0; e < kMaxPer; ++e) {
        const int c = c0 + glane + G * e;
        if (c < C) out_row[c] = acc[e];
      }
    }
  }
  if (!any_long) return;  // the same for every thread of the block
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  if (is_long && glane == 0) long_rows[atomicAdd(&n_long, 1)] = static_cast<int>(r - first);
  __syncthreads();
  // n_long is the same for every thread now; the order of the long rows in
  // the list does not matter, each is summed whole and in order
  for (int i = 0; i < n_long; ++i) {
    const int64_t row = first + long_rows[i];
    block_row(stage, terms, rows, order, weights, __ldg(offsets + row), __ldg(offsets + row + 1),
              out + row * C, C, div);
  }
}

// Launch on `stream`; returns cudaGetLastError(). R, C >= 1.
inline int launch(const float* rows, const int* order, const float* weights,
                  const int* offsets, float* out, int R, int C, int div, cudaStream_t stream) {
  const int G = group_width(C);
  const int per_block = kThreads / G;
  const int64_t blocks = (static_cast<int64_t>(R) + per_block - 1) / per_block;
  sorted_segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      rows, order, weights, offsets, out, R, C, div, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segsum
