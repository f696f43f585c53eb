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
// What bounds it. Bytes: every output row is written once (R x C x 4,
// zeros included), every term reads its C x 4 bytes of `rows`, its index
// and its weight, every row two offsets. And a chain: the terms of one
// segment and column are one sequence of dependent adds, which nothing
// may split or reorder, so a segment of L terms takes at least L add
// latencies (~4 cycles each, reckoned: L = 11,617 terms, 23.5 us at 1.98
// GHz) however many SMs the card has. The bound is the larger of the two.
//
// Design. The plan (kernels/segment_sum/ops.py) hands over, besides the
// order and the offsets, the list of rows whose segment holds more than
// `long_min` terms (at most n / (long_min + 1) of them, -1 after the last),
// built on the device with no host sync. Two kernels then write disjoint
// rows:
//
// * Long rows (long_rows_kernel), launched first on a second stream of
//   high priority, ordered after the caller's stream by one event and
//   joined back to it by another, so they run beside the short rows and
//   not after them. A work item is one long row and one slice of kSlice
//   (8) columns; a persistent grid of at most one block per SM walks the
//   items, so a row's slices run on several SMs. In a block, one consumer
//   warp owns the slice, a lane a column, and runs the chain out of
//   shared memory, kAhead reads ahead of its adds; kProducerWarps (16)
//   producer warps gather the items' terms, in chunks of kChunk (512), into a
//   ring of kStages stages in dynamic shared memory with cp.async (16-byte
//   pieces where the rows are 16-byte aligned, else 4 bytes), the term
//   indices copied kStages chunks ahead. mbarriers hand the stages over: a
//   producer's cp.async.mbarrier.arrive marks a stage full when its copies
//   land, the consumer's arrive marks it empty; no block-wide barrier after
//   the start. The consumer's warp has its scheduler alone (warps 4, 8,
//   ... leave at once) and the producers sleep while the ring is full.
//   Why so narrow a slice: timed with clock64 in each role on the H100,
//   one SM gathered 32-column (128-byte) row slices more slowly than the
//   chain consumes them, by cp.async as by bulk copies, scattered or
//   contiguous, and no faster with an L2 prefetch; with 8 columns and 16
//   producer warps the chain sets the pace. The indices wait in shared
//   memory: kept in registers a ring ahead, they ran slower.
// * Short rows (short_rows_kernel), on the caller's stream: no barrier and
//   no shared memory. A group of G lanes takes a row, each lane VW columns
//   (a 16-byte vector where the row stride and the pointers allow it, else
//   one float, chosen here at launch) and PER such pieces; C <= 4 takes a
//   thread a row. A lane loads its next U term indices while it loads the
//   rows of the current U, then adds them in order, loads past the
//   segment's end predicated off; the grid strides over the rows, and a
//   long row is skipped. An empty row (most of the bag's 10M) costs its
//   offsets and a store of zeros. The register budget is set per variant
//   for 5 or 6 blocks an SM.
//
// Every output row is written once: a long row by the long kernel, every
// other row by the short kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segsum {

constexpr int kThreads = 256;        // a short block
// A long block: warp 0 consumes; kProducerWarps warps that do not share
// its scheduler (1-3, 5-7, 9, ...) produce; the warps 4, 8, ... leave at once.
constexpr int kProducerWarps = 16;
constexpr int kLongWarps = kProducerWarps + (kProducerWarps - 1) / 3 + 1;
constexpr int kLongThreads = 32 * kLongWarps;
constexpr int kStages = 8;           // the long path's ring
constexpr int kChunk = 32 * kProducerWarps;  // terms a stage: one a producer lane
constexpr int kSlice = 8;            // columns a long work item takes
constexpr int kAhead = 16;           // shared-memory reads the consumer keeps ahead of its adds
constexpr unsigned kFull = 0xffffffffu;
// a long block's dynamic shared memory at most: barriers, stages, index slots, weights
constexpr int kMaxSmem = 2 * kStages * 8 + kStages * kChunk * (kSlice + 2) * 4;

inline int pow2_at_least(int x) {
  int g = 1;
  while (g < x) g <<= 1;
  return g;
}

// -- the short rows --------------------------------------------------------

template <int VW>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(float* v, const float* p) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};
template <>
struct Vec<4> {
  __device__ static void load(float* v, const float* p) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Rows r in [0, R) whose segment holds at most long_min terms; a group of
// G lanes a row, lane glane's pieces at columns c0 + (glane + G e) VW,
// e < PER, in passes of G PER VW columns. With VW 4, C % 4 == 0 and rows
// and out are 16-byte aligned (the launch checks).
template <int VW, int PER, int U, int kBlocks, bool kWeighted>
__global__ void __launch_bounds__(kThreads, kBlocks) short_rows_kernel(
    const float* __restrict__ rows, const int* __restrict__ order,
    const float* __restrict__ weights, const int* __restrict__ offsets,
    float* __restrict__ out, int64_t R, int C, int div, int G, int long_min) {
  const int per_block = kThreads / G;
  const int glane = threadIdx.x % G;
  const int pass = G * PER * VW;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * per_block + threadIdx.x / G; r < R;
       r += static_cast<int64_t>(gridDim.x) * per_block) {
    const int lo = __ldg(offsets + r);
    const int hi = __ldg(offsets + r + 1);
    if (hi - lo > long_min) continue;  // the long kernel writes it
    float* out_row = out + r * C;
    for (int c0 = 0; c0 < C; c0 += pass) {
      float acc[PER][VW];
#pragma unroll
      for (int e = 0; e < PER; ++e)
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[e][j] = 0.0f;
      // loads past the segment's end are predicated off, so a segment of one
      // term (uniform ids) costs one index and one row
      int t[U] = {};
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (lo + u < hi) t[u] = __ldg(order + lo + u);
      for (int k = lo; k < hi; k += U) {
        const int n = min(U, hi - k);
        // the next U indices, loaded while this U's rows are
        int tn[U] = {};
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k + U + u < hi) tn[u] = __ldg(order + k + U + u);
        float w[U];
        float v[U][PER][VW];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          w[u] = kWeighted && u < n ? __ldg(weights + t[u]) : 1.0f;
          const float* src = rows + static_cast<int64_t>(div == 1 ? t[u] : t[u] / div) * C;
#pragma unroll
          for (int e = 0; e < PER; ++e) {
            const int c = c0 + (glane + G * e) * VW;
            if (u < n && c < C) {
              Vec<VW>::load(v[u][e], src + c);
            } else {
#pragma unroll
              for (int j = 0; j < VW; ++j) v[u][e][j] = 0.0f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u < n) {
#pragma unroll
            for (int e = 0; e < PER; ++e)
#pragma unroll
              for (int j = 0; j < VW; ++j)
                // w * v is v exactly when w is 1, as in the plain version's product
                acc[e][j] = __fadd_rn(acc[e][j], kWeighted ? __fmul_rn(w[u], v[u][e][j]) : v[u][e][j]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) t[u] = tn[u];
      }
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int c = c0 + (glane + G * e) * VW;
        if (c < C) Vec<VW>::store(out_row + c, acc[e]);
      }
    }
  }
}

// -- the long rows ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// the same without suspending in the barrier: a producer that finds its
// stage still in use sleeps a little, leaving the SM's issue slots and
// shared memory to the consumer
__device__ __forceinline__ void bar_wait_sleep(uint64_t* bar, uint32_t parity) {
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    __nanosleep(64);
  }
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival on `bar` once every cp.async this thread has issued lands
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

template <int VW>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  if (VW == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  }
}

// the chain of one column over n staged terms (col[m W], weights ws[m]):
// two sets of kAhead registers, one read from shared memory while the
// other is added, so no read waits in the chain
template <bool kWeighted, int W>
__device__ __forceinline__ float chain(float acc, const float* col, const float* ws, int n) {
  constexpr int A = kAhead;
  auto val = [&](int m) { return kWeighted ? __fmul_rn(ws[m], col[m * W]) : col[m * W]; };
  int m = 0;
  if (n >= A) {
    float x[A], y[A];
#pragma unroll
    for (int j = 0; j < A; ++j) x[j] = val(j);
    // x holds terms [m, m + A)
    for (; m + 3 * A <= n; m += 2 * A) {
#pragma unroll
      for (int j = 0; j < A; ++j) y[j] = val(m + A + j);
#pragma unroll
      for (int j = 0; j < A; ++j) acc = __fadd_rn(acc, x[j]);
#pragma unroll
      for (int j = 0; j < A; ++j) x[j] = val(m + 2 * A + j);
#pragma unroll
      for (int j = 0; j < A; ++j) acc = __fadd_rn(acc, y[j]);
    }
    if (m + 2 * A <= n) {
#pragma unroll
      for (int j = 0; j < A; ++j) y[j] = val(m + A + j);
#pragma unroll
      for (int j = 0; j < A; ++j) acc = __fadd_rn(acc, x[j]);
#pragma unroll
      for (int j = 0; j < A; ++j) acc = __fadd_rn(acc, y[j]);
      m += 2 * A;
    } else {
#pragma unroll
      for (int j = 0; j < A; ++j) acc = __fadd_rn(acc, x[j]);
      m += A;
    }
  }
  for (; m < n; ++m) acc = __fadd_rn(acc, val(m));
  return acc;
}

// A block's walk over its work items, one chunk of kChunk terms at a time:
// item q = blockIdx.x, + gridDim.x, ... (long row long_rows[q / n_slices],
// columns from (q % n_slices) kSlice) until the list's -1 or n_items.
struct Walk {
  int64_t q;
  int r, lo, hi, k0;
  bool valid;

  __device__ void item(const int* __restrict__ long_rows, const int* __restrict__ offsets,
                       int64_t n_items, int n_slices) {
    valid = q < n_items;
    if (valid) {
      r = __ldg(long_rows + q / n_slices);
      valid = r >= 0;
    }
    if (valid) {
      lo = __ldg(offsets + r);
      hi = __ldg(offsets + r + 1);
      k0 = lo;
    }
  }
  __device__ void next(const int* long_rows, const int* offsets, int64_t n_items, int n_slices) {
    k0 += kChunk;
    if (k0 >= hi) {
      q += gridDim.x;
      item(long_rows, offsets, n_items, n_slices);
    }
  }
};

// Chunk g of the walk goes to stage g % kStages, whose barriers' phase is
// g / kStages. The producers and the consumer walk the same chunks. A
// stage holds kChunk terms x W floats, W the slice's width rounded up to a
// power of two (and to VW).
template <int VW, bool kWeighted>
__global__ void __launch_bounds__(kLongThreads, 1) long_rows_kernel(
    const float* __restrict__ rows, const int* __restrict__ order,
    const float* __restrict__ weights, const int* __restrict__ offsets,
    const int* __restrict__ long_rows, int64_t n_items, int n_slices, float* __restrict__ out,
    int C, int div, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float* stage = reinterpret_cast<float*>(empty + kStages);  // 128 bytes in: 16-byte aligned
  int* idx = reinterpret_cast<int*>(stage + kStages * kChunk * W);  // a chunk's term indices a stage
  float* wstage = reinterpret_cast<float*>(idx + kStages * kChunk);  // and its weights, when weighted
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // a block with no item (the list is shorter than its bound) leaves
  // before it sets anything up: the same test in every thread
  if (blockIdx.x >= n_items || __ldg(long_rows + blockIdx.x / n_slices) < 0) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 32 * kProducerWarps);
      bar_init(empty + s, 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Walk w;
  w.q = blockIdx.x;
  w.item(long_rows, offsets, n_items, n_slices);
  if (warp == 0) {  // the consumer: lane = column
    uint32_t g = 0;
    while (w.valid) {
      // lanes past the slice's kSlice columns add nothing
      const int c = lane < kSlice ? static_cast<int>(w.q % n_slices) * kSlice + lane : C;
      float acc = 0.0f;
      for (; w.k0 < w.hi; w.k0 += kChunk, ++g) {
        const int s = g % kStages;
        bar_wait(full + s, (g / kStages) & 1);
        if (c < C) {
          const float* col = stage + s * kChunk * W + lane;
          const float* ws = wstage + s * kChunk;
          const int n = min(kChunk, w.hi - w.k0);
          switch (W) {  // the stage's row width, as a constant of the reads
            case 1: acc = chain<kWeighted, 1>(acc, col, ws, n); break;
            case 2: acc = chain<kWeighted, 2>(acc, col, ws, n); break;
            case 4: acc = chain<kWeighted, 4>(acc, col, ws, n); break;
            default: acc = chain<kWeighted, kSlice>(acc, col, ws, n); break;
          }
        }
        bar_arrive(empty + s);
      }
      if (c < C) out[static_cast<int64_t>(w.r) * C + c] = acc;
      w.q += gridDim.x;
      w.item(long_rows, offsets, n_items, n_slices);
    }
    return;
  }
  if (warp % 4 == 0 || warp >= kLongWarps) return;  // warps that share the consumer's scheduler

  // A producer warp (pw: the warps 1-3, 5-7, 9, ... in order) takes terms
  // [32 pw, 32 pw + 32) of each chunk, lane i term m = 32 pw + i. The lane
  // copies its term's index kStages chunks ahead (`ahead` walks there)
  // into the stage's index slots with cp.async, a cp.async group a chunk,
  // and reads it back once cp.async.wait_group says it landed. The warp
  // then copies the terms' row slices in pieces of VW floats with
  // cp.async, a term's index shuffled to its pieces' lanes, and
  // cp.async.mbarrier.arrive counts them on the stage's barrier.
  const int pw = warp - 1 - (warp - 1) / 4;
  const int m0 = 32 * pw;
  const int m = m0 + lane;
  auto copy_index = [&](const Walk& a, int s) {
    if (a.valid && a.k0 + m < a.hi) {
      copy_async<1>(reinterpret_cast<float*>(idx + s * kChunk + m),
                    reinterpret_cast<const float*>(order + a.k0 + m));
    }
  };
  Walk ahead = w;
  for (int s = 0; s < kStages; ++s) {
    copy_index(ahead, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (ahead.valid) ahead.next(long_rows, offsets, n_items, n_slices);
  }
  uint32_t g = 0;
  int c0 = 0, pieces = 0, lanes = 1;
  int64_t q_cols = -1;
  for (; w.valid; w.next(long_rows, offsets, n_items, n_slices), ++g) {
    if (w.q != q_cols) {  // a new item: its slice's pieces
      q_cols = w.q;
      c0 = static_cast<int>(w.q % n_slices) * kSlice;
      pieces = (min(kSlice, C - c0) + VW - 1) / VW;
      lanes = 1;  // lanes a term takes: the smallest power of two >= pieces
      while (lanes < pieces) lanes <<= 1;
    }
    const int s = g % kStages;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");  // this chunk's indices
    const int t_mine = w.k0 + m < w.hi ? idx[s * kChunk + m] : 0;
    bar_wait_sleep(empty + s, ((g / kStages) & 1) ^ 1);
    if (w.k0 + m0 < w.hi) {  // the same for the whole warp
      if (kWeighted && w.k0 + m < w.hi) copy_async<1>(wstage + s * kChunk + m, weights + t_mine);
      float* st = stage + (s * kChunk + m0) * W;
      const int per_copy = 32 / lanes;  // terms one copy instruction of the warp takes
      for (int it = 0; it < lanes; ++it) {
        const int j = it * per_copy + lane / lanes;  // the term in the warp's 32
        const int piece = lane % lanes;
        const int t = __shfl_sync(kFull, t_mine, j);
        if (piece < pieces && w.k0 + m0 + j < w.hi) {
          copy_async<VW>(st + j * W + piece * VW,
                         rows + static_cast<int64_t>(div == 1 ? t : t / div) * C + c0 + piece * VW);
        }
      }
    }
    bar_arrive_copies(full + s);
    // the slot's index is used: the chunk kStages ahead takes it
    copy_index(ahead, s);
    if (ahead.valid) ahead.next(long_rows, offsets, n_items, n_slices);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -- launch ----------------------------------------------------------------

struct DeviceState {
  bool ready = false;
  int sms = 0;
  cudaStream_t side = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
  bool smem_set[2][2] = {{false, false}, {false, false}};
};

// per library (static: an inline function's static would be one object
// shared by every library that includes this header)
static cudaError_t device_state(DeviceState** out) {
  static DeviceState states[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  DeviceState& st = states[dev];
  if (!st.ready) {
    int lo = 0, hi = 0;
    if ((err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetStreamPriorityRange(&lo, &hi)) ||
        (err = cudaStreamCreateWithPriority(&st.side, cudaStreamNonBlocking, hi)) ||
        (err = cudaEventCreateWithFlags(&st.fork, cudaEventDisableTiming)) ||
        (err = cudaEventCreateWithFlags(&st.join, cudaEventDisableTiming))) {
      return err;
    }
    st.ready = true;
  }
  *out = &st;
  return cudaSuccess;
}

template <int VW, bool kWeighted>
cudaError_t launch_long(DeviceState* st, const float* rows, const int* order,
                        const float* weights, const int* offsets, const int* long_rows,
                        int n_long, float* out, int C, int div) {
  const int W = VW == 4 ? max(4, min(kSlice, pow2_at_least(C))) : min(kSlice, pow2_at_least(C));
  const size_t smem = 2 * kStages * sizeof(uint64_t) +
                      static_cast<size_t>(kStages) * kChunk * (W + 1 + (kWeighted ? 1 : 0)) * 4;
  auto kernel = long_rows_kernel<VW, kWeighted>;
  bool& set = st->smem_set[VW == 4][kWeighted];
  if (!set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    set = true;
  }
  const int n_slices = (C + kSlice - 1) / kSlice;
  const int64_t n_items = static_cast<int64_t>(n_long) * n_slices;
  const int64_t grid = n_items < st->sms ? n_items : st->sms;
  kernel<<<static_cast<unsigned>(grid), kLongThreads, smem, st->side>>>(
      rows, order, weights, offsets, long_rows, n_items, n_slices, out, C, div, W);
  return cudaGetLastError();
}

// kBlocks: the short blocks an SM holds, which sets the register budget
// (6: 40 registers a thread; 5: 48, for the 16 values of <1, 4, 4>)
template <int VW, int PER, int U, int kBlocks>
void launch_short(int sms, const float* rows, const int* order, const float* weights,
                  const int* offsets, float* out, int64_t R, int C, int div, int G, int long_min,
                  cudaStream_t stream) {
  const int per_block = kThreads / G;
  const int64_t need = (R + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocks * 8;  // 8 waves; the grid strides over the rest
  const int64_t grid = need < cap ? need : cap;
  if (weights == nullptr) {
    short_rows_kernel<VW, PER, U, kBlocks, false><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        rows, order, weights, offsets, out, R, C, div, G, long_min);
  } else {
    short_rows_kernel<VW, PER, U, kBlocks, true><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        rows, order, weights, offsets, out, R, C, div, G, long_min);
  }
}

// Launch on `stream`; returns the first CUDA error. R, C >= 1. long_rows:
// n_long entries, the rows with more than long_min terms in increasing
// order and -1 after them (null with n_long 0 when no segment can be that
// long). The result is on `stream` when this returns, with no host sync.
inline int launch(const float* rows, const int* order, const float* weights, const int* offsets,
                  const int* long_rows, int n_long, int long_min, float* out, int R, int C,
                  int div, cudaStream_t stream) {
  DeviceState* st = nullptr;
  cudaError_t err = device_state(&st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool rows16 = C % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const bool out16 = rows16 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (n_long > 0) {
    if ((err = cudaEventRecord(st->fork, stream)) ||
        (err = cudaStreamWaitEvent(st->side, st->fork, 0))) {
      return static_cast<int>(err);
    }
    if (weights == nullptr) {
      err = rows16 ? launch_long<4, false>(st, rows, order, weights, offsets, long_rows, n_long,
                                           out, C, div)
                   : launch_long<1, false>(st, rows, order, weights, offsets, long_rows, n_long,
                                           out, C, div);
    } else {
      err = rows16 ? launch_long<4, true>(st, rows, order, weights, offsets, long_rows, n_long,
                                          out, C, div)
                   : launch_long<1, true>(st, rows, order, weights, offsets, long_rows, n_long,
                                          out, C, div);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaEventRecord(st->join, st->side))) return static_cast<int>(err);
  }
  if (out16) {  // 16-byte pieces: a thread a row at C 4, else G lanes a row
    launch_short<4, 1, 4, 6>(st->sms, rows, order, weights, offsets, out, R, C, div,
                             min(32, pow2_at_least((C + 3) / 4)), long_min, stream);
  } else if (C == 2) {
    launch_short<1, 2, 4, 6>(st->sms, rows, order, weights, offsets, out, R, C, div, 1,
                             long_min, stream);
  } else if (C == 3 || C == 4) {
    launch_short<1, 4, 4, 5>(st->sms, rows, order, weights, offsets, out, R, C, div, 1,
                             long_min, stream);
  } else {  // C == 1, or C >= 5 with scalar pieces
    launch_short<1, 1, 4, 6>(st->sms, rows, order, weights, offsets, out, R, C, div,
                             min(32, pow2_at_least(C)), long_min, stream);
  }
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  if (n_long > 0 && (err = cudaStreamWaitEvent(stream, st->join, 0))) return static_cast<int>(err);
  return 0;
}

}  // namespace segsum
