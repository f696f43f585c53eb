// A block per A-block: the machinery that the raw intersect (intersect.cu)
// and the proximity join (proximity.cu) share on Hopper (sm_90a).
//
// Both kernels answer, for every element x of a, questions about lower
// bounds in sorted b inside the b-window of x's A-block: element i lies in
// A-block i / block_a, whose window is the b-blocks min(start + k, nbb - 1),
// k in [0, k_tiles), of b cut into nbb blocks of block_b, start being the
// b-block that holds the lower bound of (the A-block's first element - d);
// d = 0 for the intersect. The lower bound of a key inside the window is
// its lower bound in b clamped to the window.
//
// Design. A block owns a tile of one A-block, LANES elements per thread,
// kThreads apart, so a warp's loads, shared-memory reads and stores stay
// together: 512-element tiles (4 lanes per thread), the whole A-block at
// the default block_a, or 128-element tiles (1 lane) where a 512-element
// tile of evenly spread a would need more of b than a block stages (a
// rare list against a frequent one). There the smaller tile quarters the
// range and its sampling stride and gives four times the blocks, when
// the few large tiles would leave most SMs idle.
// - It loads the tile and the A-block's first element in one round trip
//   and reduces the tile's live elements (not SENTINEL) to their min and
//   max.
// - It finds three lower bounds in b (keys in 32 bits: a key below INT_MIN
//   has the lower bound of INT_MIN, 0): of the first element - d, which
//   gives the window, and of min - d and min(max + d, SENTINEL - 1) + 1,
//   which clamped to the window give the needed range. Every key any live
//   lane searches for lies between the last two, so a lane's lower bound
//   inside the range is its lower bound in the window: the answer rests on
//   min and max alone, never on a being sorted inside the A-block.
// - The searches are kWays-way rounds of one warp (kProbes splitters per
//   lane and a ballot each; four rounds up to 16M values). One warp runs
//   the first round, whose splitters are the same for every key and every
//   block (so they stay in L1), for all three keys; then three warps
//   finish one key each. A round costs kWays loads, each to its own cache
//   line: on an H100 at 1024-way those loads, not the bytes, bounded the
//   kernel, and 32- to 128-way rounds ran within 10 % of each other.
// - The range is staged in shared memory when it holds at most kCap values
//   (16-byte cp.async copies where b is 16-byte aligned), and each lane
//   searches there, all of a thread's searches in lockstep over one
//   length. A longer range stages every stride-th value (stride =
//   ceil(n / kCap)): the lanes search that sample in shared memory, which
//   narrows each to stride - 1 values, and finish with a lockstep search
//   of those in global memory (log2(stride) dependent loads).
// This replaces the first port's chain of ~20 dependent loads per thread
// for the A-block's start, repeated by every thread, and ~11-13 more for
// its own search, with a chain per block of one load, four search rounds,
// one staging copy and shared-memory work. The bytes read stay near one
// pass over the b-values that the tiles need.
//
// The searches read b through a row type (Row::Key, Row::kTop and
// row(j), the j-th value as a Key): Ints for the raw int32 lists here;
// intersect.cu's compressed kernel passes its delta16 streams, decoded at
// each probe, through the same warp searches and lane searches.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace sorted_window {

constexpr int kSentinel = 2147483647;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 4096;           // b-values a block stages in shared memory
constexpr int kProbes = 2;           // splitters per lane per search round
constexpr int kWays = 32 * kProbes;  // splitters per search round
constexpr int kMinBlocks = 8;        // resident blocks per SM the registers allow
constexpr unsigned kFull = 0xffffffffu;

struct __align__(16) Shared {
  int buf[kCap + 4];  // the staged range (+ 3 values of 16-byte alignment slack)
  int mn[kWarps], mx[kWarps];
  int lo[3], hi[3];  // for each of the three keys: its lower bound in b lies in [lo, hi]
  int pos[3];        // and is pos
};

// [begin, end) of a held by this block, and its A-block's first index.
struct Tile {
  long long a0, begin, end;
};

// A sorted int32 row in device memory.
struct Ints {
  using Key = int;
  static constexpr int kTop = kSentinel;  // what a search reads past the end
  const int* p;
  __device__ __forceinline__ int operator()(int j) const { return __ldg(p + j); }
};

// The needed range [lo, lo + n) of b and what of it is staged: every
// stride-th value, m of them, at s.
struct Range {
  int lo, n, stride, m;
  const int* s;
  // value j of the range
  template <class Row>
  __device__ __forceinline__ typename Row::Key value(const Row& b, int j) const {
    return stride == 1 ? s[j] : b(lo + j);
  }
};

// x as a search key: below INT_MIN every lower bound is 0, as at INT_MIN.
__device__ __forceinline__ int key32(long long x) {
  return static_cast<int>(max(x, static_cast<long long>(INT_MIN)));
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Lanes per thread for a launch: 1 where a 512-element tile of evenly
// spread a would need more than kCap values of b, else 4.
inline bool sparse_a(int na, int nb) {
  return static_cast<long long>(4 * kThreads) * nb > static_cast<long long>(kCap) * na;
}

// Blocks of the grid: ceil(block_a / tile) tiles per A-block; 0 if the
// count does not fit a grid.
inline unsigned grid_blocks(int na, int block_a, int tile) {
  const long long n =
      static_cast<long long>((na + block_a - 1) / block_a) * ((block_a + tile - 1) / tile);
  return n > INT_MAX ? 0u : static_cast<unsigned>(n);
}

template <int LANES>
__device__ __forceinline__ Tile tile_of(int na, int block_a) {
  constexpr int kTile = kThreads * LANES;
  const int per = (block_a + kTile - 1) / kTile;
  const long long a0 = static_cast<long long>(blockIdx.x / per) * block_a;
  const long long begin = a0 + static_cast<long long>(blockIdx.x % per) * kTile;
  return {a0, begin, min(min(begin + kTile, a0 + block_a), static_cast<long long>(na))};
}

// The tile's elements of a, SENTINEL past its end.
template <int LANES>
__device__ __forceinline__ void load_tile(const int* __restrict__ a, const Tile& t,
                                          int (&x)[LANES]) {
#pragma unroll
  for (int i = 0; i < LANES; ++i) {
    const long long g = t.begin + threadIdx.x + i * kThreads;
    x[i] = g < t.end ? __ldg(a + g) : kSentinel;
  }
}

// This lane's kProbes of the kWays splitters row[lo + k * step - 1], k = 1..kWays,
// of a warp's search round over row[lo, hi) (Row::kTop past hi). No index
// overflows: kWays * step < hi - lo + kWays.
template <class Row>
__device__ __forceinline__ void load_splitters(const Row& row, int lo, int hi, int step,
                                               typename Row::Key (&v)[kProbes]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kProbes; ++q) {
    const int p = lo + (lane + 32 * q + 1) * step - 1;
    v[q] = p < hi ? row(p) : Row::kTop;
  }
}

// How many of the round's splitters are below x (the warp's lanes vote).
template <class Key>
__device__ __forceinline__ int count_below(const Key (&v)[kProbes], int lo, int hi, int step,
                                           Key x) {
  const int lane = threadIdx.x & 31;
  int c = 0;
#pragma unroll
  for (int q = 0; q < kProbes; ++q) {
    const int p = lo + (lane + 32 * q + 1) * step - 1;
    c += __popc(__ballot_sync(kFull, p < hi && v[q] < x));
  }
  return c;
}

// The lower bound of x in row, known to lie in [lo, hi], found by one
// warp: each round the range shrinks kWays-fold. All lanes of the warp
// must call it with the same arguments.
template <class Row>
__device__ __forceinline__ int warp_lower_bound(const Row& row, int lo, int hi,
                                                typename Row::Key x) {
  while (hi > lo) {
    const int step = (hi - lo + kWays - 1) / kWays;
    typename Row::Key v[kProbes];
    load_splitters(row, lo, hi, step, v);
    lo += count_below(v, lo, hi, step, x) * step;
    hi = min(hi, lo + step - 1);
  }
  return lo;
}

// The block's least and greatest of its threads' mn and mx, in every
// thread. Block-uniform; every thread of the block must call it.
__device__ __forceinline__ void block_min_max(int& mn, int& mx, Shared& sh) {
  const int warp = threadIdx.x >> 5;
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  if ((threadIdx.x & 31) == 0) {
    sh.mn[warp] = mn;
    sh.mx[warp] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mn = min(mn, sh.mn[w]);
    mx = max(mx, sh.mx[w]);
  }
}

// [w_lo, w_hi): the elements of the b-blocks min(start + k, nbb - 1), k in
// [0, k_tiles), of b's nb elements cut into nbb blocks of block_b, as the
// TPU kernel's clamped index map visits them; 64-bit, so that start +
// k_tiles cannot wrap. A start below 0 (never planned, but a caller may pass
// one) cuts the window at 0, where every lower bound lies at or above.
__device__ __forceinline__ void window_of(long long start, int nb, int block_b, int k_tiles,
                                          int& w_lo, int& w_hi) {
  const long long last = (nb + block_b - 1) / block_b - 1;
  const long long lo = max(min(start, last) * block_b, 0LL);
  w_hi = static_cast<int>(
      max(min((min(start + k_tiles - 1, last) + 1) * block_b, static_cast<long long>(nb)), lo));
  w_lo = static_cast<int>(lo);
}

// Stages the range that the tile's live elements x need, for d >= 0.
// Returns false, staging nothing, when the tile holds no live element.
// Block-uniform; every thread of the block must call it.
template <int LANES>
__device__ __forceinline__ bool stage_range(const int* __restrict__ a, const int* __restrict__ b,
                                            int nb, int d, int block_b, int k_tiles,
                                            const Tile& t, const int (&x)[LANES], Shared& sh,
                                            Range& r) {
  const int warp = threadIdx.x >> 5;
  const int first = __ldg(a + t.a0);
  int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
  for (int i = 0; i < LANES; ++i) {
    if (x[i] != kSentinel) {
      mn = min(mn, x[i]);
      mx = max(mx, x[i]);
    }
  }
  block_min_max(mn, mx, sh);
  if (mn > mx) return false;

  const int key[3] = {key32(static_cast<long long>(first) - d),
                      key32(static_cast<long long>(mn) - d),
                      static_cast<int>(min(static_cast<long long>(mx) + d, kSentinel - 1LL) + 1)};
  // the first round over all of b is the same for every key: one warp
  // runs it for all three
  if (warp == 0) {
    const int step = (nb + kWays - 1) / kWays;
    int v[kProbes];
    load_splitters(Ints{b}, 0, nb, step, v);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int lo = count_below(v, 0, nb, step, key[j]) * step;
      if ((threadIdx.x & 31) == 0) {
        sh.lo[j] = lo;
        sh.hi[j] = min(nb, lo + step - 1);
      }
    }
  }
  __syncthreads();
  const bool same_start = key[1] == key[0];  // a sorted tile that starts its A-block
  if (warp < 3 && !(warp == 1 && same_start)) {
    const int p = warp_lower_bound(Ints{b}, sh.lo[warp], sh.hi[warp], key[warp]);
    if ((threadIdx.x & 31) == 0) sh.pos[warp] = p;
  }
  __syncthreads();

  int w_lo, w_hi;
  window_of(sh.pos[0] / block_b, nb, block_b, k_tiles, w_lo, w_hi);
  const int lo = min(max(same_start ? sh.pos[0] : sh.pos[1], w_lo), w_hi);
  const int hi = max(min(max(sh.pos[2], w_lo), w_hi), lo);

  r.lo = lo;
  r.n = hi - lo;
  r.stride = max(1, (r.n + kCap - 1) / kCap);
  r.m = (r.n + r.stride - 1) / r.stride;
  int off = 0;
  if (r.stride == 1 && (reinterpret_cast<uintptr_t>(b) & 15) == 0) {
    const int base = lo & ~3;
    off = lo - base;
    const int chunks = (hi - base + 3) >> 2;
    for (int j = threadIdx.x; j < chunks; j += kThreads) {
      const int g = base + 4 * j;
      if (g + 4 <= nb) {
        cp_async16(sh.buf + 4 * j, b + g);
      } else {
        for (int e = 0; e < 4 && g + e < hi; ++e) cp_async4(sh.buf + 4 * j + e, b + g + e);
      }
    }
  } else {
    for (int j = threadIdx.x; j < r.m; j += kThreads) {
      cp_async4(sh.buf + j, b + lo + static_cast<long long>(j) * r.stride);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  r.s = sh.buf + off;
  return true;
}

// Each key's lower bound in the range, as an index into it: in the staged
// sample first, then, for a sampled range, among the stride - 1 values
// that the sample leaves open, in global memory. A thread's searches step
// in lockstep over one length, so their loads are in flight together.
template <int N, class Row>
__device__ __forceinline__ void range_bounds(const Range& r, const Row& b, const int (&key)[N],
                                             int (&pos)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pos[i] = 0;
  if (r.m == 0) return;
  int len = r.m;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (r.s[pos[i] + half] < key[i]) pos[i] += half;
    }
    len -= half;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (r.s[pos[i]] < key[i]) ++pos[i];
  }
  if (r.stride == 1) return;  // block-uniform

  // sample index p: the bound lies in [(p - 1) * stride + 1, min(p * stride, n)];
  // p = 0: it is 0. Values at or past each lane's end read as +infinity.
  // p * stride < n + stride fits an int.
  int end[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int p = pos[i];
    end[i] = p == 0 ? 0 : min(p * r.stride, r.n);
    pos[i] = p == 0 ? 0 : (p - 1) * r.stride + 1;
  }
  len = r.stride - 1;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int q = pos[i] + half;
      if (q < end[i] && b(r.lo + q) < key[i]) pos[i] = q;
    }
    len -= half;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (pos[i] < end[i] && b(r.lo + pos[i]) < key[i]) ++pos[i];
  }
}

}  // namespace sorted_window
