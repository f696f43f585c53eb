// Fused nearest-r window join (QT3/QT4/QT5) for Hopper (sm_90a).
//
// Replaces the TPU kernel window_join_pallas of
// src/repro/kernels/nearest_r/nearest_r.py (pallas_call at :207, body
// _kernel at :49) in the reference package. It computes what the plain
// version window_join_plain in src/repro_torch/kernels/nearest_r/ops.py
// computes; on every valid lane the two agree exactly.
//
// Function. For each anchor lane (b, l) with a = a_g[b, l] != SENTINEL,
// every key k with ns_r[b, k] = r > 0 must hold r values of the sorted row
// ns_g[b, k, :] within max_sep of a; the r nearest of them extend [lo, hi].
// At equal distance the p-th predecessor comes before the q-th successor
// iff p <= q (the CPU engine's candidate order). The QT5 stop constraints
// fold in elementwise: st_cnt >= st_r, with [lo, hi] extended by st_ext.
//
// What bounds it. Memory: the join needs each real anchor, the key values
// within max_sep of some anchor of their row and the stop values at real
// anchors once, and writes 9 bytes per lane, against a few dozen integer
// operations per (lane, key). In practice it is bound by latency: every
// block walks a chain of dependent memory round trips (anchors, window
// bounds, window), and a binary search per lane over the whole key row
// (the first port) adds ~log2(L) more per lane and key. The design keeps
// that chain short and keeps many lanes in flight.
//
// Design. A block owns a tile of kTile anchor lanes of one query row,
// kLanes per thread, kThreads apart (a warp's 32 lanes are neighbouring
// anchors, so its loads, stores and shared-memory reads stay together).
// Rows vary fastest in the grid, so the tiles that hold a padded row's
// anchors all start before the empty tails.
// It loads the anchors and the stop rows in one round trip, folds the
// stops, and reduces the tile's live anchors to their min and max. For
// each active key the key-row window [lb(min - max_sep), lb(max + max_sep
// + 1)) holds every value that can lie within max_sep of a live anchor, so
// the r nearest candidates outside it read as BIG_DIST and are never
// loaded. One warp per key finds the two bounds with 256-way searches (8
// splitters per lane and a ballot each, two rounds at L = 65536). The
// lower bound of an anchor inside the window is its lower bound in the
// row, so correctness rests on min and max alone, never on the anchors
// being sorted; sorted anchors only make windows short.
// - A window of at most kCap values is staged in shared memory with
//   coalesced cp.async copies, double-buffered across keys: key k+1's
//   window loads while key k is ranked. Each lane then finds its position
//   by a binary search there (a thread's lanes in lockstep over the same
//   length) and reads its r predecessors and successors. Staging W values
//   moves W * 4 bytes against ~lanes * log2(W) * 32 for the searches it
//   replaces, so by bytes it pays far past kCap; kCap is set by residency
//   (two 16 KB buffers per block).
// - A larger window (sparse anchors over a dense key row) is searched in
//   global memory, the lanes of a thread in lockstep. The first steps of
//   every lane's search read the same few values of the window, which stay
//   in L2.
// - The rank is instantiated for each multiplicity up to r_max and chosen
//   per key (r is the same for the whole block): most query keys have
//   r = 1, whose rank is two candidates and one comparison, not the
//   2 * r_max candidates and 2 * r_max^2 comparisons of the full rank.
// - The TPU kernel's live skip is kept: a block stops at the first key
//   after which none of its lanes is valid, and stages no key after it;
//   only the one window already in flight (issued while lanes were live)
//   is dropped.
// Tensor cores do not apply: the work is integer compare and rank.
//
// Interface. A plain C function that launches on the caller's stream and
// returns cudaGetLastError(); the Python wrapper allocates the outputs,
// checks devices, types, shapes and contiguity, and raises when the code
// is not 0. Multiplicities above r_max read at most r_max candidates per
// side (such a lane is then invalid).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 2147483647;
constexpr int kBigDist = 1 << 30;  // "no candidate" (BIG_DIST of the plain version)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;                 // anchor lanes per thread, kThreads apart
constexpr int kTile = kThreads * kLanes;  // anchor lanes per block
constexpr int kCap = 4096;                // key values per shared-memory buffer
constexpr int kProbes = 8;                // splitters per lane per search round
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Element i of a window, in global or in shared memory.
struct GlobalRow {
  const int* p;
  __device__ __forceinline__ int operator()(int i) const { return __ldg(p + i); }
};
struct SharedRow {
  const int* p;
  __device__ __forceinline__ int operator()(int i) const { return p[i]; }
};

// Two lower bounds, of x[j] in row[lo[j], hi[j]), found by the whole warp
// together and left in lo: each round every lane probes kProbes of 256
// evenly spaced splitters of each open range, ballots count the splitters
// below the target, and the range shrinks 256-fold. All lanes must call it
// with the same arguments.
__device__ __forceinline__ void warp_lower_bounds(const int* __restrict__ row, int (&lo)[2],
                                                  int (&hi)[2], const long long (&x)[2]) {
  const int lane = threadIdx.x & 31;
  while (hi[0] > lo[0] || hi[1] > lo[1]) {
    int step[2], v[2][kProbes];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      step[j] = (hi[j] - lo[j] + 32 * kProbes - 1) / (32 * kProbes);
#pragma unroll
      for (int q = 0; q < kProbes; ++q) {
        const int p = lo[j] + (lane + 32 * q + 1) * step[j] - 1;
        v[j][q] = hi[j] > lo[j] && p < hi[j] ? __ldg(row + p) : kSentinel;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (hi[j] > lo[j]) {  // warp-uniform
        int c = 0;
#pragma unroll
        for (int q = 0; q < kProbes; ++q) {
          const int p = lo[j] + (lane + 32 * q + 1) * step[j] - 1;
          c += __popc(__ballot_sync(kFull, p < hi[j] && v[j][q] < x[j]));
        }
        lo[j] += c * step[j];
        hi[j] = min(hi[j], lo[j] + step[j] - 1);
      }
    }
  }
}

// Each lane's lower bound in src[0, n): the first index whose value is not
// below a[i]. The lanes step in lockstep over one length, so their loads
// are in flight together; lanes outside ``lanes`` are left at 0.
template <typename Src>
__device__ __forceinline__ void lower_bounds(Src src, int n, const int (&a)[kLanes],
                                             unsigned lanes, int (&at)[kLanes]) {
#pragma unroll
  for (int i = 0; i < kLanes; ++i) at[i] = 0;
  if (n <= 0) return;
  int len = n;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      if (((lanes >> i) & 1u) && src(at[i] + half) < a[i]) at[i] += half;
    }
    len -= half;
  }
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    if (((lanes >> i) & 1u) && src(at[i]) < a[i]) ++at[i];
  }
}

// The r-nearest rank of one lane against the window src[0, n), idx being
// the anchor's lower bound in it. Returns whether the key is satisfied and
// then widens the lane's window [a - below, a + above] to the kept extremes.
template <int R_MAX, typename Src>
__device__ __forceinline__ bool rank_lane(Src src, int n, int idx, int a, int r,
                                          int max_sep, unsigned& below, unsigned& above) {
  // p-th nearest predecessor / q-th nearest successor distances
  int dp[R_MAX], ds[R_MAX];
  int cnt = 0;
#pragma unroll
  for (int j = 1; j <= R_MAX; ++j) {
    int d = kBigDist;
    const int ip = idx - j;
    if (j <= r && ip >= 0) {
      const int v = src(ip);
      const long long dist = static_cast<long long>(a) - v;
      if (v != kSentinel && dist <= max_sep) d = static_cast<int>(dist);
    }
    dp[j - 1] = d;
    cnt += d != kBigDist;
    d = kBigDist;
    const int iq = idx + j - 1;
    if (j <= r && iq < n) {
      const int v = src(iq);
      const long long dist = static_cast<long long>(v) - a;
      if (v != kSentinel && dist <= max_sep) d = static_cast<int>(dist);
    }
    ds[j - 1] = d;
    cnt += d != kBigDist;
  }
  if (cnt < r) return false;
  // pred_p is kept iff p + #{succs ranked before it} <= r, and the same
  // for succ_q; the kept extremes extend the window
  int mn_d = 0, mx_d = 0;
#pragma unroll
  for (int p = 1; p <= R_MAX; ++p) {
    int before = 0;
#pragma unroll
    for (int q = 1; q <= R_MAX; ++q) {
      before += (ds[q - 1] < dp[p - 1]) || (ds[q - 1] == dp[p - 1] && q < p);
    }
    if (dp[p - 1] != kBigDist && p + before <= r) mn_d = max(mn_d, dp[p - 1]);
  }
#pragma unroll
  for (int q = 1; q <= R_MAX; ++q) {
    int before = 0;
#pragma unroll
    for (int p = 1; p <= R_MAX; ++p) {
      before += (dp[p - 1] < ds[q - 1]) || (dp[p - 1] == ds[q - 1] && p <= q);
    }
    if (ds[q - 1] != kBigDist && q + before <= r) mx_d = max(mx_d, ds[q - 1]);
  }
  below = max(below, static_cast<unsigned>(mn_d));
  above = max(above, static_cast<unsigned>(mx_d));
  return true;
}

// Rank every live lane against key window src[0, n) with multiplicity r,
// in the narrowest instance of the rank that holds r (r < R ranks exactly
// as the R-instance does, whose candidates past r read as BIG_DIST).
template <int R, typename Src>
__device__ __forceinline__ void rank_lanes(Src src, int n, const int (&at)[kLanes],
                                           const int (&a)[kLanes], int r, int max_sep,
                                           unsigned& live, unsigned (&below)[kLanes],
                                           unsigned (&above)[kLanes]) {
  if constexpr (R > 1) {
    if (r < R) {
      rank_lanes<R - 1>(src, n, at, a, r, max_sep, live, below, above);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    if (((live >> i) & 1u) &&
        !rank_lane<R>(src, n, at[i], a[i], r, max_sep, below[i], above[i])) {
      live &= ~(1u << i);
    }
  }
}

__device__ __forceinline__ int next_active(const int* nsr, int k, int Kn) {
  while (k < Kn && __ldg(nsr + k) <= 0) ++k;
  return k;
}

template <int R_MAX>
__global__ void __launch_bounds__(kThreads) window_join_kernel(
    const int* __restrict__ a_g, const int* __restrict__ ns_g, const int* __restrict__ ns_r,
    const int* __restrict__ st_cnt, const int* __restrict__ st_ext, const int* __restrict__ st_r,
    uint8_t* __restrict__ valid_out, int* __restrict__ lo_out, int* __restrict__ hi_out,
    int Kn, int Ks, int L, int max_sep) {
  __shared__ int s_buf[2][kCap];
  __shared__ int s_win[kWarps][2];  // [lo, hi) of the keys of the current group of keys
  __shared__ int s_min[kWarps], s_max[kWarps], s_live[kWarps];

  const int b = blockIdx.x;
  const int first = blockIdx.y * kTile + threadIdx.x;  // lane i: first + i * kThreads
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(b) * L;

  // per lane: the anchor and its window [a - below, a + above] (distances,
  // so 32 bits hold any int32 extension); bit i of live: lane i is valid
  int a[kLanes];
  unsigned below[kLanes], above[kLanes];
  unsigned live = 0u;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    const int l = first + i * kThreads;
    a[i] = l < L ? __ldg(a_g + row0 + l) : kSentinel;
    below[i] = above[i] = 0u;
    if (a[i] != kSentinel) live |= 1u << i;
  }
  const unsigned real = live;

  // stop constraints: elementwise, so they go first; their loads depend
  // only on the anchors, so they are in flight together
#pragma unroll 2
  for (int s = 0; s < Ks; ++s) {
    const int r = __ldg(st_r + b * Ks + s);
    if (r <= 0) continue;
    const int64_t off = (static_cast<int64_t>(b) * Ks + s) * L + first;
    int cnt[kLanes], ext[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      const bool in = (real >> i) & 1u;
      cnt[i] = in ? __ldg(st_cnt + off + i * kThreads) : 0;
      ext[i] = in ? __ldg(st_ext + off + i * kThreads) : 0;
    }
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      if (cnt[i] < r) live &= ~(1u << i);
      const long long e = ext[i];
      if (e < 0) {
        below[i] = max(below[i], static_cast<unsigned>(-e));
      } else {
        above[i] = max(above[i], static_cast<unsigned>(e));
      }
    }
  }

  // the tile's live anchors span [mn, mx]
  int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    if ((live >> i) & 1u) {
      mn = min(mn, a[i]);
      mx = max(mx, a[i]);
    }
  }
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  int n_live = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(__popc(live))));
  if ((threadIdx.x & 31) == 0) {
    s_min[warp] = mn;
    s_max[warp] = mx;
    s_live[warp] = n_live;
  }
  __syncthreads();
  n_live = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mn = min(mn, s_min[w]);
    mx = max(mx, s_max[w]);
    n_live += s_live[w];
  }

  if (n_live > 0) {  // block-uniform
    const int* nsr = ns_r + static_cast<int64_t>(b) * Kn;
    auto key_row = [&](int k) { return ns_g + (static_cast<int64_t>(b) * Kn + k) * L; };
    // windows of the active keys of the group of keys holding key k, one warp each
    auto find_windows = [&](int k) {
      const int kk = k / kWarps * kWarps + warp;
      if (kk < Kn && __ldg(nsr + kk) > 0) {
        int w_lo[2] = {0, 0}, w_hi[2] = {L, L};
        const long long x[2] = {static_cast<long long>(mn) - max_sep,
                                static_cast<long long>(mx) + max_sep + 1};
        warp_lower_bounds(key_row(kk), w_lo, w_hi, x);
        if ((threadIdx.x & 31) == 0) {
          s_win[warp][0] = w_lo[0];
          s_win[warp][1] = w_lo[1];
        }
      }
    };
    // key k's window, staged when it fits a buffer
    auto stage = [&](int k, int* buf) {
      const int w0 = s_win[k % kWarps][0];
      const int n = s_win[k % kWarps][1] - w0;
      if (n > kCap) return;
      const int* src = key_row(k) + w0;
      for (int j = threadIdx.x; j < n; j += kThreads) cp_async4(buf + j, src + j);
    };

    int k = next_active(nsr, 0, Kn);
    if (k < Kn) {
      find_windows(k);
      __syncthreads();
      stage(k, s_buf[0]);
    }
    cp_async_commit();
    int cur = 0;
    while (k < Kn) {
      const int w0 = s_win[k % kWarps][0];
      const int n = s_win[k % kWarps][1] - w0;
      const int kn = next_active(nsr, k + 1, Kn);
      if (kn < Kn) {
        if (kn / kWarps != k / kWarps) {
          __syncthreads();  // all hold key k's window before its group is replaced
          find_windows(kn);
          __syncthreads();
        }
        stage(kn, s_buf[cur ^ 1]);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // key k's window is in shared memory

      const int r = __ldg(nsr + k);
      int at[kLanes];
      if (n <= kCap) {
        const SharedRow src{s_buf[cur]};
        lower_bounds(src, n, a, live, at);
        rank_lanes<R_MAX>(src, n, at, a, r, max_sep, live, below, above);
      } else {
        const GlobalRow src{key_row(k) + w0};
        lower_bounds(src, n, a, live, at);
        rank_lanes<R_MAX>(src, n, at, a, r, max_sep, live, below, above);
      }
      if (!__syncthreads_or(live != 0u)) break;  // the live skip; also frees s_buf[cur]
      k = kn;
      cur ^= 1;
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    const int l = first + i * kThreads;
    if (l < L) {
      valid_out[row0 + l] = (live >> i) & 1u;
      lo_out[row0 + l] = static_cast<int>(static_cast<long long>(a[i]) - below[i]);
      hi_out[row0 + l] = static_cast<int>(static_cast<long long>(a[i]) + above[i]);
    }
  }
}

template <int R_MAX>
void launch(const int* a_g, const int* ns_g, const int* ns_r, const int* st_cnt,
            const int* st_ext, const int* st_r, uint8_t* valid, int* lo, int* hi,
            int B, int Kn, int Ks, int L, int max_sep, cudaStream_t stream) {
  // rows vary fastest, so every row's first tiles, where a SENTINEL-padded
  // anchor row keeps its anchors, are scheduled before any row's empty tail
  const dim3 grid(B, (L + kTile - 1) / kTile);
  window_join_kernel<R_MAX><<<grid, kThreads, 0, stream>>>(
      a_g, ns_g, ns_r, st_cnt, st_ext, st_r, valid, lo, hi, Kn, Ks, L, max_sep);
}

}  // namespace

extern "C" int nearest_r_window_join(const int* a_g, const int* ns_g, const int* ns_r,
                                     const int* st_cnt, const int* st_ext, const int* st_r,
                                     uint8_t* valid, int* lo, int* hi, int B, int Kn,
                                     int Ks, int L, int max_sep, int r_max, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r_max) {
#define REPRO_CASE(R)                                                                      \
  case R:                                                                                  \
    launch<R>(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, valid, lo, hi, B, Kn, Ks, L, max_sep, \
              s);                                                                          \
    break;
    REPRO_CASE(1)
    REPRO_CASE(2)
    REPRO_CASE(3)
    REPRO_CASE(4)
    REPRO_CASE(5)
    REPRO_CASE(6)
    REPRO_CASE(7)
    REPRO_CASE(8)
#undef REPRO_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
