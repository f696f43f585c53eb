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
// Design. One thread per anchor lane. The lane applies the stop fold, then
// for each active key a lower-bound binary search into the key's row, a
// read of its r_max predecessors and r_max successors, and the counting
// rank of the plain version. A lane stops as soon as it is invalid; its
// lo/hi are then unspecified, which callers never read. The TPU kernel's
// delta-presence bitmask scratch and its scalar-prefetched b-tile windows
// are not carried over: each lane reads only the candidates it needs.
//
// What bounds it. The function is memory-bound on an H100: it reads each
// anchor, key row and stop row once and writes 9 bytes per lane, against
// a few dozen integer operations per (lane, key). Today the binary search
// is latency-bound instead: each of its ~log2(L) steps is a dependent load
// from L2, and neighbouring lanes repeat nearly the same search path.
//
// Interface. A plain C function that launches on the caller's stream and
// returns cudaGetLastError(); the Python wrapper allocates the outputs,
// checks devices, types, shapes and contiguity, and raises when the code
// is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 2147483647;
constexpr int kBigDist = 1 << 30;  // "no candidate" (BIG_DIST of the plain version)
constexpr int kThreads = 256;

__device__ __forceinline__ int lower_bound(const int* __restrict__ row, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int R_MAX>
__global__ void __launch_bounds__(kThreads) window_join_kernel(
    const int* __restrict__ a_g, const int* __restrict__ ns_g, const int* __restrict__ ns_r,
    const int* __restrict__ st_cnt, const int* __restrict__ st_ext, const int* __restrict__ st_r,
    uint8_t* __restrict__ valid_out, int* __restrict__ lo_out, int* __restrict__ hi_out,
    int Kn, int Ks, int L, int max_sep) {
  const int b = blockIdx.y;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  const int64_t lane = static_cast<int64_t>(b) * L + l;
  const int a = a_g[lane];
  bool ok = a != kSentinel;
  long long lo = a, hi = a;

  // stop constraints: elementwise, so they go first and may end the lane
  for (int s = 0; ok && s < Ks; ++s) {
    const int r = st_r[b * Ks + s];
    if (r <= 0) continue;
    const int64_t off = (static_cast<int64_t>(b) * Ks + s) * L + l;
    if (st_cnt[off] < r) {
      ok = false;
      break;
    }
    const long long e = static_cast<long long>(a) + st_ext[off];
    lo = min(lo, e);
    hi = max(hi, e);
  }

  for (int k = 0; ok && k < Kn; ++k) {
    const int r = ns_r[b * Kn + k];
    if (r <= 0) continue;  // inactive key: does not constrain
    const int* row = ns_g + (static_cast<int64_t>(b) * Kn + k) * L;
    const int idx = lower_bound(row, L, a);
    // p-th nearest predecessor / q-th nearest successor distances
    int dp[R_MAX], ds[R_MAX];
    int cnt = 0;
#pragma unroll
    for (int j = 1; j <= R_MAX; ++j) {
      int d = kBigDist;
      const int ip = idx - j;
      if (j <= r && ip >= 0) {
        const int v = __ldg(row + ip);
        const long long dist = static_cast<long long>(a) - v;
        if (v != kSentinel && dist <= max_sep) d = static_cast<int>(dist);
      }
      dp[j - 1] = d;
      cnt += d != kBigDist;
      d = kBigDist;
      const int iq = idx + j - 1;
      if (j <= r && iq < L) {
        const int v = __ldg(row + iq);
        const long long dist = static_cast<long long>(v) - a;
        if (v != kSentinel && dist <= max_sep) d = static_cast<int>(dist);
      }
      ds[j - 1] = d;
      cnt += d != kBigDist;
    }
    if (cnt < r) {
      ok = false;
      break;
    }
    // pred_p is kept iff p + #{succs ranked before it} <= r, and the
    // same for succ_q; the kept extremes extend the window
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
    lo = min(lo, static_cast<long long>(a) - mn_d);
    hi = max(hi, static_cast<long long>(a) + mx_d);
  }

  valid_out[lane] = ok ? 1 : 0;
  lo_out[lane] = static_cast<int>(lo);
  hi_out[lane] = static_cast<int>(hi);
}

template <int R_MAX>
void launch(const int* a_g, const int* ns_g, const int* ns_r, const int* st_cnt,
            const int* st_ext, const int* st_r, uint8_t* valid, int* lo, int* hi,
            int B, int Kn, int Ks, int L, int max_sep, cudaStream_t stream) {
  const dim3 grid((L + kThreads - 1) / kThreads, B);
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
