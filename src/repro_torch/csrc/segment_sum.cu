// Segment sum over sorted segment ids for Hopper (sm_90a), float32: the
// scatter-adds of the EGNN, forward and backward.
//
// Replaces no Pallas kernel: the reference aggregates with
// jax.ops.segment_sum (src/repro/models/gnn.py:70-72), which XLA lowers to
// a scatter-add, and XLA differentiates its gathers h[src], h[dst],
// x[src], x[dst] (:62-63) into more scatter-adds. On the card the port
// runs all of them here instead of index_add_, whose float32 atomics add
// in an order that changes from run to run, so a replayed GNN step equals
// the step it replays and the CPU's index_add_ bit for bit.
//
// Function: out[r, :] = sum of data[e, :] over the edges e with
// segment_ids[e] == r, in e order (ids outside [0, R) add nothing), as
// csrc/segment_sum.cuh sets out with rows = data, div = 1 and no weights.
// What bounds it, and the design: see the header.
//
// Interface. A plain C function that launches on the caller's stream (the
// long rows on a second stream joined back to it) and returns the first
// CUDA error; the Python wrapper (kernels/segment_sum/ops.py) sorts the
// ids, builds the offsets and the list of long segments, allocates the
// output, checks devices, types, shapes and sizes, and raises when the
// code is not 0.

#include "segment_sum.cuh"

// data (E, C) float32; order (E,) int32, the stable sort of the segment
// ids; offsets (R + 1,) int32; long_rows (n_long,) int32, the segments of
// more than long_min terms and -1 after them (null when n_long is 0); out
// (R, C) float32, every row written.
extern "C" int segment_sum(const float* data, const int* order, const int* offsets,
                           const int* long_rows, int n_long, int long_min, float* out, int R,
                           int C, void* stream) {
  return segsum::launch(data, order, nullptr, offsets, long_rows, n_long, long_min, out, R, C, 1,
                        static_cast<cudaStream_t>(stream));
}
