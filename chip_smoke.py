"""Smoke run of the PyTorch port on one NVIDIA card.

    python chip_smoke.py [--report PATH] [--parent-csrc DIR]

Builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together) and drives thirteen paths:

- the kernel library (intersect, compressed intersect, proximity join,
  embedding bag): each kernel is held against its plain PyTorch version
  on the card over seeded replay families (the compressed one from int16,
  uint16 and misaligned deltas, its streams packed on the card equal to
  the host's); then, with every launch count set to 0, each entry point
  runs once per full-width shape (the sorted lists of ``kernel_bench.py``
  and ``qt1_heavy`` and a rarer list against ``qt1_heavy``'s; the
  compressed intersect both from host arrays and from streams packed on
  the card; the two-tower-retrieval bag), its results are checked against
  the plain version and an oracle, and kernel, wrapper, plain version and
  library call are timed;
- the serving path: the nearest-r window join is held against its plain
  version (replayed case families, the top-of-ladder shapes of the
  default ServeConfig and two density-skewed shapes at the same width)
  and timed, then mixed QT1-QT5 traffic is served through
  ``SearchService`` on the card with the counts set to 0, and its records
  must equal a CPU run of the same service;
- the compressed serving path: the same traffic through
  ``SearchService(ServeConfig(compressed=True))`` on the card, with the
  counts set to 0, cold then warm, with the compressed-row cache and
  without it (the records must equal the CPU raw run), then a corpus whose
  64-posting blocks span more than uint16 (served as offsets); the warm
  service under a closed loop and an open-loop Poisson trace at half its
  capacity (``serving/load.py``); and each step family at the default
  ladder's top bucket on the raw, delta and offsets payloads, whose
  outputs must agree bit for bit with each other and with the CPU raw
  step, timed with their host-to-device bytes;
- the segmented path: the same corpus streamed into a background
  ``SegmentedIndex`` and churned (adds, deletes, seals, size-tiered merges
  on the executor's thread, refreshes and a quiesce), served on the card
  raw and compressed after each refresh, then with ``serve_memtable``
  over unsealed adds, then saved, loaded and served again; every drain's
  records must equal a CPU service's over the same source refreshed at
  the same point;
- the doc-sharded path: the serve corpus and queries through
  ``SearchService`` over (1, 4) and (1, 2) meshes (raw) and (1, 4)
  (compressed), the shards on this card (and on four cards when four are
  visible), cold then warm; every drain equals the port's sharded CPU
  service and, as sets, the unsharded drain, and the window join is
  launched once per shard per qt34/qt5 step call; then the sharded step
  at the top bucket against the unsharded one, timed;
- the tuner: a two-by-two sweep (``repro_torch.tune``) on the serving
  CLI's default corpus, whose winning artifact
  ``python -m repro_torch.launch.serve --config`` then serves on the card;
- the model zoo's serving paths, through ``launch/steps.py``'s built
  steps at full width with seeded random weights, the counts set to 0:
  two-tower-retrieval (V 10M x D 256) at serve_p99, serve_bulk and
  retrieval_cand, its user tower's bag through the embedding-bag kernel
  (one launch per tower); din, bert4rec and sasrec at serve_p99 and
  retrieval_cand (din's cut to 65,536 candidates); stablelm-1.6b prefill
  at B 4 x S 4096, decode at B 4 on a 32,768-row cache (bf16, then int8)
  and granite-moe-1b-a400m prefill and decode; the continuous batcher on
  a reduced float32 LM. The two-tower user vectors must equal the tower
  fed by the plain bag bit for bit, every recsys output a CPU run of the
  port on the same weights, stablelm's decode at S its prefill(S + 1)
  (cosine >= 0.999), the int8 cache the bf16 one (test_kv_int8.py's
  thresholds) and the batcher's outputs the CPU batcher's;
- training: the embedding bag's backward kernel (a stable sort of the
  ids, then the sorted segment sum of ``csrc/segment_sum.cuh``) held to
  its plain version on the host, to the bit, over the forward's float32
  replay families and bag sets of one repeated row;
  two-tower-retrieval's train_batch at full width (B 32,768): one step's
  gradients through both bag kernels twice (every leaf equal to the bit),
  then against the same step through the plain bag under autograd, the
  backward at that shape equal to the host's plain version and timed
  against its bound, the plan (sort and offsets), the plain version and
  F.embedding_bag's backward; the segment sum at the item lookup's
  backward (32,768 ids, C 256 into 10M rows) against its bound, the plan,
  ``index_add_`` and ``index_put_(..., accumulate=True)``; 3 built steps
  with the counts set to 0 (one forward and one backward launch of the
  bag a step, and a segment sum for each lookup's backward, item and
  category), then the same 3 steps from the state materialized anew from
  the seed (losses and grad norms equal);
  two gradient calls from one state, every leaf compared with
  ``torch.equal``, of stablelm-1.6b at B 8 x S 4096 and granite-moe at B
  2 x S 2048 (full width, the bf16 gather, Zipf-drawn tokens);
  stablelm-1.6b train_4k at full width cut to B 8 x S 4096 (two
  microbatches), and cut to 2 layers in float32, one step's loss and
  gradients against the host's; every reduced train cell against the
  port's CPU run; the supervisor (``launch/train.py`` ``train_arch``, a
  failure injected at step 15) resuming with an uninterrupted run's
  losses, equal to the bit, then the train CLI; and compressed data
  parallelism (exact, int8, top-k) on a (4,) mesh of this card, and of
  four cards when four are visible, against
  ``tests/multidevice/check_compressed_dp.py``'s thresholds;
- the GNN: the segment-sum kernel held to its plain version on the host,
  to the bit, over replay families; the EGNN (4 layers x 64) through its
  built train steps at full_graph_sm, minibatch_lg and molecule, with the
  counts set to 0, each against the same steps on the host and against a
  replay from the seeded state (to the bit); minibatch_lg fed by
  ``minibatch_stream`` over a Reddit-sized ``CSRGraph.random`` (losses
  finite and falling); then the kernel at minibatch_lg's widths (64, 3,
  1) with a uniform and the sampler's src, and at C 64 with a power-law
  src, timed against its bounds (bytes, and the chain of the longest
  segment's adds), the plain version and ``index_add_``;
- the search arch: ``build_search_step`` at qt1_p99, qt1_serve and
  qt1_heavy, raw, offsets and delta payloads, timed warm, the top-k
  records of the first rows equal to the same step on the host;
- the multi-device model paths over a (1, 4) mesh of this card (and of
  four cards when four are visible), each against the same step
  unsharded on the card and timed against it, with the counts set to 0
  around the sharded runs: two-tower-retrieval (V 10M x D 256) with its
  tables row-sharded at serve_p99, serve_bulk (user vectors within
  float32 rounding, the bag launched once per shard) and retrieval_cand
  (top-k ids equal where not tied), its train_batch (B 32,768: 3 steps
  within 1e-5 of the unsharded steps, the bag and its backward once per
  shard a step, peak memory, a replay from the seed to the bit), each
  shard's bag and backward kernel alone, at its shard's inputs equal to
  its plain version to the bit; din and bert4rec at serve_p99 (equal to
  the bit); the EGNN edge-sharded at full_graph_sm and minibatch_lg
  (within 1e-4, 4x the segment sums, a replay to the bit) and on the
  sampler's batches, each edge shard's segment sum alone and equal to
  the host's plain version to the bit (node 0's long padding segment in
  the last shard); granite-moe-1b-a400m's prefill with its 32 experts
  over 4 ranks (cosine and argmax agreement against tp 1) and two
  gradient calls (every leaf equal); the public compressed all-reduce
  means equal to the host's; then the copies between distinct devices:
  the reduced two-tower and EGNN train steps on a (1, 2) mesh of this
  card and the host, replayed from the seed with every leaf equal to the
  bit and within tolerance of the (1, 1) step on the card; the reduced
  four recsys archs data-parallel (train, serve, retrieval) on a (2, 1)
  and a (2, 2) mesh whose second data shard is the host, every table and
  leaf placed once per data shard, the host's rows through its own dense
  layers: outputs within 1e-5 of the card's (1, 1) step, every replica
  on the card within 1e-5 of its replica on the host after each train
  step (the host's float32 root is not the card's), a replay from the
  seed equal in every leaf (deterministic algorithms off: every lookup's
  backward is the sorted segment sum, on the host too), and the same
  train steps on the card alone with replicas placed by hand, equal to
  the bit; ``parallel.all_reduce`` and ``all_reduce_rows`` side by side
  on two 10M x 256 float32 table gradients on this card, each a (2, 1)
  data shard's item lookups of two-tower's B 32,768 batch: equal to the
  bit, each timed; two-tower's train_batch at full width (B 32,768)
  data-parallel on a (2, 1) mesh of this card (and a (4, 1) mesh of four
  cards when four are visible, every replica equal to the bit, the tables
  summed over their touched rows) against (1, 1): losses within 1e-5,
  each data shard's bag and backward once a step, time, peak memory and
  ``sum_replicas`` synchronised;
- the LM's tensor parallelism and FSDP (the tp phase, no kernel on its
  path): qwen1.5-32b at full width, its depth cut to 4 layers, through
  its built prefill (B 2 x S 4096) and decode steps (B 4 on an S 16,384
  cache, bf16 and int8) on a (1, 4) mesh of this card (attention by whole
  heads, the cache by kv heads) and on a (1, 16) mesh (attention split
  inside heads, each shard's cache block S / 16 positions), each against
  the (1, 1) steps (logits' cosine and top-1 agreement, the caches'
  cosine per kv head); stablelm-1.6b's train step on a (2, 2) mesh (FSDP x TP) against
  the (1, 1) step (loss and grad norm), replayed from one state to the
  bit; the reduced stablelm and phi3.5-moe in float32 on a (1, 2) mesh of
  this card and the host (train, prefill, decode) within 1e-5 of the
  (1, 1) card steps, replayed to the bit;
- the analysis tools (the analysis phase): each of seven cells (stablelm
  prefill B 4 x S 4096, bf16 decode B 4 on 32,768 rows and train B 8 x S
  4096; two-tower serve_bulk and train_batch B 32,768; the EGNN's
  minibatch_lg; the search arch's qt1_heavy) counted by the dry run on a
  (1, 1) mesh of ``meta``, then its built step run warm on the card with
  the counts at 0: median step time, peak memory, the roofline bound of
  the count and the share bound / time, which must not exceed 1.05; the
  reckoned argument bytes must not exceed the measured peak, each LM
  cell's reckoned peak is printed beside the measured one, and each
  kernel must be launched as often as the count says; the counted bytes
  of the bag's backward and the segment sum equal PERF.md's bounds;
  stablelm's layer probe at the prefill shape (24 x its FLOPs within the
  step's); and one prefill step under ``torch.profiler``, its top device
  ops and the device's busy and idle shares.

Each path must have launched each of its kernels. Times are medians of
CUDA events: kernel, plain and library times are device times (the
calls are queued behind a sleep kernel), wrapper times are call times as
the host issues them; each line also gives the wrapper minus the
kernel, the host's share of a call. With ``--parent-csrc DIR``, the
nearest-r, embedding-bag, raw and compressed intersect and proximity
kernels built from ``DIR/{nearest_r,embedding_bag,intersect,proximity}.cu``
(an earlier version with the same C entry points) and the segment sum of
``DIR/segment_sum.cu`` (an earlier entry point, with no long-segment list)
are timed at each full-width shape too, in turns with the current ones:
earlier, current, current, earlier.

ogb_products and qt1_bulk are reckoned, not run (they do not fit one
card). The second-to-last line of standard output is the kernels JSON line, the
last line ``{"ok": true, "device": {...}}``. The script fails (non-zero
exit, no result line) without a card, and outside a checkout of the repo.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores; no int32 row is published beside it
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
MAX_SEP, R_MAX = 5, 4  # ServeConfig defaults: max_distance=5, r_max=4
N_DOCS, N_QUERIES = 20_000, 256
LOAD_CLOSED, LOAD_SECONDS = 256, 2.0  # closed-loop requests; open-loop trace length
SEG_MEMTABLE, SEG_FANOUT = 512, 4  # SegmentedIndex's default memtable_docs, tier_fanout=4
SEG_SEED, SEG_DELETE, SEG_ROUNDS = 0.8, 0.15, 2  # seeded share, deleted share, churn rounds
SEG_LIVE_ADDS = 64  # unsealed documents the live-memtable drains see (< SEG_MEMTABLE)
SEG_LIVE_QUERIES = 64  # mixed queries sampled from those documents, added to the drains
SEG_WAIT_S = 900.0  # the longest a quiesce may take
COMPRESSED_BL = (64, 65536)  # the default ServeConfig's top batch and L bucket
COMPRESSED_K = {"qt1": 2, "qt2": 3, "qt34": (4, 0), "qt5": (3, 3)}  # ServeConfig's k_*
# the tune phase: the serving CLI's default corpus (--n-docs), two
# MaxDistance values by two max_batch values, a mixed workload
TUNE_DOCS, TUNE_DISTANCES, TUNE_BATCHES, TUNE_QUERIES = 3000, (5, 7), (32, 64), 128
TIMING_RUNS = 25
WIN_CAP = 4096  # key values a block of csrc/nearest_r.cu stages in shared memory (kCap)
DENSE_ROWS = ((1, 6), (1 / 2, 1))  # gaps and fill (shares of L) of a frequent lemma's row
SPARSE_ROWS = ((16, 96), (1 / 32, 1 / 16))
# nearest-r full-width shapes: (tag, (B, Kn, Ks, L), None for the ladder
# draw or (seed, anchor rows, key rows))
NR_SHAPES = (("qt34", (64, 4, 0, 65536), None),
             ("qt5", (64, 3, 3, 65536), None),
             ("qt34 dense-anchor", (64, 4, 0, 65536), (2025, DENSE_ROWS, SPARSE_ROWS)),
             ("qt5 sparse-anchor", (64, 3, 3, 65536), (2026, SPARSE_ROWS, DENSE_ROWS)))
SLEEP_CYCLES_PER_S = 2.0e9  # above the H100's top SM clock, so a hold lasts at least as asked
SOURCES = ("nearest_r", "intersect", "proximity", "embedding_bag", "segment_sum")  # csrc/<name>.cu
# (tag, Na, Nb): kernel_bench.py's full shape and qt1_heavy's posting length
# (configs/proximity_search.py)
FULL_SHAPES = (("kernel_bench", 131_072, 1_048_576), ("qt1_heavy", 1_048_576, 1_048_576))
# the Equalize of a rarer lemma against qt1_heavy's b: (tag, draws into
# [0, 4 Nb), so its delta16 spans fit uint16). Its A-blocks need more b
# than a block stages, so it drives the kernels' global branch.
RARE_A = ("qt1 rare-a", 16_384)
LIST_CAP = 4096  # b-values a block of csrc/sorted_window.cuh stages (kCap)
PARENT_SOURCES = ("nearest_r", "embedding_bag", "intersect", "proximity", "segment_sum")
PROX_D = 5  # MaxDistance's default
# two-tower-retrieval (configs/recsys_archs.py): n_items, embed_dim, hist_len;
# batches: RECSYS_SHAPES serve_p99 and a larger one
BAG_WIDTHS = {"V": 10_000_000, "D": 256, "S": 50}
BAG_BATCHES = (512, 4096)


def log(*args) -> None:
    print(*args, flush=True)


def header() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return smi


def _events_ms(fn, reps: int, hold_s: float = 0.0) -> float:
    """Milliseconds per call of ``reps`` back-to-back calls between two
    CUDA events. With ``hold_s``, a sleep kernel first holds the stream
    that long, so the host has enqueued every call before the first
    event fires and the events see device time alone."""
    if hold_s:
        torch.cuda._sleep(int(hold_s * SLEEP_CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _timing(fn, runs: int, device_only: bool, sample_ms: float = 1.0) -> float:
    t0, n = time.perf_counter(), 0
    while n < 3 or time.perf_counter() - t0 < 0.05:  # the card leaves its idle clocks
        fn()
        torch.cuda.synchronize()
        n += 1
    reps = max(1, min(100, int(sample_ms / max(_events_ms(fn, 1), 1e-3))))
    hold_s = 0.0
    if device_only:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        hold_s = 1.5 * (time.perf_counter() - t0) + 5e-4
        torch.cuda.synchronize()
    return statistics.median(_events_ms(fn, reps, hold_s) for _ in range(runs))


def device_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median device time of one call of ``fn``, by CUDA events: after a
    warm-up of at least 3 calls and 50 ms, each sample times as many
    back-to-back calls as fill 1 ms, enqueued behind a sleep kernel so that
    the host's launch rate leaves no gaps between them."""
    return _timing(fn, runs, device_only=True)


def call_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median time of one call of ``fn`` as the host issues it back to
    back, by CUDA events: device time plus whatever host work (checks,
    packing, launch) keeps the card waiting."""
    return _timing(fn, runs, device_only=False)


# -- the nearest-r window join ------------------------------------------------
def _rows(rng, b, kn, l, stride, p_empty=0.15):
    """Strictly increasing SENTINEL-padded rows; a small stride makes
    equal predecessor/successor distances (the tie cases) common."""
    from repro_torch.kernels.common import SENTINEL

    out = np.full((b, kn, l), SENTINEL, np.int32)
    for i in range(b):
        for k in range(kn):
            if rng.random() < p_empty:
                continue
            n = int(rng.integers(1, l + 1))
            out[i, k, :n] = np.cumsum(rng.integers(1, stride + 1, n))
    return out


def gap_rows(rng, n_rows, L, gaps, fill):
    """Strictly increasing SENTINEL-padded rows: gaps drawn from
    ``gaps`` (inclusive), each row filled to a length drawn from ``fill``
    (inclusive)."""
    from repro_torch.kernels.common import SENTINEL

    g = rng.integers(gaps[0], gaps[1] + 1, (n_rows, L), dtype=np.int64)
    vals = np.cumsum(g, axis=1) + 1000
    n = rng.integers(fill[0], fill[1] + 1, n_rows)
    vals[np.arange(L)[None, :] >= n[:, None]] = SENTINEL
    return vals.astype(np.int32)


def replay_cases():
    """Seeded numpy replays of the case families, as (name, arrays,
    max_sep, r_max): ties, every r in 0..r_max for every r_max the kernel
    is built for, empty rows, SENTINEL anchors, the stop fold, ragged L,
    L off the kernel's 256-thread and 1024-lane multiples, anchors
    shuffled within their row, key windows wider than one shared-memory
    buffer (searched in global memory), a few anchors over a wide dense
    window, and blocks whose lanes all go invalid at the first key."""
    from repro_torch.kernels.common import SENTINEL

    cases = []
    for seed in range(12):
        rng = np.random.default_rng(seed)
        b, kn, l = 3, 3, (300 if seed % 2 else 256)
        stride = (1, 3, 6)[seed % 3]
        a = _rows(rng, b, 1, l, stride)[:, 0]
        ns = _rows(rng, b, kn, l, stride)
        ns_r = rng.integers(0, R_MAX + 1, (b, kn)).astype(np.int32)
        arrays = [a, ns, ns_r]
        if seed % 3 == 2:
            arrays += [rng.integers(0, 4, (b, 2, l)).astype(np.int32),
                       rng.integers(-MAX_SEP, MAX_SEP + 1, (b, 2, l)).astype(np.int32),
                       rng.integers(0, 3, (b, 2)).astype(np.int32)]
        cases.append((f"random{seed}", arrays, 1 + seed % 7, R_MAX))
    for r_max in range(1, 9):
        for r in range(r_max + 1):
            rng = np.random.default_rng(100 + 10 * r_max + r)
            a = _rows(rng, 2, 1, 200, 2)[:, 0]
            ns = _rows(rng, 2, 3, 200, 2)
            cases.append((f"r_max={r_max} r={r}", [a, ns, np.full((2, 3), r, np.int32)],
                          MAX_SEP, r_max))
    a = np.full((2, 8), SENTINEL, np.int32)
    a[0, :3] = [10, 20, 30]
    ns = np.full((2, 2, 8), SENTINEL, np.int32)
    ns[0, 1, :4] = [8, 12, 19, 33]
    cases.append(("empty+sentinel", [a, ns, np.ones((2, 2), np.int32)], 3, R_MAX))
    tie_a = np.array([[100, SENTINEL]], np.int32)
    tie_ns = np.array([[[98, 102]]], np.int32)
    for r in (1, 2):
        cases.append((f"tie r={r}", [tie_a, tie_ns, np.array([[r]], np.int32)], 5, R_MAX))

    def mixed_r(rng, b, kn):
        return rng.integers(0, R_MAX + 1, (b, kn)).astype(np.int32)

    for l in (1, 7, 255, 1000, 1025, 3071):  # off every block multiple
        rng = np.random.default_rng(400 + l)
        a = gap_rows(rng, 2, l, (1, 6), (max(1, l // 2), l))
        ns = gap_rows(rng, 6, l, (1, 6), (max(1, l // 2), l)).reshape(2, 3, l)
        cases.append((f"L={l}", [a, ns, mixed_r(rng, 2, 3)], MAX_SEP, R_MAX))
    for l, tag in ((300, "staged"), (6000, "wider than a buffer")):
        rng = np.random.default_rng(500 + l)
        a = gap_rows(rng, 2, l, (1, 6), (l, l))
        a[:, l - 20:] = SENTINEL
        for row in a:  # shuffled anchors, SENTINEL lanes among them
            rng.shuffle(row)
        ns = gap_rows(rng, 6, l, (1, 6), (l // 2, l)).reshape(2, 3, l)
        cases.append((f"shuffled anchors, {tag}", [a, ns, mixed_r(rng, 2, 3)], MAX_SEP, R_MAX))
    for seed in range(3):  # sparse anchors over dense keys: windows of ~5000 values
        rng = np.random.default_rng(600 + seed)
        l = 6000
        a = gap_rows(rng, 2, l, (4, 12), (1100, 3000))
        ns = gap_rows(rng, 6, l, (1, 2), (l // 2, l)).reshape(2, 3, l)
        arrays = [a, ns, mixed_r(rng, 2, 3)]
        if seed == 2:
            arrays += [rng.integers(0, 4, (2, 2, l)).astype(np.int32),
                       rng.integers(-MAX_SEP, MAX_SEP + 1, (2, 2, l)).astype(np.int32),
                       rng.integers(0, 3, (2, 2)).astype(np.int32)]
        cases.append((f"window wider than a buffer {seed}", arrays, MAX_SEP, R_MAX))
    rng = np.random.default_rng(650)  # a few anchors over a dense row: searched in place
    l = 30000
    a = np.full((2, l), SENTINEL, np.int32)
    a[:, :12] = np.sort(rng.choice(np.arange(2000, 100_000), (2, 12), replace=False), axis=1)
    ns = gap_rows(rng, 6, l, (1, 6), (l - 100, l)).reshape(2, 3, l)
    cases.append(("few anchors, window searched in place", [a, ns, mixed_r(rng, 2, 3)],
                  MAX_SEP, R_MAX))
    rng = np.random.default_rng(700)  # every lane of every block dies at the first key
    l = 3000
    a = gap_rows(rng, 2, l, (20, 30), (l, l))
    far = np.where(a != SENTINEL, a + 10, SENTINEL).astype(np.int32)  # 10 > max_sep away
    ns = np.stack([far, gap_rows(rng, 2, l, (1, 6), (l, l)),
                   gap_rows(rng, 2, l, (1, 6), (l, l))], axis=1)
    cases.append(("all lanes invalid at key 0", [a, ns, np.ones((2, 3), np.int32)],
                  MAX_SEP, R_MAX))
    ns_empty = ns.copy()
    ns_empty[:, 0] = SENTINEL
    cases.append(("empty first key", [a, ns_empty, np.ones((2, 3), np.int32)], MAX_SEP, R_MAX))
    return cases


def ladder_case(rng, B, Kn, Ks, L, anchor=DENSE_ROWS, keys=DENSE_ROWS):
    """Top-of-ladder inputs: strictly increasing rows with gaps like a
    frequent lemma's packed postings (1..6 positions), filled to between
    half and all of the bucket, every key and stop active, multiplicities
    mostly 1 as in real queries. ``anchor`` and ``keys`` give other gaps
    and fills (as shares of L) for the density-skewed shapes."""

    def rows(n_rows, spec):
        gaps, (f0, f1) = spec
        return gap_rows(rng, n_rows, L, gaps, (int(L * f0), int(L * f1)))

    a = rows(B, anchor)
    ns = rows(B * Kn, keys).reshape(B, Kn, L)
    ns_r = rng.choice(np.array([1, 1, 1, 2, 3, 4], np.int32), (B, Kn))
    arrays = [a, ns, ns_r]
    if Ks:
        arrays += [rng.integers(0, 5, (B, Ks, L)).astype(np.int32),
                   rng.integers(-MAX_SEP, MAX_SEP + 1, (B, Ks, L)).astype(np.int32),
                   rng.integers(1, 3, (B, Ks)).astype(np.int32)]
    return arrays


def compare(got, want) -> tuple[bool, int]:
    """Exact agreement on (valid, lo[valid], hi[valid]); returns
    (agrees, largest absolute lo/hi difference on valid lanes)."""
    gv, gl, gh = (x.cpu() for x in got)
    wv, wl, wh = (x.cpu() for x in want)
    same_valid = torch.equal(gv, wv)
    m = wv
    err = 0
    if m.any():
        err = int(max((gl[m].long() - wl[m].long()).abs().max(),
                      (gh[m].long() - wh[m].long()).abs().max()))
    return same_valid and err == 0, err


def reached_pairs(ts, max_sep: int, r_max: int):
    """The (lane, active key) pairs this data needs ranked: lanes still
    valid after the stop fold and the keys before, in key order (a lane
    ends at its first unmet key). Also returns the lanes valid after the
    stop fold alone."""
    from repro_torch.kernels.nearest_r import window_join_plain

    a, ns, ns_r = ts[:3]
    pairs, after_stops = 0, None
    for k in range(ns.shape[1]):
        prefix = ns_r.clone()
        prefix[:, k:] = 0
        alive = window_join_plain(a, ns, prefix, *ts[3:], max_sep=max_sep, r_max=r_max)[0]
        if after_stops is None:
            after_stops = alive
        pairs += int((alive & (ns_r[:, k:k + 1] > 0)).sum())
    return pairs, after_stops.cpu().numpy()


def needed_key_values(arrays, max_sep: int) -> int:
    """Key values within max_sep of a real anchor of their row, over the
    active (row, key) pairs: all of a key row that any lane can need."""
    from repro_torch.kernels.common import SENTINEL

    a, ns, ns_r = arrays[:3]
    need = 0
    for b in range(ns.shape[0]):
        anchors = np.sort(a[b][a[b] != SENTINEL]).astype(np.int64)
        if anchors.size == 0:
            continue
        for k in np.nonzero(ns_r[b] > 0)[0]:
            v = ns[b, k][ns[b, k] != SENTINEL].astype(np.int64)
            i = np.searchsorted(anchors, v)
            near = np.minimum(np.abs(v - anchors[np.clip(i - 1, 0, anchors.size - 1)]),
                              np.abs(anchors[np.clip(i, 0, anchors.size - 1)] - v))
            need += int((near <= max_sep).sum())
    return need


def window_sizes(arrays, after_stops, max_sep: int) -> np.ndarray:
    """Key values in the window of each (block, active key) that the
    kernel ranks: a block's tile of TILE lanes, its live anchors after
    the stop fold, [lb(min - max_sep), lb(max + max_sep + 1)) of the row."""
    from repro_torch.kernels.nearest_r.ops import TILE

    a, ns, ns_r = arrays[:3]
    B, Kn, L = ns.shape
    sizes = []
    for b in range(B):
        for t0 in range(0, L, TILE):
            live = a[b, t0:t0 + TILE][after_stops[b, t0:t0 + TILE]].astype(np.int64)
            if live.size == 0:
                continue
            for k in np.nonzero(ns_r[b] > 0)[0]:
                row = ns[b, k]
                sizes.append(int(np.searchsorted(row, live.max() + max_sep + 1)
                                 - np.searchsorted(row, live.min() - max_sep)))
    return np.array(sizes, np.int64)


def bound(arrays, pairs: int, max_sep: int = MAX_SEP, r_max: int = R_MAX) -> dict:
    """Least time for the join on this card, counting what these inputs
    need: each real anchor, the key values within max_sep of a real
    anchor of their row (active keys), the stop values at real anchors
    (active stops) and the multiplicities read once, every output lane
    written once; bytes over the memory rate, against the integer
    operations over the 32-bit rate. Per reached (lane, key) pair: a
    merge step over the sorted window (two operations), 2*r_max candidate
    reads and distance tests, and the 2*r_max^2 pairwise comparisons (two
    operations each) of the rank."""
    from repro_torch.kernels.common import SENTINEL

    a, ns, ns_r = arrays[:3]
    B, Kn, L = ns.shape
    real = (a != SENTINEL).sum(axis=1)
    nbytes = 4 * int(real.sum()) + 4 * needed_key_values(arrays, max_sep) + ns_r.nbytes
    if len(arrays) > 3:
        st_r = arrays[5]
        nbytes += 2 * 4 * int((real * (st_r > 0).sum(axis=1)).sum()) + st_r.nbytes
    nbytes += B * L * (1 + 4 + 4)  # valid (bool), lo, hi
    ops = pairs * (2 + 4 * r_max + 4 * r_max ** 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    return {"bytes": int(nbytes), "ops": int(ops), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def turns(fn_parent, fn) -> dict:
    """An earlier and the current kernel timed in turns on one card:
    earlier, current, current, earlier."""
    t = [device_ms(fn_parent), device_ms(fn), device_ms(fn), device_ms(fn_parent)]
    return {"parent_ms": [t[0], t[3]], "turn_ms": [t[1], t[2]]}


def host_ms(rec: dict) -> float:
    """Wrapper minus kernel: the host's share of one call."""
    return rec["wrapper_ms"] - rec["ms"]


def in_turns(rec: dict) -> str:
    if "parent_ms" not in rec:
        return ""
    return (f"; in turns: earlier kernel {rec['parent_ms'][0]:.4f} / {rec['parent_ms'][1]:.4f} ms, "
            f"this kernel {rec['turn_ms'][0]:.4f} / {rec['turn_ms'][1]:.4f} ms")


def kernel_phase(dev, parent=None) -> dict:
    from repro_torch.kernels.nearest_r import window_join, window_join_plain
    from repro_torch.kernels.nearest_r.ops import launch_kernel

    def on_card(arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    worst = 0
    cases = replay_cases()
    for name, arrays, max_sep, r_max in cases:
        ts = on_card(arrays)
        got = window_join(*ts, max_sep=max_sep, r_max=r_max)
        want = window_join_plain(*ts, max_sep=max_sep, r_max=r_max)
        torch.cuda.synchronize()
        ok, err = compare(got, want)
        if not ok:
            raise AssertionError(f"kernel disagrees with the plain version on {name}")
        worst = max(worst, err)
    log(f"kernel nearest_r.window_join: {len(cases)} replay cases exact")

    shapes = {}
    rng = np.random.default_rng(2024)  # the ladder shapes first: their inputs stay as drawn before
    for tag, (B, Kn, Ks, L), rows in NR_SHAPES:
        arrays = ladder_case(rng if rows is None else np.random.default_rng(rows[0]),
                             B, Kn, Ks, L, *(() if rows is None else rows[1:]))
        ts = on_card(arrays)
        got = window_join(*ts, max_sep=MAX_SEP, r_max=R_MAX)
        want = window_join_plain(*ts, max_sep=MAX_SEP, r_max=R_MAX)
        torch.cuda.synchronize()
        ok, err = compare(got, want)
        if not ok:
            raise AssertionError(f"kernel disagrees with the plain version at {tag} "
                                 f"B={B} Kn={Kn} Ks={Ks} L={L}")
        worst = max(worst, err)
        valid_share = float(want[0].float().mean())
        outs = [torch.empty((B, L), dtype=torch.bool, device=dev),
                torch.empty((B, L), dtype=torch.int32, device=dev),
                torch.empty((B, L), dtype=torch.int32, device=dev)]
        stops = ts[3:] if Ks else [None] * 3

        def run(csrc=None):
            return lambda: launch_kernel(*ts[:3], *stops, *outs, max_sep=MAX_SEP,
                                         r_max=R_MAX, csrc=csrc)

        ms = device_ms(run())
        wrapper_ms = call_ms(lambda: window_join(*ts, max_sep=MAX_SEP, r_max=R_MAX))
        plain_ms = device_ms(lambda: window_join_plain(*ts, max_sep=MAX_SEP, r_max=R_MAX))
        pairs, after_stops = reached_pairs(ts, MAX_SEP, R_MAX)
        b = bound(arrays, pairs)
        win = window_sizes(arrays, after_stops, MAX_SEP)
        rec = {"B": B, "Kn": Kn, "Ks": Ks, "L": L, "ms": ms, "wrapper_ms": wrapper_ms,
               "plain_ms": plain_ms, "valid_share": valid_share, "pairs": pairs,
               "windows": int(win.size), "windows_staged": int((win <= WIN_CAP).sum()),
               "window_median": float(np.median(win)) if win.size else 0.0, **b}
        if parent is not None:
            rec.update(turns(run(parent), run()))
        shapes[tag] = rec
        log(f"kernel nearest_r.window_join {tag} B={B} Kn={Kn} Ks={Ks} L={L}: exact; "
            f"kernel {ms:.4f} ms (wrapper {wrapper_ms:.4f} ms, wrapper - kernel "
            f"{host_ms(rec):.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({b['bytes'] / 1e6:.1f} MB -> {b['bytes_ms'] * 1e3:.1f} us; "
            f"{b['ops'] / 1e9:.2f} Gop -> {b['ops_ms'] * 1e3:.1f} us), "
            f"valid lanes {valid_share:.3f}, block windows {rec['windows']} "
            f"({rec['windows_staged']} staged, median {rec['window_median']:.0f} values); "
            f"library_ms: null{in_turns(rec)}")
    return {"max_abs_err": worst, "shapes": shapes}


# -- launch counts ---------------------------------------------------------------
def wrappers() -> dict:
    """Every kernel wrapper of the port, by its name in the kernels line."""
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_backward
    from repro_torch.kernels.intersect import (
        intersect_compressed_streams,
        intersect_sorted,
        intersect_sorted_compressed,
    )
    from repro_torch.kernels.nearest_r import window_join
    from repro_torch.kernels.proximity import proximity_join
    from repro_torch.kernels.segment_sum import segment_sum

    return {"nearest_r.window_join": window_join,
            "intersect.intersect_sorted": intersect_sorted,
            "intersect.intersect_compressed_streams": intersect_compressed_streams,
            "intersect.intersect_sorted_compressed": intersect_sorted_compressed,
            "proximity.proximity_join": proximity_join,
            "embedding_bag.embedding_bag": embedding_bag,
            "embedding_bag.embedding_bag_backward": embedding_bag_backward,
            "segment_sum.segment_sum": segment_sum}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "long_launches"):
            fn.long_launches = 0


def read_counts() -> dict:
    """Launches per wrapper, and ``<name> long`` for the wrappers that
    count their long-segment launches apart."""
    counts = {}
    for name, fn in wrappers().items():
        counts[name] = fn.launches
        if hasattr(fn, "long_launches"):
            counts[f"{name} long"] = fn.long_launches
    return counts


# -- the kernel library: intersect, compressed intersect, proximity, bag -------
def _unique(rng, n, hi):
    return np.unique(rng.integers(0, hi, n)).astype(np.int32)


def _dups_and_sentinel(rng):
    """Sorted with repeats and SENTINEL tails: with block_a=8 the 20
    SENTINELs of a fill two whole A-blocks; SENTINEL-3 is within d of the
    b tail, which must never match."""
    from repro_torch.kernels.common import SENTINEL

    a = np.concatenate([np.sort(rng.integers(0, 60, 101)), [SENTINEL - 3],
                        np.full(20, SENTINEL)])
    b = np.concatenate([np.sort(rng.integers(0, 60, 70)), np.full(5, SENTINEL)])
    return a.astype(np.int32), b.astype(np.int32)


def window_replays(plan):
    """Seeded replay families of a windowed kernel as (name, a, b, kwargs):
    test_kernels.py's shapes (lengths off the block multiples among them)
    at the planned and the full-scan k_tiles, blocks 8/16 at truncated and
    exact k_tiles, repeats with SENTINEL tails filling whole A-blocks,
    one-element inputs; then the block-per-A-block kernels' own hazards:
    a shuffled inside each A-block, an A-block of SENTINEL alone in the
    middle of a, a sparse a over a dense b at full scan (needed ranges
    past the shared-memory buffer), and runs of repeats in b that the
    window's edges, the staged range's edges and its sample points cut.
    ``plan(a, b, block_a, block_b)`` is the kernel's k_tiles planner."""
    from repro_torch.kernels.common import SENTINEL

    cases = []
    for i, (na, nb, hi) in enumerate(((100, 100, 500), (1000, 5000, 20000),
                                      (5000, 700, 100000), (513, 1025, 4000), (3, 2, 10))):
        rng = np.random.default_rng(i)
        a, b = _unique(rng, na, hi), _unique(rng, nb, hi)
        cases.append((f"{na}x{nb} planned", a, b, dict(k_tiles=plan(a, b, 512, 1024))))
        cases.append((f"{na}x{nb} full scan", a, b, {}))
    for seed in range(4):
        rng = np.random.default_rng(10 + seed)
        a, b = _unique(rng, 150, 900), _unique(rng, 300, 900)
        k = plan(a, b, 8, 16)
        for kt in sorted({1, max(1, k - 1), k}):
            cases.append((f"blocks 8/16 seed {seed} k_tiles={kt}", a, b,
                          dict(block_a=8, block_b=16, k_tiles=kt)))
    a, b = _dups_and_sentinel(np.random.default_rng(20))
    for kt in (1, 2, None):
        cases.append((f"repeats+SENTINEL k_tiles={kt}", a, b,
                      dict(block_a=8, block_b=16, k_tiles=kt)))
    for a, b in (([5], [5]), ([5], [6]), ([SENTINEL], [SENTINEL]), ([7], [1, 7, 7])):
        cases.append((f"one element {a} in {b}", np.array(a, np.int32),
                      np.array(b, np.int32), {}))

    rng = np.random.default_rng(21)
    a, b = _unique(rng, 1800, 12_000), _unique(rng, 4000, 12_000)
    k = plan(a, b, 512, 1024)  # planned on the sorted a, as a caller would
    for block_a in (512, 8):
        shuffled = a.copy()
        for s in range(0, a.size, block_a):
            rng.shuffle(shuffled[s:s + block_a])
        blocks = dict(block_a=block_a, block_b=1024 if block_a == 512 else 16)
        kb = plan(a, b, blocks["block_a"], blocks["block_b"])
        cases.append((f"shuffled in each A-block of {block_a}", shuffled, b, dict(blocks, k_tiles=kb)))
        cases.append((f"shuffled in each A-block of {block_a}, full scan", shuffled, b, blocks))
    holed = a.copy()
    holed[512:1024] = SENTINEL
    cases.append(("SENTINEL A-block in the middle", holed, b, dict(k_tiles=k)))
    cases.append(("SENTINEL A-block in the middle, full scan", holed, b, {}))
    cases.append(("600 draws over 200,000 in [0, 1e6), full scan",
                  _unique(rng, 600, 10**6), _unique(rng, 200_000, 10**6), {}))
    vals = _unique(rng, 3000, 40_000)
    b = np.repeat(vals, rng.integers(1, 40, vals.size)).astype(np.int32)
    a = np.unique(np.concatenate([rng.choice(vals, 1500, replace=False),
                                  rng.integers(0, 40_000, 500)])).astype(np.int32)
    for kw in (dict(block_a=64, block_b=48, k_tiles=1), dict(block_a=64, block_b=48, k_tiles=2),
               dict(block_a=64, block_b=48, k_tiles=plan(a, b, 64, 48)), {}):
        cases.append((f"runs of repeats in b, {kw or 'full scan'}", a, b, kw))
    return cases


def compressed_replays():
    """Replay families of the compressed intersect: test_kernels.py's
    shapes at blocks 128/256 and at the defaults (where short inputs leave
    64-blocks all padding), blocks 64/64 at truncated and full k_tiles,
    repeats whose all-pad blocks decode below the real values, and empty
    and one-element inputs; then the block-per-A-block kernel's hazards: a
    full scan at 1M (needed ranges past the shared-memory buffer, searched
    through a sample of 64-block starts), b whose all-pad tail blocks (base
    0) follow high values, with a probing 0..100 and past b's end, runs of
    repeats in b (runs longer than a 64-block among them) cut by window,
    range and sample edges, a sparse a over a dense b, and 64-blocks at the
    ends of the int32 range (INT_MAX matches; a max + 1 past int32)."""
    from repro_torch.kernels.intersect import plan_k_tiles

    cases = []
    for i, (na, nb, hi) in enumerate(((300, 500, 4000), (1000, 2000, 30000), (70, 1500, 9000))):
        rng = np.random.default_rng(30 + i)
        a, b = _unique(rng, na, hi), _unique(rng, nb, hi)
        cases.append((f"{na}x{nb} blocks 128/256", a, b, dict(block_a=128, block_b=256)))
        cases.append((f"{na}x{nb} default blocks", a, b, {}))
    rng = np.random.default_rng(40)
    a, b = _unique(rng, 400, 3000), _unique(rng, 900, 3000)
    for kt in (1, 2, None):
        cases.append((f"blocks 64/64 k_tiles={kt}", a, b,
                      dict(block_a=64, block_b=64, k_tiles=kt)))
    a = np.sort(rng.integers(60_000, 70_000, 70)).astype(np.int32)
    b = np.sort(rng.integers(60_000, 70_000, 1500)).astype(np.int32)
    cases.append(("repeats, pads below the values", a, b, {}))
    for a, b in (([], []), ([], [5]), ([5], []), ([5], [5]), ([5], [6])):
        cases.append((f"{a} in {b}", np.array(a, np.int32), np.array(b, np.int32), {}))

    rng = np.random.default_rng(41)
    a, b = _unique(rng, 100_000, 4 << 20), _unique(rng, 1 << 20, 4 << 20)
    cases.append(("100,000 in 1M draws, full scan", a, b, {}))
    # 3000 values: the last 64-block of b's 3072 slots is all pad (base 0, its
    # pads decoding to 65535, which a's first 64-block holds)
    b = (2**31 - 2_000_000 + np.cumsum(rng.integers(1, 40, 3000))).astype(np.int32)
    a = np.concatenate([np.arange(1, 64), [65535], np.sort(rng.choice(b, 400, replace=False)),
                        b[-1] + np.arange(1, 50)]).astype(np.int32)
    for kw in ({}, dict(k_tiles=1), dict(block_a=64, block_b=64, k_tiles=2)):
        cases.append((f"all-pad tail blocks after high values, {kw or 'full scan'}", a, b, kw))
    vals = _unique(rng, 3000, 40_000)
    b = np.repeat(vals, rng.integers(1, 40, vals.size))
    b = np.sort(np.concatenate([b, np.full(200, vals[1500])])).astype(np.int32)  # a run of 200+
    a = np.unique(np.concatenate([rng.choice(vals, 1500, replace=False),
                                  rng.integers(0, 40_000, 500)])).astype(np.int32)
    for kw in (dict(block_a=64, block_b=192, k_tiles=1), dict(block_a=64, block_b=192, k_tiles=2),
               dict(block_a=128, block_b=256), {}):
        cases.append((f"runs of repeats in b, {kw or 'full scan'}", a, b, kw))
    a, b = _unique(rng, 3000, 10**6), _unique(rng, 200_000, 10**6)  # a's spans fit uint16
    cases.append(("3,000 draws over 200,000 in [0, 1e6), full scan", a, b, {}))
    cases.append(("3,000 draws over 200,000, planned", a, b, dict(k_tiles=plan_k_tiles(a, b))))
    low, top = -(2**31), 2**31 - 1  # whole 64-blocks of each, so no span wraps
    b = np.concatenate([low + np.arange(0, 192, 3), top - np.arange(254, -1, -2)]).astype(np.int32)
    a = np.concatenate([low + np.arange(64), top - np.arange(63, -1, -1)]).astype(np.int32)
    # b's last block: full; INT_MAX, then 10 pads; values below INT_MAX, then 10 pads
    for tag, bb in (("", b), (", INT_MAX then pads", np.delete(b, np.s_[64:74])),
                    (", pads after values below INT_MAX", b[:-10])):
        for kw in (dict(block_a=64, block_b=64), dict(block_a=64, block_b=64, k_tiles=1)):
            cases.append((f"int32 extremes{tag}, {kw}", a, bb, kw))
    return cases


def assert_lanes(got, want, what: str) -> None:
    """Exact agreement of integer and bool outputs on every lane."""
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"kernel disagrees with the plain version on {what}")


def bag_tolerance(dtype) -> tuple[float, float]:
    """(rtol, atol) of test_kernels.py in bfloat16, 2e-2; float32 must be
    equal to the bit (the kernel adds in the plain version's order)."""
    return (0.0, 0.0) if dtype == torch.float32 else (2e-2, 2e-2)


def bag_replays():
    """Bag families as (name, ids, table, weights, dtype, combine,
    shifted): float32 and bfloat16 tables, sum and mean, with and without
    weights, over test_kernels.py's shapes and a wider one, ids from -1
    (padding) to past the vocabulary; then row widths off the 16-byte
    loads (D = 1, 3, 12, 129), a table view 4 or 2 bytes off 16-byte
    alignment (``shifted``), bags of repeated ids, all-pad bags, and bag
    lengths off the kernel's 8-row and 32-id steps."""
    cases = []

    def add(tag, ids, table, w, shifted=False, weighted=(False, True)):
        for dtype in (torch.float32, torch.bfloat16):
            for combine in ("sum", "mean"):
                for wt in weighted:
                    name = (f"{tag} {str(dtype)[6:]} {combine} "
                            f"{'weighted' if wt else 'unweighted'}")
                    cases.append((name, ids, table, w if wt else None, dtype, combine, shifted))

    def draw(seed, B, S, V, D, lo=-1, hi=None):
        rng = np.random.default_rng(seed)
        ids = rng.integers(lo, V + V // 10 if hi is None else hi, (B, S)).astype(np.int32)
        return (rng, ids, rng.normal(size=(V, D)).astype(np.float32),
                rng.normal(size=(B, S)).astype(np.float32))

    for i, (B, S, V, D) in enumerate(((32, 8, 100, 16), (130, 5, 513, 32), (8, 1, 2000, 64),
                                      (33, 17, 3000, 200))):
        _, ids, table, w = draw(50 + i, B, S, V, D)
        add(f"B{B} S{S} V{V} D{D}", ids, table, w)
    for D in (1, 3, 12, 129):
        _, ids, table, w = draw(60 + D, 40, 13, 300, D)
        add(f"D{D}", ids, table, w)
    _, ids, table, w = draw(70, 40, 13, 300, 64)
    add("shifted table D64", ids, table, w, shifted=True)
    _, ids, table, w = draw(71, 40, 13, 300, 129)
    add("shifted table D129", ids, table, w, shifted=True, weighted=(True,))
    rng, ids, table, w = draw(72, 40, 37, 300, 64, lo=0, hi=4)  # ids from {0..3}
    ids[0] = 5  # one id over the whole bag
    add("repeated ids", ids, table, w)
    rng, ids, table, w = draw(73, 40, 20, 300, 64)
    ids[::2] = -1
    add("all-pad bags", ids, table, w)
    for S in (1, 7, 9, 31, 33, 65):
        _, ids, table, w = draw(80 + S, 24, S, 500, 128)
        add(f"S{S}", ids, table, w, weighted=(True,))
    return cases


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` as a contiguous view one element into a larger
    buffer, so its base is off 16-byte alignment."""
    big = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    big[1:] = t.flatten()
    view = big[1:].view(t.shape)
    if view.data_ptr() % 16 == 0 or not view.is_contiguous():
        raise AssertionError("the shifted view is aligned or not contiguous")
    return view


def card_table(table, dtype, dev, shifted: bool) -> torch.Tensor:
    """The table on the card in ``dtype``; shifted, :func:`misaligned`."""
    t = torch.from_numpy(table).to(dev, dtype)
    return misaligned(t) if shifted else t


def assert_bag(got, want, dtype, what: str) -> float:
    """float32 equal to the bit, bfloat16 within test_kernels.py's
    tolerance; returns the largest absolute difference."""
    if dtype == torch.float32:
        if not torch.equal(got, want):
            raise AssertionError(f"embedding bag {what}: not equal to the plain version "
                                 f"(max abs diff {float((got - want).abs().max())})")
    else:
        rtol, atol = bag_tolerance(dtype)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"embedding bag {what}: {m}")
    return float((got.float() - want.float()).abs().max())


def window_bound(n_in_bytes: int, n_out_bytes: int, ops: float) -> dict:
    """Least time on this card: bytes moved once over the memory rate
    against integer operations over the 32-bit rate."""
    bytes_ms = (n_in_bytes + n_out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    return {"bytes": int(n_in_bytes + n_out_bytes), "ops": int(ops), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def a_block_windows(a, b, d: int, k_tiles: int, block_a: int = 512,
                    block_b: int = 1024, lens=None) -> np.ndarray:
    """b-values in the range that each block of the block-per-A-block
    kernels (csrc/sorted_window.cuh) needs: a block's tile of one A-block
    (512 elements, or 128 where 512 evenly spread ones would need more
    than LIST_CAP values of b, as ``sparse_a`` chooses; the compressed
    kernel also 256 where they would need more than half), the window from
    the A-block's first element, [lb(min - d), lb(min(max + d, SENTINEL -
    1) + 1)) of its live elements clamped to it. Blocks whose tile holds
    no live element are left out. With ``lens``, the compressed kernel's
    stream lengths ``(la, lb)`` (d = 0): what it stages instead, the whole
    window where it holds at most LIST_CAP slots, else the 64-blocks from
    the one before the first block starting at or above min to the first
    starting at or above max + 1."""
    from repro_torch.kernels.common import SENTINEL, cdiv

    b64 = b.astype(np.int64)
    na, nb, last = a.size, b.size, cdiv(b.size, block_b) - 1
    tile_na, tile_nb = (na, nb) if lens is None else lens
    tile = 128 if 512 * tile_nb > LIST_CAP * tile_na else 512
    if lens is not None:  # the compressed kernel's 256-element tiles
        tile = 256 if tile == 512 and 1024 * tile_nb > LIST_CAP * tile_na else tile
        last, firsts = lens[1] // block_b - 1, b64[::64]
    sizes = []
    for a0 in range(0, na, block_a):
        start = int(np.searchsorted(b64, int(a[a0]) - d)) // block_b
        w_lo = min(start, last) * block_b
        w_hi = min((min(start + k_tiles - 1, last) + 1) * block_b, nb)
        for t0 in range(a0, min(a0 + block_a, na), tile):
            x = a[t0:min(t0 + tile, a0 + block_a, na)].astype(np.int64)
            live = x[x != SENTINEL]
            if live.size == 0:
                continue
            if lens is not None:
                w_hi = (min(start + k_tiles - 1, last) + 1) * block_b  # in slots
                if w_hi - w_lo <= LIST_CAP:
                    sizes.append(w_hi - w_lo)
                    continue
                j0, row = w_lo // 64, firsts[w_lo // 64:w_hi // 64]
                lo = 64 * max(j0 + int(np.searchsorted(row, live.min())) - 1, j0)
                sizes.append(max(64 * (j0 + int(np.searchsorted(row, live.max() + 1))) - lo, 0))
                continue
            lo = int(np.clip(np.searchsorted(b64, live.min() - d), w_lo, w_hi))
            top = min(int(live.max()) + d, SENTINEL - 1) + 1
            sizes.append(max(int(np.clip(np.searchsorted(b64, top), w_lo, w_hi)), lo) - lo)
    return np.array(sizes, np.int64)


def window_stats(win: np.ndarray) -> dict:
    return {"windows": int(win.size), "windows_staged": int((win <= LIST_CAP).sum()),
            "window_median": float(np.median(win)) if win.size else 0.0}


def replay_phase(dev) -> dict:
    """Each new kernel against its plain version on the card, over the
    replay families. Returns the largest error per kernel."""
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_plain
    from repro_torch.kernels.intersect import (
        intersect_compressed_plain,
        intersect_compressed_streams,
        intersect_plain,
        intersect_sorted,
        intersect_sorted_compressed,
        pack_compressed,
        pack_compressed_torch,
    )
    from repro_torch.kernels.intersect import plan_k_tiles as plan_int
    from repro_torch.kernels.intersect.ops import device_streams
    from repro_torch.kernels.proximity import plan_k_tiles as plan_prox
    from repro_torch.kernels.proximity import proximity_join, proximity_plain

    def on_card(*arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    cases = window_replays(plan_int)
    for name, a, b, kw in cases:
        ta, tb = on_card(a, b)
        assert_lanes(intersect_sorted(ta, tb, **kw), intersect_plain(ta, tb, **kw),
                     f"intersect {name}")
    log(f"kernel intersect.intersect_sorted: {len(cases)} replay cases exact")

    n = 0
    for d in (1, 5, 9, -2):  # a negative d matches nothing and skips the search
        cases = window_replays(lambda a, b, ba, bb: plan_prox(a, b, d, ba, bb))
        for name, a, b, kw in cases:
            ta, tb = on_card(a, b)
            assert_lanes(proximity_join(ta, tb, d, **kw), proximity_plain(ta, tb, d, **kw),
                         f"proximity d={d} {name}")
        n += len(cases)
    log(f"kernel proximity.proximity_join: {n} replay cases exact (d = 1, 5, 9, -2)")

    cases = compressed_replays()
    for name, a, b, kw in cases:
        blocks = {k: v for k, v in kw.items() if k != "k_tiles"}
        streams = device_streams(pack_compressed(a, b, **blocks), dev)
        for got, want in zip(pack_compressed_torch(a, b, device=dev, **blocks), streams):
            if not torch.equal(got, want):
                raise AssertionError(f"compressed {name}: the card's packer differs from the host's")
        k = kw.get("k_tiles") or streams[3].shape[0] // blocks.get("block_b", 1024)
        a_base, a_delta, b_base, b_delta, starts = streams
        want = intersect_compressed_plain(*streams, a_delta.shape[0], k_tiles=k,
                                          block_a=blocks.get("block_a", 512),
                                          block_b=blocks.get("block_b", 1024))
        for what, deltas in (("int16", (a_delta, b_delta)),
                             ("uint16", (a_delta.view(torch.uint16), b_delta.view(torch.uint16))),
                             ("misaligned", (misaligned(a_delta), misaligned(b_delta)))):
            got = intersect_compressed_streams(a_base, deltas[0], b_base, deltas[1], starts,
                                               k_tiles=k, **blocks)
            assert_lanes([got], [want], f"compressed streams {name}, {what} deltas")
        assert_lanes([intersect_sorted_compressed(a, b, device=dev, **kw)], [want[:a.size]],
                     f"compressed intersect {name}")
        if "k_tiles" not in kw and not np.array_equal(want[:a.size].cpu().numpy(), np.isin(a, b)):
            raise AssertionError(f"compressed intersect {name}: full scan differs from np.isin")
    log(f"kernel intersect.intersect_compressed_streams: {len(cases)} replay cases exact "
        "(int16, uint16 and misaligned deltas; the card's packer equal to the host's)")

    worst = 0.0
    cases = bag_replays()
    for name, ids, table, w, dtype, combine, shifted in cases:
        tids = on_card(ids)[0]
        ttable = card_table(table, dtype, dev, shifted)
        tw = None if w is None else on_card(w)[0]
        got = embedding_bag(tids, ttable, tw, combine)
        want = embedding_bag_plain(tids, ttable, tw, combine)
        worst = max(worst, assert_bag(got, want, dtype, name))
    log(f"kernel embedding_bag.embedding_bag: {len(cases)} replay cases, float32 equal to "
        f"the bit, bfloat16 within tolerance (max abs err {worst})")
    return {"intersect": 0, "compressed": 0, "proximity": 0, "embedding_bag": worst}


def max_span(x: np.ndarray) -> int:
    """The largest in-block span of sorted ``x`` cut into 64-posting blocks."""
    x = x.astype(np.int64)
    last = x[np.minimum(np.arange(0, x.size, 64) + 63, x.size - 1)]
    return int((last - x[::64]).max()) if x.size else 0


def library_inputs(dev) -> dict:
    """Full-width inputs of the kernel library, made from seeds: the sorted
    lists of kernel_bench.py's full shape and of qt1_heavy's posting length
    (values unique in [0, 4 Nb), as kernel_bench.py draws them), a rarer
    list against qt1_heavy's b (RARE_A), each pair also as delta16 streams
    on the card (every in-block span checked to fit uint16), and the
    two-tower-retrieval bag: a 10M x 256 float32 table made on the card,
    50-id histories padded with -1 after a random length, positive
    weights, at the serve_p99 batch and a larger one."""
    from repro_torch.kernels.intersect import pack_compressed
    from repro_torch.kernels.intersect.ops import PAD_DELTA, device_streams

    rng = np.random.default_rng(7)
    lists = {}
    for tag, n, m in FULL_SHAPES:
        a = np.unique(rng.integers(0, 4 * m, n)).astype(np.int32)
        b = np.unique(rng.integers(0, 4 * m, m)).astype(np.int32)
        lists[tag] = (a, b)
    m = FULL_SHAPES[-1][2]
    rare = np.unique(np.random.default_rng(8).integers(0, 4 * m, RARE_A[1])).astype(np.int32)
    lists[RARE_A[0]] = (rare, lists[FULL_SHAPES[-1][0]][1])
    streams = {}
    for tag, (a, b) in lists.items():
        if max(max_span(a), max_span(b)) >= PAD_DELTA:
            raise AssertionError(f"{tag}: an in-block span does not fit a uint16 delta")
        streams[tag] = device_streams(pack_compressed(a, b), dev)
    V, D, S = BAG_WIDTHS["V"], BAG_WIDTHS["D"], BAG_WIDTHS["S"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    table = torch.randn((V, D), generator=gen, device=dev, dtype=torch.float32)
    bags = {}
    for B in BAG_BATCHES:
        ids = rng.integers(0, V, (B, S)).astype(np.int32)
        lengths = rng.integers(1, S + 1, B)
        ids[np.arange(S)[None, :] >= lengths[:, None]] = -1
        w = rng.random((B, S)).astype(np.float32)
        bags[B] = (torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev))
    return {"lists": lists, "streams": streams, "table": table, "bags": bags}


def drive_library(dev, inputs) -> dict:
    """The slice's main path: each kernel-library entry point once per
    full-width shape, as a user calls it: the compressed intersect both
    from host arrays and from streams already packed on the card."""
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.intersect import (
        intersect_compressed_streams,
        intersect_sorted,
        intersect_sorted_compressed,
        plan_k_tiles,
    )
    from repro_torch.kernels.proximity import plan_k_tiles as plan_prox
    from repro_torch.kernels.proximity import proximity_join

    outs = {}
    for tag, (a, b) in inputs["lists"].items():
        k, kp = plan_k_tiles(a, b), plan_prox(a, b, PROX_D)
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        outs["intersect", tag] = (intersect_sorted(ta, tb, k_tiles=k), k)
        outs["compressed", tag] = (intersect_sorted_compressed(a, b, k_tiles=k, device=dev), k)
        outs["streams", tag] = (intersect_compressed_streams(*inputs["streams"][tag], k_tiles=k), k)
        outs["proximity", tag] = (proximity_join(ta, tb, PROX_D, k_tiles=kp), kp)
    for B, (ids, w) in inputs["bags"].items():
        outs["bag", B] = (embedding_bag(ids, inputs["table"], w, "sum"), None)
    torch.cuda.synchronize()
    return outs


def library_phase(dev, errs: dict, parent=None) -> dict:
    """Drives the kernel library at full width with the launch counts set
    to 0, holds every result against its plain version and its oracle,
    and times kernel, wrapper, plain version and library call."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_plain
    from repro_torch.kernels.embedding_bag.ops import launch_embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.intersect import (
        intersect_compressed_plain,
        intersect_compressed_streams,
        intersect_plain,
        intersect_sorted,
        intersect_sorted_compressed,
    )
    from repro_torch.kernels.intersect.ops import launch_intersect, launch_intersect_compressed
    from repro_torch.kernels.proximity import proximity_join, proximity_plain
    from repro_torch.kernels.proximity.ops import launch_proximity
    from repro_torch.kernels.proximity.ref import proximity_join_ref

    t0 = time.perf_counter()
    inputs = library_inputs(dev)
    torch.cuda.synchronize()
    log(f"library: inputs made in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    outs = drive_library(dev, inputs)
    launches = read_counts()
    log(f"library: main path launches {launches}")
    for name in ("intersect.intersect_sorted", "intersect.intersect_compressed_streams",
                 "intersect.intersect_sorted_compressed", "proximity.proximity_join",
                 "embedding_bag.embedding_bag"):
        if launches[name] <= 0:
            raise AssertionError(f"the kernel-library path never launched {name}")

    shapes = {"intersect": {}, "compressed": {}, "proximity": {}, "embedding_bag": {}}
    for tag, (a, b) in inputs["lists"].items():
        na, nb = a.size, b.size
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        member = torch.from_numpy(np.isin(a, b))

        (mask, idx), k = outs["intersect", tag]
        assert_lanes((mask, idx), intersect_plain(ta, tb, k_tiles=k), f"intersect {tag}")
        if not torch.equal(mask.cpu(), member):
            raise AssertionError(f"intersect {tag}: mask differs from np.isin at k_tiles={k}")
        m_out, i_out = torch.empty_like(mask), torch.empty_like(idx)

        def run_i(csrc=None, k=k):
            return lambda: launch_intersect(ta, tb, m_out, i_out, block_a=512, block_b=1024,
                                            k_tiles=k, csrc=csrc)

        rec = {"Na": na, "Nb": nb, "k_tiles": k, "matches": int(member.sum()),
               "ms": device_ms(run_i()),
               "wrapper_ms": call_ms(lambda: intersect_sorted(ta, tb, k_tiles=k)),
               "plain_ms": device_ms(lambda: intersect_plain(ta, tb, k_tiles=k)),
               "library_ms": device_ms(lambda: torch.isin(ta, tb)),
               "library": "torch.isin(a, b), mask only",
               **window_stats(a_block_windows(a, b, 0, k)),
               **window_bound(4 * na + 4 * nb, 5 * na, 2 * (na + nb))}
        if parent is not None:
            rec.update(turns(run_i(parent), run_i()))
        shapes["intersect"][tag] = rec

        mask, k = outs["compressed", tag]
        streams = inputs["streams"][tag]
        la, lb = streams[1].shape[0], streams[3].shape[0]
        want = intersect_compressed_plain(*streams, la, block_a=512, block_b=1024, k_tiles=k)
        assert_lanes([outs["streams", tag][0]], [want], f"compressed streams {tag}")
        assert_lanes([mask], [want[:na]], f"compressed intersect {tag}")
        if not torch.equal(mask.cpu(), member):
            raise AssertionError(f"compressed intersect {tag}: mask differs from np.isin")
        c_out = torch.empty(la, dtype=torch.bool, device=dev)

        def run_c(csrc=None, k=k, streams=streams):
            return lambda: launch_intersect_compressed(*streams, c_out, block_a=512,
                                                       block_b=1024, k_tiles=k, csrc=csrc)

        rec = {"Na": na, "Nb": nb, "k_tiles": k, "matches": int(member.sum()),
               "ms": device_ms(run_c()),
               "wrapper_ms": call_ms(lambda: intersect_sorted_compressed(
                   a, b, k_tiles=k, device=dev)),
               "streams_ms": call_ms(lambda: intersect_compressed_streams(*streams, k_tiles=k)),
               "plain_ms": device_ms(lambda: intersect_compressed_plain(
                   *streams, la, block_a=512, block_b=1024, k_tiles=k)),
               "library_ms": None, "library": "none on the delta16 streams",
               **window_stats(a_block_windows(a, b, 0, k, lens=(la, lb))),
               **window_bound(sum(t.numel() * t.element_size() for t in streams), la,
                              3 * (na + nb))}
        if parent is not None:
            rec.update(turns(run_c(parent), run_c()))
        shapes["compressed"][tag] = rec

        out, k = outs["proximity", tag]
        assert_lanes(out, proximity_plain(ta, tb, PROX_D, k_tiles=k), f"proximity {tag}")
        assert_lanes(out, proximity_join_ref(ta, tb, PROX_D), f"proximity {tag} (oracle)")
        p_out = [torch.empty_like(x) for x in out]

        def run_p(csrc=None, k=k):
            return lambda: launch_proximity(ta, tb, *p_out, d=PROX_D, block_a=512, block_b=1024,
                                            k_tiles=k, csrc=csrc)

        rec = {"Na": na, "Nb": nb, "d": PROX_D, "k_tiles": k, "matches": int(out[0].sum()),
               "ms": device_ms(run_p()),
               "wrapper_ms": call_ms(lambda: proximity_join(ta, tb, PROX_D, k_tiles=k)),
               "plain_ms": device_ms(lambda: proximity_plain(ta, tb, PROX_D, k_tiles=k)),
               "library_ms": None, "library": "none",
               **window_stats(a_block_windows(a, b, PROX_D, k)),
               **window_bound(4 * na + 4 * nb, 9 * na, 4 * (na + nb))}
        if parent is not None:
            rec.update(turns(run_p(parent), run_p()))
        shapes["proximity"][tag] = rec
        for kind in ("intersect", "compressed", "proximity"):
            r = shapes[kind][tag]
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            win = "" if "windows" not in r else (
                f", A-block windows {r['windows']} ({r['windows_staged']} staged, "
                f"median {r['window_median']:.0f} values)")
            entry = "" if "streams_ms" not in r else (
                f"; streams entry {r['streams_ms']:.4f} ms, "
                f"streams entry - kernel {r['streams_ms'] - r['ms']:.4f} ms")
            log(f"kernel {kind} {tag} Na={na} Nb={nb} k_tiles={r['k_tiles']}: exact; "
                f"kernel {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} ms, "
                f"wrapper - kernel {host_ms(r):.4f} ms{entry}), "
                f"plain {r['plain_ms']:.4f} ms, library {lib}, "
                f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                f"({r['bytes'] / 1e6:.2f} MB){win}{in_turns(r)}")

    table = inputs["table"]
    V, D = table.shape
    worst = errs["embedding_bag"]
    for B, (ids, w) in inputs["bags"].items():
        out, _ = outs["bag", B]
        want = embedding_bag_plain(ids, table, w, "sum")
        err = assert_bag(out, want, table.dtype, f"B{B}")
        torch.testing.assert_close(out, embedding_bag_ref(ids, table, w, "sum"),
                                   rtol=1e-5, atol=1e-4)
        worst = max(worst, err)
        valid = (ids >= 0) & (ids < V)
        rows = int(torch.unique(ids[valid]).numel())
        lib_ids, lib_w = ids.clamp(min=0), w * (ids >= 0)
        lib_out = F.embedding_bag(lib_ids, table, per_sample_weights=lib_w, mode="sum")
        b_out = torch.empty_like(out)
        S = ids.shape[1]
        rec = {"B": B, "S": S, "V": V, "D": D, "dtype": "float32", "combine": "sum",
               "weighted": True, "valid_ids": int(valid.sum()), "distinct_rows": rows,
               "ms": device_ms(lambda: launch_embedding_bag(ids, table, w, b_out, mean=False)),
               "wrapper_ms": call_ms(lambda: embedding_bag(ids, table, w, "sum")),
               "plain_ms": device_ms(lambda: embedding_bag_plain(ids, table, w, "sum")),
               "library_ms": device_ms(lambda: F.embedding_bag(
                   lib_ids, table, per_sample_weights=lib_w, mode="sum")),
               "library": "F.embedding_bag(mode='sum', per_sample_weights)",
               "library_max_abs_diff": float((lib_out - out).abs().max()),
               **window_bound(8 * B * S + rows * D * table.element_size(),
                              B * D * table.element_size(), 2 * int(valid.sum()) * D)}
        if parent is not None:
            rec.update(turns(
                lambda: launch_embedding_bag(ids, table, w, b_out, mean=False, csrc=parent),
                lambda: launch_embedding_bag(ids, table, w, b_out, mean=False)))
        shapes["embedding_bag"][f"B{B}"] = rec
        log(f"kernel embedding_bag B={B} S={S} V={V} D={D} float32 weighted sum: "
            f"max abs err {err}; "
            f"kernel {rec['ms']:.4f} ms (wrapper {rec['wrapper_ms']:.4f} ms, "
            f"wrapper - kernel {host_ms(rec):.4f} ms), "
            f"plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({rec['bytes'] / 1e6:.1f} MB, {rows} distinct rows){in_turns(rec)}")
    del inputs, outs, table
    torch.cuda.empty_cache()
    errs = dict(errs, embedding_bag=worst)
    return {"launches": launches, "max_abs_err": errs, "shapes": shapes}


# -- the serving path ----------------------------------------------------------
def serve_world():
    """The serving CLI's synthetic corpus at N_DOCS documents, its index,
    N_QUERIES mixed QT1-QT5 queries, and the corpus (table, lexicon)."""
    from repro_torch.core.index_builder import build_index
    from repro_torch.data.corpus import generate_corpus, sample_mixed_queries

    t0 = time.perf_counter()
    table, lex = generate_corpus(N_DOCS, mean_doc_len=160, vocab_size=40_000, seed=1)
    index = build_index(table, lex, max_distance=MAX_SEP)
    queries = sample_mixed_queries(table, lex, N_QUERIES, seed=2)
    log(f"serve: corpus {N_DOCS} docs / {int(table.doc_lengths.sum())} tokens, "
        f"index built, {len(queries)} queries in {time.perf_counter() - t0:.1f} s")
    return index, queries, table, lex


def check_records(drains, want, queries, what: str) -> int:
    """Every drain's records equal the reference drain's, bit for bit;
    returns the hits over all drains."""
    hits = 0
    for drain in drains:
        assert len(drain) == len(want) == len(queries)
        for qi, (g, w) in enumerate(zip(drain, want)):
            for col in ("doc", "start", "end", "score"):
                if not np.array_equal(g.results[col], w.results[col]):
                    raise AssertionError(f"{what}: query {qi} {queries[qi]}: {col} differs "
                                         "between the card and the cpu run")
            assert np.isfinite(g.results["score"]).all()
            hits += int(g.results["doc"].size)
    return hits


def drain_all(svc, queries, names, what: str) -> tuple[list, dict]:
    """One drain of every query per name, each logged with its wall time;
    returns the drains and the window-join launches of each."""
    from repro_torch.kernels.nearest_r import window_join

    drains, per_drain = [], {}
    for name in names:
        for q in queries:
            svc.submit(q)
        before = window_join.launches
        t = time.perf_counter()
        drains.append(svc.drain())
        per_drain[name] = window_join.launches - before
        log(f"{what}: {name} drain on {svc.device} {time.perf_counter() - t:.3f} s, "
            f"{per_drain[name]} window_join launches")
    return drains, per_drain


def serve_metrics(svc, what: str) -> dict:
    """serve.step.* and serve.batch.* hold warm batches only (a shape's
    first batch is its warm-up); serve.phase.* holds every request."""
    metrics = {}
    for prefix in ("serve.step.", "serve.batch.", "serve.phase."):
        for name, h in sorted(svc.metrics_snapshot(prefix).items()):
            metrics[name] = {"p50_us": h["p50"], "count": h["count"]}
            log(f"{what}: {name} p50 {h['p50']:.1f} us (n={h['count']})")
    return metrics


def serve_phase(dev, index, queries) -> tuple[dict, list]:
    """The raw payload on the card, cold then warm, against a CPU drain;
    returns the report and the CPU drain's responses."""
    from repro_torch.kernels.nearest_r import window_join
    from repro_torch.serving import SearchService, ServeConfig

    svc = SearchService(index, ServeConfig(), device=dev)
    reset_counts()
    drains, per_drain = drain_all(svc, queries, ("cold", "warm"), "serve")
    launches = window_join.launches
    cpu = SearchService(index, ServeConfig(), device="cpu")
    for q in queries:
        cpu.submit(q)
    t = time.perf_counter()
    want = cpu.drain()
    log(f"serve: reference drain on cpu {time.perf_counter() - t:.3f} s")

    hits = check_records(drains, want, queries, "serve")
    if launches <= 0:
        raise AssertionError("the serve path never launched the nearest_r kernel")
    stats = svc.stats_snapshot()
    routes = stats["plans"]["routes"]
    log(f"serve: records equal the cpu run ({hits} hits over 2 drains); "
        f"window_join launches {launches}; routes {routes}; "
        f"fallbacks {stats['plans']['fallbacks']}")
    return {"launches": launches, "launches_per_drain": per_drain,
            "routes": routes, "hits": hits, "metrics": serve_metrics(svc, "serve"),
            "executables": {f"{k}/B{b}/L{l}": n
                            for (k, b, l), n in svc.compiled.executables.items()}}, want


def payloads_served(drains) -> dict:
    """Responses per (route, payload) over the drains."""
    out: dict = {}
    for drain in drains:
        for r in drain:
            key = f"{r.path}/{r.plan.payload if r.plan is not None else None}"
            out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def overflow_world():
    """A corpus whose hot keys recur in two documents 5,201 apart, so one
    64-posting delta block of every posting row spans more than uint16:
    the compressed service must serve each family as offsets."""
    from repro_torch.core.index_builder import build_index
    from repro_torch.core.lexicon import Lexicon
    from repro_torch.data.corpus import TokenTable

    sw_count, fu_count = 6, 6
    fu, ordinary = sw_count, sw_count + fu_count
    pattern = [0, 1, 2, fu, fu + 1, ordinary, ordinary + 1]
    docs = [np.array(pattern)] + [np.array([ordinary + 2])] * 5200 + [np.array(pattern)]
    counts = np.arange(ordinary + 3, 0, -1) * 100
    lex = Lexicon.from_rank_counts(counts=counts, doc_freqs=np.minimum(counts, len(docs)),
                                   n_docs=len(docs), sw_count=sw_count, fu_count=fu_count)
    index = build_index(TokenTable.from_docs(docs), lex, max_distance=MAX_SEP)
    return index, [[0, 1, 2], [fu, fu + 1], [0, fu, fu + 1], [fu, fu + 1, ordinary]]


def compressed_serve_phase(dev, index, queries, want) -> tuple[dict, object]:
    """ServeConfig(compressed=True) on the card, cold then warm, with the
    compressed-row cache and without it; every drain's records equal the
    CPU raw drain. Then the far-apart corpus, served as offsets. Returns
    the report and the warm cached service."""
    from repro_torch.serving import SearchService, ServeConfig

    svc = SearchService(index, ServeConfig(compressed=True), device=dev)
    reset_counts()
    drains, per_drain = drain_all(svc, queries, ("cold", "warm"), "compressed")
    launches = read_counts()
    hits = check_records(drains, want, queries, "compressed")
    if launches["nearest_r.window_join"] <= 0:
        raise AssertionError("the compressed serve path never launched the nearest_r kernel")
    stats = svc.stats_snapshot()
    cc = stats["compressed_cache"]
    hit_rate = cc["hits"] / max(1, cc["hits"] + cc["misses"])
    rep = {"launches": launches, "launches_per_drain": per_drain, "hits": hits,
           "payloads": payloads_served(drains),
           "compressed_batches": stats["compressed_batches"],
           "offset_fallbacks": stats["offset_fallbacks"],
           "compressed_cache": cc, "compressed_cache_hit_rate": hit_rate}
    log(f"compressed: records equal the cpu raw run ({hits} hits over 2 drains); "
        f"launches {launches}; payloads {rep['payloads']}; compressed_batches "
        f"{rep['compressed_batches']}, offset_fallbacks {rep['offset_fallbacks']}; "
        f"cache.compressed hit rate {hit_rate:.3f} ({cc['hits']} hits, {cc['misses']} misses)")
    rep["metrics"] = serve_metrics(svc, "compressed")

    bare = SearchService(index, ServeConfig(compressed=True, use_compressed_cache=False),
                         device=dev)
    drains, _ = drain_all(bare, queries, ("cold", "warm"), "compressed, no cache")
    hits = check_records(drains, want, queries, "compressed, no cache")
    st = bare.stats_snapshot()
    compress = bare.metrics_snapshot("serve.phase.compress")["serve.phase.compress"]
    rep["no_cache"] = {"hits": hits, "payloads": payloads_served(drains[1:]),
                       "compressed_batches": st["compressed_batches"],
                       "offset_fallbacks": st["offset_fallbacks"],
                       "compress_p50_us": compress["p50"]}
    log(f"compressed, no cache: records equal the cpu raw run ({hits} hits over 2 drains); "
        f"warm payloads {rep['no_cache']['payloads']}; compressed_batches "
        f"{st['compressed_batches']}, offset_fallbacks {st['offset_fallbacks']}; "
        f"serve.phase.compress p50 {compress['p50']:.1f} us")

    oidx, oq = overflow_world()
    knobs = dict(buckets=(256,), max_batch=4, top_k=64)
    cpu = SearchService(oidx, ServeConfig(**knobs), device="cpu")
    for q in oq:
        cpu.submit(q)
    owant = cpu.drain()
    for use_cache in (True, False):
        osvc = SearchService(oidx, ServeConfig(**knobs, compressed=True,
                                               use_compressed_cache=use_cache), device=dev)
        odrains, _ = drain_all(osvc, oq, ("cold", "warm"), "overflow")
        ohits = check_records(odrains, owant, oq, "overflow")
        served = payloads_served(odrains)
        ost = osvc.stats_snapshot()
        if {k.split("/")[1] for k in served} != {"offsets"} or ohits == 0:
            raise AssertionError(f"far-apart corpus: served {served}, {ohits} hits; "
                                 "every family must be served as offsets")
        if not ost["offset_fallbacks"] == ost["compressed_batches"] >= len(oq):
            raise AssertionError(f"far-apart corpus: {ost['offset_fallbacks']} offset "
                                 f"fallbacks of {ost['compressed_batches']} batches")
        rep[f"overflow_cache_{use_cache}"] = {"payloads": served,
                                               "offset_fallbacks": ost["offset_fallbacks"]}
        log(f"compressed, far-apart corpus (compressed cache {use_cache}): served {served}, "
            f"records equal the cpu raw run ({ohits} hits), offset_fallbacks "
            f"{ost['offset_fallbacks']} of {ost['compressed_batches']} batches")
    return rep, svc


class TicketLog:
    """The service, recording every ticket submitted through it (so the
    load phase can read latency percentiles the LoadReport omits)."""

    def __init__(self, svc):
        self.svc = svc
        self.tickets = []

    @property
    def _queue(self):
        return self.svc._queue

    def submit(self, *args, **kwargs):
        ticket = self.svc.submit(*args, **kwargs)
        self.tickets.append(ticket)
        return ticket

    def drain(self):
        return self.svc.drain()


def load_phase(svc, queries) -> dict:
    """The warm compressed service under load: a closed loop of
    LOAD_CLOSED requests gives its capacity; then, with every shape
    warm, an open-loop Poisson trace at half that rate for LOAD_SECONDS
    with the default 50 ms deadline. Nothing is asserted on speed."""
    from repro_torch.serving import (
        poisson_arrivals,
        run_closed_loop,
        run_open_loop,
        warm_service,
    )
    from repro_torch.serving.load import SERVED_STATUSES

    t = time.perf_counter()
    n_steps = warm_service(svc, queries)
    log(f"load: warm_service {time.perf_counter() - t:.2f} s, {n_steps} steps warm")
    closed = run_closed_loop(svc, queries, LOAD_CLOSED)
    log(f"load: closed loop {closed.n_offered} requests, {closed.achieved_qps:.1f} qps, "
        f"e2e p50 {closed.e2e_p50_us:.1f} us p95 {closed.e2e_p95_us:.1f} us, "
        f"met {closed.met_rate:.3f}")
    arrivals = poisson_arrivals(0.5 * closed.achieved_qps, LOAD_SECONDS, seed=2)
    rec = TicketLog(svc)
    opened = run_open_loop(rec, queries, arrivals, offered_qps=len(arrivals) / LOAD_SECONDS)
    e2e = sorted(t.result().e2e_s * 1e6 for t in rec.tickets
                 if t.result().status in SERVED_STATUSES)
    p99 = e2e[min(len(e2e) - 1, int(round(0.99 * (len(e2e) - 1))))] if e2e else 0.0
    log(f"load: open loop offered {opened.offered_qps:.1f} qps for {LOAD_SECONDS:.1f} s "
        f"({opened.n_offered} requests) -> achieved {opened.achieved_qps:.1f} qps, "
        f"served {opened.n_served}; met {opened.met_rate:.3f} (of offered "
        f"{opened.met_rate_offered:.3f}), shed {opened.shed_rate:.3f}, reject "
        f"{opened.reject_rate:.3f}; e2e p50 {opened.e2e_p50_us:.1f} us p99 {p99:.1f} us; "
        f"queue wait p50 {opened.queue_wait_p50_us:.1f} us")
    return {"closed": closed.as_dict(), "open": dict(opened.as_dict(), e2e_p99_us=p99)}


# -- the segmented path: the ingest tier under churn -----------------------------
def drain_timed(svc, queries) -> tuple[list, float]:
    for q in queries:
        svc.submit(q)
    t = time.perf_counter()
    out = svc.drain()
    return out, time.perf_counter() - t


def cache_counts(svc) -> dict:
    """The row caches' hits and retained entries, cumulative."""
    st = svc.stats_snapshot()
    return {name: {k: st[name][k] for k in ("hits", "misses", "retained", "invalidations")}
            for name in ("pack_cache", "compressed_cache") if st[name]}


def segmented_phase(dev, table, lex, queries) -> dict:
    """The serving CLI's corpus streamed into a background
    ``SegmentedIndex`` (``SEG_SEED`` of the documents), then
    ``SEG_ROUNDS`` churn rounds as ``benchmarks/churn_bench.py`` defines
    churn: each adds a chunk of the held-back documents, deletes live ones
    up to ``SEG_DELETE`` of the corpus, refreshes (``wait=False``; the
    last round quiesces with ``wait=True``) and drains the queries on the
    card, raw and compressed, cold then warm, each drain's records equal
    to a CPU service over the same source refreshed at the same point.
    The compressed service keeps the compressed payloads (no measured
    arbitration, which settles on raw at this size). Then
    ``SEG_LIVE_ADDS`` unsealed documents and two unrefreshed deletes,
    served with ``serve_memtable`` (``scalar_memtable`` on and off, raw and
    compressed) to the queries plus ``SEG_LIVE_QUERIES`` sampled from the
    unsealed documents, against CPU services of the same settings; every
    setting must serve some unsealed document; then a save,
    a load and a drain of the loaded index on the card, equal to the
    source's. The window join must launch in the phase."""
    from repro_torch.data.corpus import TokenTable, sample_mixed_queries
    from repro_torch.index import SegmentedIndex
    from repro_torch.kernels.nearest_r import window_join
    from repro_torch.serving import SearchService, ServeConfig
    from repro_torch.serving.planner import FB_LIVE_MEMTABLE

    docs = table.to_doc_lists()
    n_seed = int(SEG_SEED * len(docs))
    chunk = (len(docs) - n_seed - SEG_LIVE_ADDS) // SEG_ROUNDS
    n_delete = int(SEG_DELETE * len(docs)) // SEG_ROUNDS
    rng = np.random.default_rng(3)
    reset_counts()
    seg = SegmentedIndex(lex, max_distance=MAX_SEP, memtable_docs=SEG_MEMTABLE,
                         tier_fanout=SEG_FANOUT, background=True)
    rep: dict = {"memtable_docs": SEG_MEMTABLE, "tier_fanout": SEG_FANOUT, "rounds": []}
    try:
        t = time.perf_counter()
        for d in docs[:n_seed]:
            seg.add_document(d)
        ingest_s = time.perf_counter() - t
        t = time.perf_counter()
        view = seg.refresh(wait=False)
        rep["seed"] = {"docs": n_seed, "ingest_s": ingest_s, "docs_per_s": n_seed / ingest_s,
                       "refresh_ms": (time.perf_counter() - t) * 1e3}
        log(f"segmented: seeded {n_seed} docs in {ingest_s:.1f} s "
            f"({n_seed / ingest_s:.1f} docs/s, memtable_docs {SEG_MEMTABLE}, tier_fanout "
            f"{SEG_FANOUT}, background merges), refresh(wait=False) "
            f"{rep['seed']['refresh_ms']:.1f} ms, {len(view.segments)} segments")
        card = {"raw": SearchService(seg, ServeConfig(), device=dev),
                "compressed": SearchService(
                    seg, ServeConfig(compressed=True, payload_cost_driven=False), device=dev)}
        cpu = SearchService(seg, ServeConfig(), device="cpu")
        alive, nxt = list(range(n_seed)), n_seed
        for r in range(SEG_ROUNDS + 1):  # round 0 serves the seeded index
            rnd: dict = {"round": r}
            if r:
                t = time.perf_counter()
                for d in docs[nxt:nxt + chunk]:
                    alive.append(seg.add_document(d))
                rnd["added"], nxt = chunk, nxt + chunk
                rnd["add_docs_per_s"] = chunk / (time.perf_counter() - t)
                for i in sorted(rng.choice(len(alive), n_delete, replace=False), reverse=True):
                    seg.delete_document(alive.pop(i))
                rnd["deleted"] = n_delete
                quiesce = r == SEG_ROUNDS
                t = time.perf_counter()
                view = seg.refresh(wait=quiesce, timeout=SEG_WAIT_S)
                rnd["quiesce_ms" if quiesce else "refresh_ms"] = (time.perf_counter() - t) * 1e3
            for svc in (*card.values(), cpu):
                svc.refresh()
            want, rnd["cpu_drain_s"] = drain_timed(cpu, queries)
            for name, svc in card.items():
                before = cache_counts(svc)
                cold, cold_s = drain_timed(svc, queries)
                warm, warm_s = drain_timed(svc, queries)
                hits = check_records([cold, warm], want, queries, f"segmented round {r} {name}")
                after = cache_counts(svc)
                rnd[name] = {"cold_s": cold_s, "warm_s": warm_s, "hits": hits, "caches": {
                    c: {k: after[c][k] - before.get(c, {}).get(k, 0) for k in after[c]}
                    for c in after}, "payloads": payloads_served([warm])}
            view = seg.snapshot()
            rnd.update(segments=len(view.segments), tombstones=int(view.tombstones.size),
                       live_docs=int(view.live_doc_ids().size), merges=seg.stats["merges"],
                       seals=seg.stats["seals"],
                       executor={k: seg.executor.stats[k]
                                 for k in ("merged", "superseded", "noop", "failed")})
            rep["rounds"].append(rnd)
            log(f"segmented round {r}: +{rnd.get('added', 0)} -{rnd.get('deleted', 0)} docs"
                + (f" at {rnd['add_docs_per_s']:.1f} docs/s" if r else "")
                + "".join(f", {k.replace('_ms', '')} {rnd[k]:.1f} ms"
                          for k in ("refresh_ms", "quiesce_ms") if k in rnd)
                + f"; {rnd['live_docs']} live docs, {rnd['segments']} segments, "
                f"{rnd['tombstones']} tombstones, {rnd['seals']} seals, {rnd['merges']} merges, "
                f"executor {rnd['executor']}; cpu drain {rnd['cpu_drain_s']:.3f} s; "
                + "; ".join(f"{n} cold {rnd[n]['cold_s']:.3f} s warm {rnd[n]['warm_s']:.3f} s "
                            f"caches {rnd[n]['caches']} payloads {rnd[n]['payloads']}"
                            for n in card)
                + f"; records equal the cpu run ({rnd['raw']['hits']} hits over 2 drains)")

        # live memtable: unsealed adds and deletes, served before any refresh
        live_docs = docs[nxt:nxt + SEG_LIVE_ADDS]
        live_ids = [seg.add_document(d) for d in live_docs]
        seg.delete_document(alive[0])
        seg.delete_document(live_ids[0])
        live_queries = queries + sample_mixed_queries(
            TokenTable.from_docs([np.asarray(d, np.int32) for d in live_docs]), lex,
            SEG_LIVE_QUERIES, window=MAX_SEP, seed=4)
        rep["live"] = {}
        for scalar in (True, False):
            knobs = dict(serve_memtable=True, scalar_memtable=scalar)
            oracle = SearchService(seg, ServeConfig(**knobs), device="cpu")
            oracle.refresh()
            if oracle.index.mem_overlay is None:
                raise AssertionError("segmented live: the live view has no memtable overlay")
            want, cpu_s = drain_timed(oracle, live_queries)
            for comp in (False, True):
                name = f"{'compressed' if comp else 'raw'} scalar_memtable={scalar}"
                svc = SearchService(seg, ServeConfig(compressed=comp, **knobs), device=dev)
                svc.refresh()
                got, s_ = drain_timed(svc, live_queries)
                hits = check_records([got], want, live_queries, f"segmented live {name}")
                served = {int(x) for r_ in got for x in r_.results["doc"]}
                if served & {alive[0], live_ids[0]}:
                    raise AssertionError(f"segmented live {name}: served a deleted document")
                if not served & set(live_ids):
                    raise AssertionError(f"segmented live {name}: no unsealed document served")
                st = svc.stats_snapshot()
                n_live = st["plans"]["fallbacks"].get(FB_LIVE_MEMTABLE, 0)
                if (n_live > 0) != scalar:
                    raise AssertionError(f"segmented live {name}: {n_live} live-memtable "
                                         "fallbacks")
                rep["live"][name] = {"drain_s": s_, "cpu_drain_s": cpu_s, "hits": hits,
                                     "live_memtable_fallbacks": n_live,
                                     "unsealed_docs_served": len(served & set(live_ids)),
                                     "routes": st["plans"]["routes"]}
                log(f"segmented live ({SEG_LIVE_ADDS} unsealed docs, 2 unrefreshed deletes, "
                    f"{len(live_queries)} queries) "
                    f"{name}: drain {s_:.3f} s (cpu {cpu_s:.3f} s), records equal the cpu run "
                    f"({hits} hits, {len(served & set(live_ids))} unsealed docs served), "
                    f"{n_live} live-memtable fallbacks, routes {st['plans']['routes']}")

        # persistence: save (sealing the memtable), load, serve the loaded index
        with tempfile.TemporaryDirectory(prefix="chip_smoke_segmented_") as tmp:
            t = time.perf_counter()
            seg.save(tmp)
            save_s = time.perf_counter() - t
            keys = {kind: sum(getattr(g.index, kind).n_keys() for g in seg._segments)
                    for kind in ("ordinary", "wv", "fst")}
            t = time.perf_counter()
            loaded = SegmentedIndex.load(tmp)
            load_s = time.perf_counter() - t
        loaded.refresh(wait=False)  # publish the saved segments as they are
        seg.refresh(wait=False)  # and the source's: save sealed its memtable
        cpu.refresh()
        want, _ = drain_timed(cpu, queries)
        svc = SearchService(loaded, ServeConfig(), device=dev)
        got, s_ = drain_timed(svc, queries)
        hits = check_records([got], want, queries, "segmented save/load")
        rep["persist"] = {"save_s": save_s, "load_s": load_s, "drain_s": s_, "hits": hits,
                          "segments": loaded.n_segments, "keys": keys}
        log(f"segmented save/load: save {save_s:.1f} s, load {load_s:.1f} s "
            f"({loaded.n_segments} segments, keys {keys}), drain of the loaded index {s_:.3f} s, "
            f"records equal the source's cpu run ({hits} hits)")
    finally:
        seg.close()
    rep["launches"] = window_join.launches
    rep["executor"] = dict(seg.executor.stats)
    log(f"segmented: window_join launches {rep['launches']}; executor {rep['executor']}")
    if rep["launches"] <= 0:
        raise AssertionError("the segmented serve path never launched the nearest_r kernel")
    return rep


def step_batch(rng, family, B, L):
    """A top-of-ladder batch of one step family from synthetic rows (the
    window-join phase's gaps and fills): qt1 K=2 and qt2 K=3 rows with
    fragment bounds / interval widths of 0..5, qt34 and qt5 from
    ``ladder_case``."""
    from repro_torch.core import torch_search as ts
    from repro_torch.kernels.common import SENTINEL

    idf = (rng.random(B) + 1).astype(np.float32)
    adj = np.full(B, 2, np.float32)
    if family in ("qt1", "qt2"):
        K = COMPRESSED_K[family]
        g = gap_rows(rng, B * K, L, (1, 6), (L // 2, L)).reshape(B, K, L)
        pad = g == SENTINEL

        def off():
            return np.where(pad, SENTINEL, g + rng.integers(0, 6, g.shape, dtype=np.int32))

        if family == "qt1":
            lo = np.where(pad, SENTINEL, g - rng.integers(0, 6, g.shape, dtype=np.int32))
            return ts.QT1Batch(g, lo, off(), idf, adj, 1)
        return ts.QT2Batch(g, off(), np.full(B, K, np.int32), idf, adj, 1)
    Kn, Ks = COMPRESSED_K[family]
    arrays = ladder_case(rng, B, Kn, Ks, L)
    if family == "qt34":
        return ts.QT34Batch(*arrays, idf, adj, 1)
    return ts.QT5Batch(*arrays, idf, adj, 1)


def step_fns(family):
    """The raw, delta and offsets steps of one family (top_k 16)."""
    from repro_torch.core import torch_search as ts

    if family == "qt1":
        return {"raw": ts.make_qt1_serve_step(16),
                "delta": ts.make_qt1_serve_step_compressed(16, delta_g=True),
                "offsets": ts.make_qt1_serve_step_compressed(16, delta_g=False)}
    return {p: ts.make_wv_serve_step(family, 16, payload=p, max_distance=MAX_SEP, r_max=R_MAX)
            for p in ("raw", "delta", "offsets")}


def same_outputs(got, want) -> bool:
    """The four step outputs equal bit for bit (scores as int32 bits)."""
    return all(torch.equal(g.cpu().view(torch.int32) if g.dtype == torch.float32 else g.cpu(),
                           w.cpu().view(torch.int32) if w.dtype == torch.float32 else w.cpu())
               for g, w in zip(got, want))


def same_on_valid_lanes(got, want) -> bool:
    """Scores equal bit for bit, and (g, lo, hi) on every lane whose score
    is a hit: the window join leaves an invalid lane's lo/hi unspecified."""
    valid = want[0].cpu() > -1e29
    return (torch.equal(got[0].cpu().view(torch.int32), want[0].cpu().view(torch.int32))
            and all(torch.equal(g.cpu()[valid], w.cpu()[valid])
                    for g, w in zip(got[1:], want[1:])))


def compressed_steps_phase(dev) -> dict:
    """Each step family at the default ladder's top bucket (B=64,
    L=65536) from synthetic rows: the raw, delta and offsets steps on the
    card give the same four outputs bit for bit, equal to the CPU raw
    step's; then one batch whose 64-block spans more than uint16 raises
    the format's ValueError and its offsets step equals the raw one.
    Device ms per step (CUDA events), host-to-device bytes and bytes per
    posting slot per payload, and the time of the copy from host arrays."""
    from repro_torch.core import torch_search as ts
    from repro_torch.kernels.common import SENTINEL

    B, L = COMPRESSED_BL
    rng = np.random.default_rng(2030)
    out = {}
    for family in ("qt1", "qt2", "qt34", "qt5"):
        batch = step_batch(rng, family, B, L)
        compress = getattr(ts, f"compress_{family}_batch")
        host = {"raw": tuple(t.numpy() for t in batch.device_args("cpu")),
                "delta": compress(batch, delta_g=True),
                "offsets": compress(batch, delta_g=False)}
        steps = step_fns(family)
        t = time.perf_counter()
        want = steps["raw"](*batch.device_args("cpu"))
        cpu_s = time.perf_counter() - t
        valid = int((want[0] > -1e29).sum(dim=1).min())
        if valid < 16:
            raise AssertionError(f"compressed steps {family}: a row has {valid} valid lanes in "
                                 "its top 16; the synthetic rows must fill every slot")
        rows = COMPRESSED_K[family] if family in ("qt1", "qt2") else 1 + COMPRESSED_K[family][0]
        slots = B * rows * L
        rec = {"B": B, "L": L, "posting_slots": slots, "cpu_raw_s": cpu_s}
        parts = []
        for payload, arrays in host.items():
            args = ts.to_device(arrays, dev)
            got = steps[payload](*args)
            torch.cuda.synchronize()
            if not same_outputs(got, want):
                raise AssertionError(f"compressed steps {family} {payload}: the card's outputs "
                                     "differ from the cpu raw step's")
            nbytes = sum(a.nbytes for a in arrays)
            rec[payload] = {
                "ms": device_ms(lambda: steps[payload](*args)),
                "h2d_bytes": nbytes, "bytes_per_posting": nbytes / slots,
                "h2d_ms": call_ms(lambda: ts.to_device(arrays, dev)),
                "dtypes": sorted({str(a.dtype) for a in arrays})}
            r = rec[payload]
            parts.append(f"{payload} {r['ms']:.4f} ms, H2D {nbytes / 1e6:.2f} MB "
                         f"({r['bytes_per_posting']:.3f} B/posting) in {r['h2d_ms']:.3f} ms")
        out[family] = rec
        log(f"compressed step {family} B={B} L={L} ({slots} posting slots): raw, delta and "
            f"offsets equal bit for bit and equal the cpu raw step ({cpu_s:.2f} s); "
            + "; ".join(parts))

    batch = step_batch(rng, "qt34", B, L)
    live = batch.a_g[0] != SENTINEL
    batch.a_g[0, 1:][live[1:]] += 70_000  # block 0 of row 0 now spans > 2**16
    try:
        ts.compress_qt34_batch(batch, delta_g=True)
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError("compressed steps: a 64-block spanning > 2**16 did not raise")
    steps = step_fns("qt34")
    want = steps["raw"](*batch.device_args(dev))
    got = steps["offsets"](*ts.to_device(ts.compress_qt34_batch(batch, delta_g=False), dev))
    torch.cuda.synchronize()
    if not same_outputs(got, want):
        raise AssertionError("compressed steps: the overflow batch's offsets step differs from raw")
    out["overflow"] = msg
    log(f"compressed step qt34 overflow: delta16 raises ValueError ({msg}); offsets equals raw")
    return out


def step_calls(svc, families=("qt34", "qt5")) -> int:
    """Calls of the service's steps of ``families`` so far: every batch,
    plus the warm-up run of each (kind, B, L) on its first batch."""
    fam = lambda kind: kind.split("_", 1)[0]  # noqa: E731
    ex = svc.compiled
    return (sum(n for (kind, _, _), n in ex.executables.items() if fam(kind) in families)
            + sum(1 for (kind, _, _) in ex.compile_times if fam(kind) in families))


def check_as_sets(drain, want, queries, what: str) -> dict:
    """A sharded drain against the unsharded one: on the same route, the
    same (doc, start, end, score) set, scores bitwise; a query the sharded
    planner sends to the scalar engine (``sharded_qt2_window``, or a row
    that outgrows the ladder once multiplied by the shard count) comes
    back with that engine's float64 scores: the same matches, the scores
    equal to float32 rounding (rtol 1e-6). Returns the counts of each."""
    counts = {"same_route": 0, "rerouted": 0}
    for qi, (g, w) in enumerate(zip(drain, want)):
        cols = [g.results[c] for c in ("doc", "start", "end")]
        wcols = [w.results[c] for c in ("doc", "start", "end")]
        if g.path == w.path:
            got = set(zip(*(c.tolist() for c in cols), g.results["score"].view(np.int32).tolist()))
            exp = set(zip(*(c.tolist() for c in wcols), w.results["score"].view(np.int32).tolist()))
            ok = got == exp
            counts["same_route"] += 1
        else:
            got = sorted(zip(*(c.tolist() for c in cols), g.results["score"].tolist()))
            exp = sorted(zip(*(c.tolist() for c in wcols), w.results["score"].tolist()))
            ok = (g.path == "cpu" and [r[:3] for r in got] == [r[:3] for r in exp]
                  and np.allclose([r[3] for r in got], [r[3] for r in exp], rtol=1e-6, atol=0))
            counts["rerouted"] += 1
        if not ok:
            raise AssertionError(f"{what}: query {qi} {queries[qi]} ({g.path} vs {w.path}): the "
                                 "sharded records differ from the unsharded drain's as sets")
    return counts


def sharded_phase(dev, index, queries, unsharded) -> dict:
    """Doc-sharded serving over (1, S) meshes on the serve phase's corpus
    and queries: a raw service on (1, 4) and on (1, 2), with every shard
    on this card (or, with four cards visible, raw (1, 4) on four cards
    too), and a compressed one on (1, 4) with the compressed-row cache,
    each drained cold then warm with the counts set to 0. Every drain
    equals the port's sharded CPU service on the same mesh shape (ordered,
    scores bitwise) and, as sets, the unsharded drain; the window join is
    launched S times per qt34/qt5 step call. Then the sharded step at the
    top bucket on (1, 4) against the unsharded step on the same rows."""
    from repro_torch.core import torch_search as ts
    from repro_torch.kernels.nearest_r import window_join
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import SearchService, ServeConfig

    def mesh(devices):
        return make_mesh((1, len(devices)), ("data", "model"), devices=devices)

    n_cards = torch.cuda.device_count()
    log(f"sharded: torch.cuda.device_count() = {n_cards}")
    cases = [("raw (1, 4)", False, [dev] * 4), ("raw (1, 2)", False, [dev] * 2),
             ("compressed (1, 4)", True, [dev] * 4)]
    if n_cards >= 4:
        cases.append(("raw (1, 4) on four cards", False,
                      [torch.device("cuda", i) for i in range(4)]))
    else:
        log("sharded: fewer than four cards visible; the shards share one card and the "
            "cross-card copy of the top-k gather was not exercised")
    rep = {"device_count": n_cards, "cross_card": n_cards >= 4, "services": {}, "cpu_s": {}}
    want = {}
    for S in sorted({len(d) for _, _, d in cases}):
        cpu = SearchService(index, ServeConfig(doc_shards=S), mesh=mesh(["cpu"] * S))
        for q in queries:
            cpu.submit(q)
        t = time.perf_counter()
        want[S] = cpu.drain()
        rep["cpu_s"][S] = time.perf_counter() - t
        log(f"sharded: cpu (1, {S}) drain {rep['cpu_s'][S]:.3f} s")

    reset_counts()
    launches = 0
    for name, comp, devices in cases:
        S = len(devices)
        svc = SearchService(index, ServeConfig(doc_shards=S, compressed=comp),
                            mesh=mesh(devices))
        before = window_join.launches
        drains, per_drain = drain_all(svc, queries, ("cold", "warm"), f"sharded {name}")
        n = window_join.launches - before
        launches += n
        calls = step_calls(svc)
        if n != S * calls or calls == 0:
            raise AssertionError(f"sharded {name}: {n} window_join launches for {calls} "
                                 f"qt34/qt5 step calls over {S} shards")
        hits = check_records(drains, want[S], queries, f"sharded {name}")
        sets = check_as_sets(drains[-1], unsharded, queries, f"sharded {name}")
        stats = svc.stats_snapshot()
        rec = {"S": S, "devices": [str(d) for d in devices], "compressed": comp,
               "launches": n, "qt34_qt5_step_calls": calls,
               "launches_per_drain": per_drain, "routes": stats["plans"]["routes"],
               "fallbacks": stats["plans"]["fallbacks"], "hits": hits, "as_sets": sets,
               "compressed_batches": stats["compressed_batches"],
               "offset_fallbacks": stats["offset_fallbacks"],
               "metrics": serve_metrics(svc, f"sharded {name}")}
        rep["services"][name] = rec
        log(f"sharded {name}: records equal the cpu (1, {S}) service ({hits} hits over 2 "
            f"drains) and, as sets, the unsharded drain ({sets}); window_join launches {n} "
            f"= {S} x {calls} qt34/qt5 step calls; routes {rec['routes']}; fallbacks "
            f"{rec['fallbacks']}; compressed batches {rec['compressed_batches']} "
            f"({rec['offset_fallbacks']} offsets)")
    rep["launches"] = launches
    if launches <= 0:
        raise AssertionError("the sharded serve path never launched the nearest_r kernel")

    B, L = COMPRESSED_BL
    rng = np.random.default_rng(2031)
    rep["steps"] = {}
    for family in ("qt34", "qt5"):
        batch = step_batch(rng, family, B, L)
        host = batch.host_args()
        single = step_fns(family)["raw"]
        make = lambda m: ts.make_wv_serve_step(family, 16, payload="raw",  # noqa: E731
                                               max_distance=MAX_SEP, r_max=R_MAX, mesh=m)
        sharded = make(mesh([dev] * 4))
        want_cpu = make(mesh(["cpu"] * 4))(*host)
        placed = sharded.place(host)
        args = ts.to_device(host, dev)
        got = sharded.run(placed)
        torch.cuda.synchronize()
        if not same_on_valid_lanes(got, want_cpu):
            raise AssertionError(f"sharded step {family}: the card's outputs differ from the "
                                 "cpu sharded step's")
        r = {"B": B, "L": L, "S": 4, "Ls": L // 4,
             "sharded_ms": device_ms(lambda: sharded.run(placed)),
             "unsharded_ms": device_ms(lambda: single(*args)),
             "place_ms": call_ms(lambda: sharded.place(host)),
             "to_device_ms": call_ms(lambda: ts.to_device(host, dev))}
        rep["steps"][family] = r
        log(f"sharded step {family} B={B} L={L} on (1, 4), Ls={L // 4}: equals the cpu "
            f"sharded step; device {r['sharded_ms']:.4f} ms (4 window-join launches, the "
            f"gather and the second top-k) vs unsharded {r['unsharded_ms']:.4f} ms on the "
            f"same rows; host-to-shards copy {r['place_ms']:.3f} ms vs whole "
            f"{r['to_device_ms']:.3f} ms")
    return rep


def tune_phase(dev) -> dict:
    """A two-by-two sweep (MaxDistance by max_batch) on the serving CLI's
    default corpus, its estimate rung and one measured closed-loop rung on
    the card; the winner's artifact is then served on the card by
    ``python -m repro_torch.launch.serve --config``."""
    from repro_torch import tune
    from repro_torch.core.index_builder import build_index
    from repro_torch.data.corpus import generate_corpus

    t0 = time.perf_counter()
    table, lex = generate_corpus(TUNE_DOCS, mean_doc_len=160, vocab_size=40_000, seed=1)
    indexes = {d: build_index(table, lex, max_distance=d) for d in TUNE_DISTANCES}
    wl = tune.make_workload("mixed", table, lex, TUNE_QUERIES, window=MAX_SEP, seed=3)
    build_s = time.perf_counter() - t0
    cands = tune.grid(TUNE_DISTANCES, {"max_batch": list(TUNE_BATCHES)})
    t = time.perf_counter()
    out = tune.sweep(indexes, None, cands, wl, objective=tune.Objective(deadline_s=0.05),
                     device=dev)
    sweep_s = time.perf_counter() - t
    winner = out.winner
    log(f"tune: {TUNE_DOCS} docs, indexes at MaxDistance {TUNE_DISTANCES} and "
        f"{len(wl)} mixed queries in {build_s:.1f} s; sweep of {len(cands)} in "
        f"{sweep_s:.1f} s; rungs " + " | ".join(
            ", ".join(f"{r['config_id']} {r['score']:.1f}" for r in rung)
            for rung in out.history))
    for v in out.verdicts:
        m = out.measurements[v["config_id"]]
        log(f"tune: measured {v['config_id']}: e2e p50 {m['p50_us']:.1f} us, p95 "
            f"{m['p95_us']:.1f} us, met {m['met_rate']:.3f}, {m['achieved_qps']:.1f} QPS, "
            f"score {v['score']:.1f}")
    by_id = {c.config_id: c for c in cands}
    table_ = tune.sensitivity_table([(by_id[r["config_id"]], r["score"])
                                     for r in out.history[0]])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        path = Path(tmp) / "tuned_serve_config.json"
        tune.emit_serve_config(str(path), winner.max_distance,
                               winner.serve_config(),
                               meta={"workload": wl.name, "verdict": out.winner_verdict})
        env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
        t = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--config",
                              str(path), "--n-docs", str(TUNE_DOCS), "--requests", "256"],
                             cwd=Path(__file__).resolve().parent, env=env,
                             capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t
    if run.returncode != 0 or "served 256 requests" not in run.stdout \
            or "loaded tuned config" not in run.stderr:
        raise AssertionError(f"tune: serving the artifact failed:\n{run.stdout}\n{run.stderr}")
    served = run.stdout.strip().splitlines()
    log(f"tune: winner {winner.config_id}; --config served on the card in {cli_s:.1f} s: "
        + " / ".join(served[:2]))
    return {"winner": winner.config_id, "verdict": out.winner_verdict,
            "history": out.history, "measurements": out.measurements,
            "sensitivity": table_, "build_s": build_s, "sweep_s": sweep_s,
            "cli_s": cli_s, "cli_stdout": served}


# -- the model zoo's serving paths ----------------------------------------------
MODEL_SEED = 19
# LM cells: prefill_32k cut to (B, S); decode_32k cut to B, on a cache of
# s_max rows (None: S + steps), greedy steps after the first decode; an
# int8 run; the built steps, or the model's functions without a mesh
# (granite: the dense MoE path, where a (1, 1) mesh's capacity dispatch
# would drop tokens at decode's two-token batches, as the reference's does)
LM_RUNS = (("stablelm-1.6b", 4, 4096, 32, 32768, True, True),
           ("granite-moe-1b-a400m", 2, 2048, 16, None, False, False))
DIN_RETRIEVAL_C = 65_536  # (C, 100, 144) float32 features: 60 GB at retrieval_cand's C
BATCHER_SLOTS, BATCHER_PROMPTS, BATCHER_MAX_LEN = 8, 16, 32
SLICE_ROWS = 4096  # serve_bulk rows checked against the plain bag
RECSYS_TOL = 1e-5  # rtol and atol of tests/test_torch_recsys.py
LM_CONSISTENCY_COS = 0.999  # prefill(S + 1) against decode at S after prefill(S)
INT8_COS, INT8_AGREE = 0.995, 0.9  # tests/test_kv_int8.py's thresholds


def timed(fn):
    """(result, ms) of one call between two CUDA events, synchronised."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def median_ms(fn, n: int = 5) -> float:
    return statistics.median(timed(fn)[1] for _ in range(n))


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def cut_arch(arch, **shapes):
    """``arch`` with its shapes replaced: name=(kind, dims)."""
    from dataclasses import replace

    from repro_torch.configs.base import ShapeSpec
    return replace(arch, shapes={n: ShapeSpec(n, k, d) for n, (k, d) in shapes.items()})


def same_top_k(got, want, what: str) -> int:
    """Card against host top-k: scores within RECSYS_TOL rank by rank; an
    id may differ only where the host's scores tie within that tolerance
    (a swap of near-equal candidates). Returns the number of such ranks."""
    gv, gi = (t.cpu().double().numpy()[0] for t in got)
    wv, wi = (t.double().numpy()[0] for t in want)
    np.testing.assert_allclose(gv, wv, rtol=RECSYS_TOL, atol=RECSYS_TOL, err_msg=what)
    tol = RECSYS_TOL + RECSYS_TOL * np.abs(wv)
    swaps = 0
    for r in np.flatnonzero(gi != wi):
        at = np.flatnonzero(wi == gi[r])
        near = wv[at[0]] if at.size else wv[-1]
        if abs(near - wv[r]) > tol[r] + tol[-1]:
            raise AssertionError(f"{what}: rank {r} holds {int(gi[r])} on the card and "
                                 f"{int(wi[r])} on the host, scores not tied")
        swaps += 1
    return swaps


def recsys_inputs(dev, mesh) -> dict:
    """The four recsys models at full width on the card: each built step
    and its inputs from materialize_inputs (the port's seeded init and the
    reference's synthetic batches); din's retrieval_cand cut to
    DIN_RETRIEVAL_C candidates."""
    from repro_torch.configs.recsys_archs import BERT4REC, DIN, SASREC, TWO_TOWER
    from repro_torch.launch.steps import build_step, materialize_batch, materialize_inputs

    din = cut_arch(DIN, serve_p99=("serve", DIN.shapes["serve_p99"].dims),
                   retrieval_cand=("retrieval", {"batch": 1, "n_candidates": DIN_RETRIEVAL_C}))
    plan = ((TWO_TOWER, ("serve_p99", "serve_bulk", "retrieval_cand")),
            (din, ("serve_p99", "retrieval_cand")),
            (BERT4REC, ("serve_p99", "retrieval_cand")),
            (SASREC, ("serve_p99", "retrieval_cand")))
    out = {}
    for arch, shapes in plan:
        steps, params = {}, None
        for i, name in enumerate(shapes):
            built = build_step(arch, name, mesh)
            if i == 0:
                params, batch = materialize_inputs(arch, name, built, seed=MODEL_SEED)
            else:
                (batch,) = materialize_batch(arch, name, built, seed=MODEL_SEED + i)
            steps[name] = {"built": built, "batch": batch}
        out[arch.arch_id] = {"arch": arch, "params": params, "steps": steps}
    torch.cuda.synchronize()
    return out


def lm_inputs(dev, mesh) -> dict:
    """stablelm-1.6b and granite-moe-1b-a400m at full width: the cut
    prefill and decode steps (stablelm's int8 decode step built with
    REPRO_KV_INT8=1, as the reference reads it) or the model's functions
    without a mesh, bf16 weights and a prompt from materialize_inputs,
    and the next token."""
    from functools import partial

    from repro_torch.configs.lm_archs import GRANITE_MOE, STABLELM_1_6B
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import transformer

    out = {}
    for arch, (arch_id, B, S, steps, s_max, int8, on_mesh) in zip(
            (STABLELM_1_6B, GRANITE_MOE), LM_RUNS):
        s_max = s_max or S + steps + 1
        cut = cut_arch(arch, prefill_32k=("prefill", {"seq_len": S, "global_batch": B}),
                       decode_32k=("decode", {"seq_len": s_max, "global_batch": B}))
        pre = build_step(cut, "prefill_32k", mesh)
        dec = build_step(cut, "decode_32k", mesh)
        dec8 = None
        if int8:
            old = os.environ.get("REPRO_KV_INT8")
            os.environ["REPRO_KV_INT8"] = "1"
            try:
                dec8 = build_step(cut, "decode_32k", mesh)
            finally:
                if old is None:
                    del os.environ["REPRO_KV_INT8"]
                else:
                    os.environ["REPRO_KV_INT8"] = old
        params, prompt = materialize_inputs(cut, "prefill_32k", pre, seed=MODEL_SEED)
        nxt = np.random.default_rng(MODEL_SEED + 1).integers(0, arch.model_cfg.vocab, (B, 1))
        fns = ((pre.fn, dec.fn) if on_mesh else
               (partial(transformer.prefill, arch.model_cfg),
                partial(transformer.decode_step, arch.model_cfg)))
        out[arch_id] = {"arch": cut, "cfg": arch.model_cfg, "pre": fns[0], "dec": fns[1],
                        "dec8": dec8 and dec8.fn, "on_mesh": on_mesh,
                        "params": params, "prompt": prompt,
                        "next": torch.from_numpy(nxt.astype(np.int32)).to(dev),
                        "B": B, "S": S, "steps": steps, "s_max": s_max}
    torch.cuda.synchronize()
    return out


def lm_bounds(cfg, params, B: int, S: int, s_max: int) -> dict:
    """Least times on this card: a decode step reads every weight and the
    whole cache once (its attention spans all s_max rows); a prefill does
    2 operations per active layer weight per token plus causal attention
    (2 products over S^2 / 2 pairs of head_dim per head) at the bf16 rate."""
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    kv = 2 * cfg.n_layers * B * s_max * cfg.n_kv * cfg.head_dim  # k and v values
    embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    ops = (2 * (cfg.active_param_count() - embed) * B * S
           + 2 * cfg.n_layers * B * cfg.n_heads * cfg.head_dim * S * S)
    return {"decode_ms": (weights + 2 * kv) / HBM_BYTES_PER_S * 1e3,
            "decode_int8_ms": (weights + kv + kv // cfg.head_dim * 4) / HBM_BYTES_PER_S * 1e3,
            "prefill_ms": max(ops / BF16_OPS_PER_S, weights / HBM_BYTES_PER_S) * 1e3}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def drive_lm(run: dict) -> dict:
    """Prefill(S), prefill(S + 1) for the consistency check, then decode
    on an s_max cache holding the prefill: the next token at position S,
    then greedy steps; with an int8 step, the same stream teacher-forced
    on an int8 cache filled with the quantised prefill."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import quantize_kv

    cfg, params, S, B = run["cfg"], run["params"], run["S"], run["B"]
    dev = params["embed"].device
    (last, kv), prefill_ms = timed(lambda: run["pre"](params, run["prompt"]))
    longer = torch.cat([run["prompt"], run["next"]], dim=1)
    full, prefill1_ms = timed(lambda: transformer.prefill(cfg, params, longer)[0])
    cache = transformer.init_cache(cfg, B, run["s_max"], device=dev)
    for n in ("k", "v"):
        cache[n][:, :, :S] = kv[n]
    logits, step_ms, fed = [], [], [run["next"]]
    for i in range(run["steps"] + 1):
        (lg, cache), ms = timed(lambda: run["dec"](params, fed[i], cache, S + i))
        logits.append(lg)
        step_ms.append(ms)
        fed.append(lg.argmax(dim=-1, keepdim=True).to(torch.int32))
    del cache
    bounds = lm_bounds(cfg, params, B, S, run["s_max"])
    rec = {"path": "built steps on a (1, 1) mesh" if run["on_mesh"] else "model functions, no mesh",
           "prefill": {"B": B, "S": S, "ms": prefill_ms, "S_plus_1_ms": prefill1_ms,
                       "bound_ms": bounds["prefill_ms"]},
           "decode": {"B": B, "cache_rows": run["s_max"], "first_position": S,
                      "greedy_steps": run["steps"], "step_ms": step_ms,
                      "median_step_ms": statistics.median(step_ms[1:]),
                      "bound_ms": bounds["decode_ms"]},
           "finite": bool(torch.isfinite(last.float()).all() and torch.isfinite(full.float()).all()
                          and all(torch.isfinite(x.float()).all() for x in logits)),
           "consistency_cos": cosine(logits[0], full)}
    if run["dec8"] is not None:
        cache8 = transformer.init_cache(cfg, B, run["s_max"], quantized=True, device=dev)
        for layer in range(cfg.n_layers):
            for n in ("k", "v"):
                q8, scale = quantize_kv(kv[n][layer])
                cache8[n][layer, :, :S] = q8
                cache8[f"{n}_scale"][layer, :, :S] = scale
        logits8, step8_ms = [], []
        for i in range(run["steps"] + 1):
            (lg, cache8), ms = timed(lambda: run["dec8"](params, fed[i], cache8, S + i))
            logits8.append(lg)
            step8_ms.append(ms)
        del cache8
        a, b = torch.stack(logits8), torch.stack(logits)
        rec["int8"] = {"step_ms": step8_ms, "median_step_ms": statistics.median(step8_ms[1:]),
                       "bound_ms": bounds["decode_int8_ms"],
                       "cos_vs_bf16": cosine(a, b),
                       "argmax_agreement": float((a.argmax(-1) == b.argmax(-1)).double().mean())}
    del kv
    torch.cuda.empty_cache()
    return rec


def drive_batcher(cfg, params, prompts, device) -> tuple[dict, int]:
    """LMContinuousBatcher over BATCHER_SLOTS slots, every prompt submitted
    at once, stepped to completion: (outputs by request id, steps)."""
    from repro_torch.serving import LMContinuousBatcher

    batcher = LMContinuousBatcher(cfg, params, BATCHER_SLOTS, BATCHER_MAX_LEN, device=device)
    for p in prompts:
        batcher.submit(p)
    done, steps = {}, 0
    while len(done) < len(prompts):
        done.update(batcher.step())
        steps += 1
        if steps > len(prompts) * BATCHER_MAX_LEN:
            raise AssertionError("the batcher did not finish its prompts")
    return done, steps


def bag_record(params, batch) -> dict:
    """The embedding-bag kernel at serve_bulk: kernel, wrapper, plain
    version (over SLICE_ROWS-row slices: its (B, S, D) gather does not fit
    at once) and F.embedding_bag, against the bound counted from these
    ids (each distinct row read once)."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_plain
    from repro_torch.kernels.embedding_bag.ops import launch_embedding_bag

    table, ids = params["item_emb"], batch["hist"]
    (B, S), (V, D) = ids.shape, table.shape
    valid = (ids >= 0) & (ids < V)
    rows = int(torch.unique(ids[valid]).numel())
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    lib = F.embedding_bag(ids, table, mode="sum")
    ref = embedding_bag(ids, table, None, "sum")
    n_valid = int(valid.sum())
    rec = {"B": B, "S": S, "V": V, "D": D, "valid_ids": n_valid, "distinct_rows": rows,
           "ms": device_ms(lambda: launch_embedding_bag(ids, table, None, out, mean=False)),
           "wrapper_ms": call_ms(lambda: embedding_bag(ids, table, None, "sum")),
           "plain_ms": device_ms(lambda: [embedding_bag_plain(ids[i:i + SLICE_ROWS], table)
                                          for i in range(0, B, SLICE_ROWS)], runs=5),
           "plain": f"embedding_bag_plain over {SLICE_ROWS}-row slices",
           "library_ms": device_ms(lambda: F.embedding_bag(ids, table, mode="sum")),
           "library": "F.embedding_bag(mode='sum')",
           "library_max_abs_diff": float((lib - ref).abs().max()),
           "bytes_all_lookups": 4 * B * S + n_valid * D * table.element_size()
           + B * D * table.element_size(),
           **window_bound(4 * B * S + rows * D * table.element_size(),
                          B * D * table.element_size(), n_valid * D)}
    rec["bound_all_lookups_ms"] = rec["bytes_all_lookups"] / HBM_BYTES_PER_S * 1e3
    return rec


def models_phase(dev) -> dict:
    """The model zoo's serving paths on the card (see the module
    docstring), each cut listed under ``reduced``."""
    from dataclasses import replace

    from repro_torch.configs.lm_archs import STABLELM_1_6B
    from repro_torch.kernels.embedding_bag import embedding_bag_plain
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import recsys, transformer

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"))
    cpu_mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    t0 = time.perf_counter()
    rs = recsys_inputs(dev, mesh)
    lms = lm_inputs(dev, mesh)
    bcfg = replace(STABLELM_1_6B.reduced().model_cfg, dtype="float32")
    bparams = transformer.init_params(bcfg, MODEL_SEED, device=dev)
    rng = np.random.default_rng(MODEL_SEED + 2)
    prompts = [rng.integers(1, bcfg.vocab, rng.integers(1, 7)).tolist()
               for _ in range(BATCHER_PROMPTS)]
    setup_s = time.perf_counter() - t0
    log(f"models: weights and inputs made on the card in {setup_s:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")

    # the main path, with every launch count at 0
    reset_counts()
    t_main = time.perf_counter()
    for m in rs.values():
        for step in m["steps"].values():
            step["out"], step["first_ms"] = timed(
                lambda: step["built"].fn(m["params"], step["batch"]))
    lm_recs = {arch_id: drive_lm(run) for arch_id, run in lms.items()}
    (card_out, b_steps), batcher_ms = timed(lambda: drive_batcher(bcfg, bparams, prompts, dev))
    main_s = time.perf_counter() - t_main
    launches = read_counts()
    n_bag = len(rs["two-tower-retrieval"]["steps"])
    log(f"models: main path launches {launches} in {main_s:.1f} s")
    if launches["embedding_bag.embedding_bag"] != n_bag:
        raise AssertionError(f"models: {launches['embedding_bag.embedding_bag']} bag launches "
                             f"for {n_bag} two-tower user towers")

    report = {"launches": launches, "setup_s": setup_s, "main_s": main_s, "recsys": {},
              "lm": lm_recs}
    # the two-tower path: the bag kernel against its plain version, the
    # scores against a CPU run on the same weights
    tt = rs["two-tower-retrieval"]
    cfg, params = tt["arch"].model_cfg, tt["params"]
    for name, rows in (("serve_p99", None), ("serve_bulk", SLICE_ROWS)):
        b = tt["steps"][name]["batch"]
        if rows:
            b = {k: v[:rows] for k, v in b.items()}
        u = recsys.twotower_user(cfg, params, b)
        hist = embedding_bag_plain(b["hist"], params["item_emb"])
        u_plain = recsys._tower(params["user_tower"], torch.cat([hist, b["user_feats"]], dim=-1))
        if not torch.equal(u, u_plain):
            raise AssertionError(f"two-tower {name}: user vectors differ from the tower fed by "
                                 f"the plain bag (max abs {float((u - u_plain).abs().max())})")
    t = time.perf_counter()
    host = to_device(params, "cpu")
    p99 = tt["steps"]["serve_p99"]
    want = build_step(tt["arch"], "serve_p99", cpu_mesh).fn(host, to_device(p99["batch"], "cpu"))
    torch.testing.assert_close(p99["out"].cpu(), want, rtol=RECSYS_TOL, atol=RECSYS_TOL)
    cpu_s = time.perf_counter() - t
    del host
    retr = tt["steps"]["retrieval_cand"]
    scores, idx = retr["out"]
    b = retr["batch"]
    u = recsys.twotower_user(cfg, params, b)
    v = recsys.twotower_item(cfg, params, b["cand_items"][idx[0].long()],
                             b["cand_cates"][idx[0].long()])
    torch.testing.assert_close(scores[0], v @ u[0], rtol=RECSYS_TOL, atol=RECSYS_TOL)
    if not bool((scores[0, :-1] >= scores[0, 1:]).all()):
        raise AssertionError("two-tower retrieval: top-k scores not in descending order")
    bag = bag_record(params, tt["steps"]["serve_bulk"]["batch"])
    log(f"models: two-tower-retrieval V={cfg.n_items} D={cfg.embed_dim}: user vectors equal "
        f"to the plain bag's tower at serve_p99 and {SLICE_ROWS} serve_bulk rows; serve_p99 "
        f"scores within {RECSYS_TOL} of the CPU run ({cpu_s:.1f} s with the host copy); "
        f"retrieval top-{idx.shape[1]} rescored; bag at serve_bulk B={bag['B']}: kernel "
        f"{bag['ms']:.4f} ms (wrapper {bag['wrapper_ms']:.4f} ms), plain {bag['plain_ms']:.4f} ms, "
        f"library {bag['library_ms']:.4f} ms, bound {bag['bound_ms']:.4f} ms by "
        f"{bag['bound_by']} ({bag['bytes'] / 1e9:.2f} GB, {bag['distinct_rows']} distinct "
        f"rows; {bag['bound_all_lookups_ms']:.4f} ms counting every lookup)")
    report["bag_serve_bulk"] = bag

    # every recsys step: warm times, and a CPU run on the same weights
    for arch_id, m in rs.items():
        host = None if arch_id == "two-tower-retrieval" else to_device(m["params"], "cpu")
        for name, step in m["steps"].items():
            warm = median_ms(lambda: step["built"].fn(m["params"], step["batch"]))
            rec = {"first_ms": step["first_ms"], "warm_ms": warm,
                   "dims": dict(m["arch"].shapes[name].dims)}
            out = step["out"]
            finite = all(bool(torch.isfinite(x.float()).all())
                         for x in (out if isinstance(out, tuple) else (out,)))
            if not finite:
                raise AssertionError(f"{arch_id} {name}: non-finite output")
            if host is not None:
                cpu_out = build_step(m["arch"], name, cpu_mesh).fn(
                    host, to_device(step["batch"], "cpu"))
                if isinstance(out, tuple):
                    rec["near_tie_swaps"] = same_top_k(out, cpu_out, f"{arch_id} {name}")
                else:
                    torch.testing.assert_close(out.cpu(), cpu_out, rtol=RECSYS_TOL,
                                               atol=RECSYS_TOL)
                rec["equals_cpu_run"] = True
            report["recsys"][f"{arch_id} {name}"] = rec
            log(f"models: {arch_id} {name} {rec['dims']}: first call {rec['first_ms']:.3f} ms, "
                f"warm {warm:.3f} ms" + (", equal to the CPU run within tolerance"
                                         if host is not None else ""))

    for arch_id, rec in lm_recs.items():
        if not rec["finite"]:
            raise AssertionError(f"{arch_id}: non-finite logits")
        line = (f"models: {arch_id} ({rec['path']}) prefill B={rec['prefill']['B']} "
                f"S={rec['prefill']['S']} "
                f"{rec['prefill']['ms']:.1f} ms; decode B={rec['decode']['B']} on "
                f"{rec['decode']['cache_rows']} cache rows from position "
                f"{rec['decode']['first_position']}: median step "
                f"{rec['decode']['median_step_ms']:.2f} ms (bound "
                f"{rec['decode']['bound_ms']:.2f} ms); prefill bound "
                f"{rec['prefill']['bound_ms']:.1f} ms; prefill(S+1) vs decode at S "
                f"cosine {rec['consistency_cos']:.6f}")
        if "int8" in rec:
            i8 = rec["int8"]
            line += (f"; int8 cache median step {i8['median_step_ms']:.2f} ms (bound "
                     f"{i8['bound_ms']:.2f} ms), cosine vs bf16 "
                     f"{i8['cos_vs_bf16']:.6f}, argmax agreement {i8['argmax_agreement']:.3f}")
            if not (i8["cos_vs_bf16"] > INT8_COS and i8["argmax_agreement"] >= INT8_AGREE):
                raise AssertionError(f"{arch_id}: int8 cache misses test_kv_int8.py's thresholds")
        log(line)
        if arch_id == "stablelm-1.6b" and rec["consistency_cos"] < LM_CONSISTENCY_COS:
            raise AssertionError(f"{arch_id}: decode at S disagrees with prefill(S+1)")

    t = time.perf_counter()
    host_out, host_steps = drive_batcher(bcfg, to_device(bparams, "cpu"), prompts, "cpu")
    if host_out != card_out or host_steps != b_steps:
        raise AssertionError("the card's batcher outputs differ from the CPU batcher's")
    report["batcher"] = {"slots": BATCHER_SLOTS, "prompts": BATCHER_PROMPTS,
                         "max_len": BATCHER_MAX_LEN, "steps": b_steps, "card_ms": batcher_ms,
                         "cpu_s": time.perf_counter() - t,
                         "tokens": sum(len(v) for v in card_out.values())}
    log(f"models: batcher {BATCHER_PROMPTS} prompts over {BATCHER_SLOTS} slots, {b_steps} "
        f"steps, {report['batcher']['tokens']} tokens in {batcher_ms:.1f} ms on the card; "
        f"outputs equal the CPU batcher's")
    report["reduced"] = [
        {"what": "stablelm-1.6b prefill_32k", "cut": "B 32 x S 32768 -> B 4 x S 4096",
         "why": "its KV cache alone would be ~206 GB"},
        {"what": "stablelm-1.6b decode_32k", "cut": "B 128 -> B 4 on the S 32768 cache, "
         "filled to 4096 by the prefill, positions 4096-4128",
         "why": "B 128's bf16 cache is ~824 GB; B 4's is ~25.8 GB (int8 ~13.7 GB)"},
        {"what": "granite-moe-1b-a400m", "cut": "prefill B 2 x S 2048, then 16 greedy decode "
         "steps on a cache of S + 17 rows", "why": "covers the MoE dense path, GQA and tied "
         "embeddings within the phase's time"},
        {"what": "din retrieval_cand", "cut": f"C 1,048,576 -> {DIN_RETRIEVAL_C}",
         "why": "its (C, 100, 144) float32 feature tensor is 60 GB at full C"},
        {"what": "the batcher", "cut": "stablelm's reduced config (2 layers, d 64) in float32",
         "why": "bf16 greedy tokens on two devices part at near-tied logits"},
        {"what": "all models", "cut": "random weights from a seed", "why": "no checkpoints"}]
    report["seconds"] = time.perf_counter() - t_phase
    del rs, lms, bparams
    torch.cuda.empty_cache()
    log(f"models: phase {report['seconds']:.1f} s; reduced: "
        + "; ".join(f"{r['what']}: {r['cut']}" for r in report["reduced"]))
    return report


# -- training: the bag's backward, the train steps, the supervisor, compressed DP --
# two-tower train batch: the shape's 65,536 reckoned (not run) at ~82.7 GB, 31.1 GB of parameters
# and moments plus three 17.2 GB (B, B) float32 tensors in the loss's backward; the 20.5 GB of
# table gradients come after those are freed (PERF.md §4)
TT_TRAIN_B = 32_768
LM_TRAIN = {"seq_len": 4096, "global_batch": 8}  # stablelm train_4k, cut from B 256
LM_ZIPF_A = 1.1  # the replays' token draw: the most frequent token ~10 % of a batch
# the replays of two gradient calls: stablelm at the train shape, granite-moe
# at the widest shape the script runs it (the models phase's prefill)
LM_REPLAYS = (("stablelm-1.6b", LM_TRAIN), ("granite-moe-1b-a400m", {"seq_len": 2048, "global_batch": 2}))
TRAIN_STEPS = 3
# the two-tower gradients through the kernels against the plain bag under autograd (whose card
# backward adds with atomics): of the sum of the added terms' magnitudes
BAG_GRAD_RTOL, BAG_GRAD_ATOL = 1e-5, 1e-6
LM_HOST_LOSS_RTOL = 1e-4  # stablelm cut to 2 layers, float32, card against host
BF16_ULP = 2.0 ** -7  # a bfloat16-rounded gradient element may land one ulp apart
TRAIN_TOL = {"lm": ((2e-3, 3e-2)), "recsys": (1e-5, 1e-5)}  # tests/test_torch_train_steps.py
SUP_STEPS, SUP_CKPT_EVERY, SUP_FAIL_AT = 30, 10, 15
DP_STEPS, DP_SHARDS, DP_TOPK_FRAC = 40, 4, 0.5  # tests/multidevice/check_compressed_dp.py


def bag_grad_scale(ids, weights, g, num_rows, combine):
    """Per element of the table's gradient, the sum of |w g'| over the
    terms added into it: the scale on which a reordered float32 sum errs."""
    from repro_torch.kernels.embedding_bag import embedding_bag_backward_plain

    return embedding_bag_backward_plain(ids, g.abs(), num_rows,
                                        None if weights is None else weights.abs(), combine)


def assert_bag_grad(got, want, scale, what: str, atol: float) -> float:
    """|got - want| <= atol + rtol * (scale + |want|), row slices at a time
    (a full-width gradient is 10 GB); returns the largest difference."""
    worst = 0.0
    for r in range(0, want.shape[0], 1 << 20):
        d = (got[r:r + (1 << 20)] - want[r:r + (1 << 20)]).abs()
        lim = atol + BAG_GRAD_RTOL * (scale[r:r + (1 << 20)] + want[r:r + (1 << 20)].abs())
        if bool((d > lim).any()):
            raise AssertionError(f"{what}: {int((d > lim).sum())} gradient elements off the "
                                 f"plain version (max abs diff {float(d.max())})")
        worst = max(worst, float(d.max()))
    return worst


def assert_equal_host(got, want, what: str) -> None:
    """``got`` (on the card) equal to ``want`` (on the host) to the bit,
    row slices at a time (a full-width gradient is 10 GB)."""
    for r in range(0, want.shape[0], 1 << 20):
        g, w = got[r:r + (1 << 20)].cpu(), want[r:r + (1 << 20)]
        if not torch.equal(g, w):
            d = (g - w).abs()
            raise AssertionError(f"{what}: {int((g != w).sum())} elements differ from the host's "
                                 f"plain version (max abs diff {float(d.max())})")


def bag_backward_replays(dev) -> int:
    """The backward kernel against its plain version on the host, to the
    bit, over the forward's float32 replay families (their grad_out drawn
    per case, a misaligned copy for the shifted ones) and bag sets whose
    every id is the same row (the longest segment)."""
    from repro_torch.kernels.embedding_bag import embedding_bag_backward, embedding_bag_backward_plain

    cases = [c for c in bag_replays() if c[4] == torch.float32]
    rng = np.random.default_rng(90)
    one_row = np.zeros((4096, 50), np.int32)
    cases += [(f"every id row 0 {combine} {wt}", one_row, np.zeros((1, 256), np.float32),
               rng.normal(size=one_row.shape).astype(np.float32) if wt == "weighted" else None,
               torch.float32, combine, False)
              for combine in ("sum", "mean") for wt in ("weighted", "unweighted")]
    for i, (name, ids, table, w, _, combine, shifted) in enumerate(cases):
        tids = torch.from_numpy(ids).to(dev)
        tw = None if w is None else torch.from_numpy(w).to(dev)
        g_host = torch.from_numpy(np.random.default_rng(i).normal(
            size=(ids.shape[0], table.shape[1])).astype(np.float32))
        g = g_host.to(dev)
        if shifted:
            g = misaligned(g)
        got = embedding_bag_backward(tids, g, table.shape[0], tw, combine)
        want = embedding_bag_backward_plain(torch.from_numpy(ids), g_host, table.shape[0],
                                            None if w is None else torch.from_numpy(w), combine)
        assert_equal_host(got, want, f"bag backward {name}")
    return len(cases)


def bag_backward_record(ids, table) -> dict:
    """The backward kernel at two-tower's train shape with a unit-scale
    grad_out, equal to its plain version on the host to the bit; then
    kernel (from a prebuilt plan), the plan (the stable sort and the
    offsets' search), wrapper, the plain version on the card and the
    backward of F.embedding_bag(mode='sum') timed, against the bound:
    the (V, D) gradient written once, g and the ids read once."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import embedding_bag_backward, embedding_bag_backward_plain
    from repro_torch.kernels.embedding_bag.ops import launch_embedding_bag_backward
    from repro_torch.kernels.segment_sum import segment_plan

    (B, S), (V, D) = ids.shape, table.shape
    g_host = torch.from_numpy(np.random.default_rng(91).normal(size=(B, D)).astype(np.float32))
    g = g_host.to(ids.device)
    valid = (ids >= 0) & (ids < V)
    n_valid, rows = int(valid.sum()), int(torch.unique(ids[valid]).numel())
    del valid
    got = embedding_bag_backward(ids, g, V)
    want = embedding_bag_backward_plain(ids.cpu(), g_host, V)
    assert_equal_host(got, want, "bag backward at the train shape")
    del want
    lib_table = table.detach().requires_grad_()
    lib_out = F.embedding_bag(ids.long(), lib_table, mode="sum")
    lib_grad = torch.autograd.grad(lib_out, lib_table, g, retain_graph=True)[0]
    lib_diff = float((lib_grad - got).abs().max())
    del lib_grad, got
    torch.cuda.empty_cache()
    plan = segment_plan(ids.reshape(-1), V)
    buf = torch.empty((V, D), dtype=torch.float32, device=ids.device)
    rec = {"B": B, "S": S, "V": V, "D": D, "valid_ids": n_valid, "distinct_rows": rows,
           "max_abs_err": 0.0,
           "ms": device_ms(lambda: launch_embedding_bag_backward(plan, None, g, buf, S), runs=9),
           "plan_ms": device_ms(lambda: segment_plan(ids.reshape(-1), V), runs=9),
           "wrapper_ms": call_ms(lambda: embedding_bag_backward(ids, g, V), runs=5),
           "plain_ms": device_ms(lambda: embedding_bag_backward_plain(ids, g, V), runs=5),
           "library_ms": device_ms(lambda: torch.autograd.grad(lib_out, lib_table, g,
                                                               retain_graph=True), runs=5),
           "library": "backward of F.embedding_bag(mode='sum'), dense",
           "library_max_abs_diff": lib_diff,
           **window_bound(B * D * 4 + B * S * 4, V * D * 4, 2 * n_valid * D)}
    del buf, lib_out, plan
    torch.cuda.empty_cache()
    return rec


def lookup_backward_record(item, V: int, D: int) -> dict:
    """Row 6 at two-tower's item lookup's backward: the segment sum of B
    (B, D) gradient rows by the item ids into V rows (:func:`segment_sum_record`),
    and the parent's whole backward of the lookup beside it: a zeroed
    (V, D) buffer, then ``index_put_(..., accumulate=True)``."""
    rec = segment_sum_record(item.to(torch.int32), V, D, seed=92, sm_hz=sm_clock_hz())
    data = torch.randn((item.shape[0], D), device=item.device)
    idx = item.long()
    rec["zeros_index_put_ms"] = device_ms(lambda: torch.zeros(
        (V, D), device=item.device).index_put_((idx,), data, accumulate=True), runs=9)
    del data
    torch.cuda.empty_cache()
    return rec


def _twotower_grads(cfg, params, batch, bag):
    """(loss, grads by leaf name, the bag's ids and output gradient) of
    twotower_loss with its user tower's bag-sum done by ``bag``."""
    from repro_torch.models import recsys, tree_leaves, tree_unflatten
    from repro_torch.train.checkpoint import _flatten_with_names

    names = [name for name, _ in _flatten_with_names(params)]
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    seen = {}

    def recording(table, ids, weights=None):
        seen["ids"] = ids
        seen["out"] = bag(table, ids, weights)
        return seen["out"]

    original = recsys.embedding_bag_sum
    recsys.embedding_bag_sum = recording
    try:
        loss = recsys.twotower_loss(cfg, tree_unflatten(params, leaves), batch)
    finally:
        recsys.embedding_bag_sum = original
    grads = torch.autograd.grad(loss, leaves + [seen["out"]])
    return loss.detach(), dict(zip(names, grads[:-1])), seen["ids"], grads[-1]


def differing_leaves(a: dict, b: dict) -> dict:
    """Leaf name -> number of elements that differ, for the leaves of two
    gradient sets that are not equal to the bit."""
    return {n: int((a[n] != b[n]).sum()) for n in a if not torch.equal(a[n], b[n])}


def twotower_train(dev, mesh) -> dict:
    """two-tower-retrieval's train_batch at full width, cut to TT_TRAIN_B:
    one step's gradients through both bag kernels twice (every leaf equal
    to the bit), then against the same step through embedding_bag_plain
    under autograd; the bag's backward at this shape, and the segment sum
    at the item lookup's backward (B ids, C 256 into 10M rows); then
    TRAIN_STEPS built steps on one batch with every launch count at 0,
    and the same steps again from a state materialized anew from the seed
    (losses and grad norms equal)."""
    from repro_torch.configs.recsys_archs import TWO_TOWER
    from repro_torch.kernels.embedding_bag import embedding_bag_plain
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models.embedding import embedding_bag_sum
    from repro_torch.train import init_opt_state

    arch = cut_arch(TWO_TOWER, train_batch=("train", {"batch": TT_TRAIN_B}))
    cfg = arch.model_cfg
    built = build_step(arch, "train_batch", mesh)
    t0 = time.perf_counter()
    params, opt, batch = materialize_inputs(arch, "train_batch", built, seed=MODEL_SEED)
    del opt  # made again after the gradient checks, which need the room
    setup_s = time.perf_counter() - t0

    loss_k, grads_k, ids, g_hist = _twotower_grads(cfg, params, batch, embedding_bag_sum)
    loss_k2, grads_k2, _, g_hist2 = _twotower_grads(cfg, params, batch, embedding_bag_sum)
    twice = differing_leaves(grads_k, grads_k2)
    if twice or not torch.equal(loss_k, loss_k2) or not torch.equal(g_hist, g_hist2):
        raise AssertionError(f"two-tower train: two calls on one state and batch differ: loss "
                             f"{float(loss_k)} / {float(loss_k2)}, leaves {twice}")
    del grads_k2, g_hist2
    torch.cuda.empty_cache()
    loss_p, grads_p, _, g_hist_p = _twotower_grads(
        cfg, params, batch, lambda t, i, w=None: embedding_bag_plain(i, t, w, "sum"))
    if not torch.equal(loss_k, loss_p):
        raise AssertionError(f"two-tower train: loss {float(loss_k)} through the kernels, "
                             f"{float(loss_p)} through the plain bag")
    if not torch.equal(g_hist, g_hist_p):
        raise AssertionError("two-tower train: the bag's output gradients differ")
    del g_hist_p
    worst, bitwise = {}, []
    V = cfg.n_items
    for name in grads_k:
        gk, gp = grads_k[name], grads_p[name]
        atol = BAG_GRAD_ATOL * float(gp.abs().max())  # dL/dlogits is ~1/B: atol on the leaf's scale
        if name == "item_emb":
            del grads_p[name]
            scale = bag_grad_scale(ids, None, g_hist, V, "sum")
            worst[name] = assert_bag_grad(gk, gp, scale, "two-tower item_emb gradient", atol)
            del scale
        else:
            worst[name] = assert_bag_grad(gk, gp, torch.zeros_like(gp),
                                          f"two-tower {name} gradient", atol)
        if torch.equal(gk, gp):
            bitwise.append(name)
        del gp
    del grads_k, grads_p, g_hist
    torch.cuda.empty_cache()
    bag = bag_backward_record(ids, params["item_emb"])
    torch.cuda.empty_cache()
    lookup = lookup_backward_record(batch["item"], cfg.n_items, cfg.embed_dim)

    torch.cuda.empty_cache()  # the check's blocks, of other sizes, would fragment the steps'
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, norms, step_ms = [], [], []
    for _ in range(TRAIN_STEPS):
        (params, opt, m), ms = timed(lambda: built.fn(params, opt, batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_ms.append(ms)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in (("embedding_bag.embedding_bag", TRAIN_STEPS),
                    ("embedding_bag.embedding_bag_backward", TRAIN_STEPS),
                    ("segment_sum.segment_sum", 2 * TRAIN_STEPS)):  # the item and cate lookups
        if launches[name] != n:
            raise AssertionError(f"two-tower train: {launches[name]} launches of {name} in "
                                 f"{TRAIN_STEPS} steps, want {n}")
    if losses[0] != float(loss_k):
        raise AssertionError("two-tower train: the first step's loss differs from the gradient check's")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"two-tower train: losses {losses} not finite and falling")
    del params, opt, batch, ids
    torch.cuda.empty_cache()
    params, opt, batch = materialize_inputs(arch, "train_batch", built, seed=MODEL_SEED)
    again = []
    for _ in range(TRAIN_STEPS):
        params, opt, m = built.fn(params, opt, batch)
        again.append((float(m["loss"]), float(m["grad_norm"])))
    if again != list(zip(losses, norms)):
        raise AssertionError(f"two-tower train: a replay from the seeded state gives {again}, the "
                             f"first run {list(zip(losses, norms))}")
    del params, opt, batch
    torch.cuda.empty_cache()
    return {"B": TT_TRAIN_B, "setup_s": setup_s, "losses": losses, "grad_norms": norms,
            "step_ms": step_ms, "peak_bytes": peak, "launches": launches,
            "grad_max_abs_diff": worst, "bitwise_equal_leaves": bitwise, "loss_bitwise": True,
            "twice_equal": True, "replay_equal": True, "bag_backward": bag,
            "lookup_backward": lookup}


def grads_close_bf16(got, want, what: str) -> dict:
    """Card against host, leaf by leaf: each gradient element is the float32
    of a bfloat16 rounding (the bf16 gather), so two devices' elements may
    land one bfloat16 ulp apart: |d| <= 2^-7 |want| + 1e-5 max|want|."""
    out = {}
    for name in sorted(want):
        g, w = got[name].cpu(), want[name]
        d = (g - w).abs()
        lim = BF16_ULP * w.abs() + 1e-5 * float(w.abs().max())
        if bool((d > lim).any()):
            raise AssertionError(f"{what} {name}: {int((d > lim).sum())} elements off "
                                 f"(max abs diff {float(d.max())})")
        out[name] = {"max_abs_diff": float(d.max()), "differing_share": float((d > 0).double().mean())}
    return out


def lm_grads_twice(arch, dims: dict, mesh) -> dict:
    """Two calls of the built train step's gradient function
    (``lm_grads_microbatched`` with the step's n_micro and bf16 gather) from
    one state and one batch of Zipf(LM_ZIPF_A) tokens, as text repeats its
    frequent tokens: the elements that differ, per leaf (every leaf listed),
    and whether the losses are equal."""
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import transformer
    from repro_torch.train.checkpoint import _flatten_with_names

    arch = cut_arch(arch, train_4k=("train", dims))
    built = build_step(arch, "train_4k", mesh)
    params, opt, _ = materialize_inputs(arch, "train_4k", built, seed=MODEL_SEED)
    del opt
    torch.cuda.empty_cache()
    cfg = arch.model_cfg
    rng = np.random.default_rng(MODEL_SEED)
    B, S = dims["global_batch"], dims["seq_len"]
    tokens, targets = (torch.from_numpy(np.minimum(rng.zipf(LM_ZIPF_A, (B, S)) - 1, cfg.vocab - 1)
                                        .astype(np.int32)).to(built.meta["device"])
                       for _ in range(2))
    runs = []
    for _ in range(2):
        loss, grads = transformer.lm_grads_microbatched(
            cfg, params, tokens, targets, built.meta["n_micro"], mesh, ("data",),
            bf16_gather=built.meta["bf16_gather"])
        runs.append((loss, dict(block_leaves(_flatten_with_names(grads)))))
        del grads
    (loss_a, a), (loss_b, b) = runs
    rec = {"dims": dims, "n_micro": built.meta["n_micro"], "bf16_gather": built.meta["bf16_gather"],
           "top_token_count": int((tokens == 0).sum()), "loss_equal": bool(torch.equal(loss_a, loss_b)),
           "differing": {n: int((a[n] != b[n]).sum()) for n in a}}
    del params, runs, a, b
    torch.cuda.empty_cache()
    return rec


def block_leaves(named) -> list:
    """[(name, tensor)] with each ``Sharded`` leaf's blocks as
    ``name#i``."""
    from repro_torch.parallel import Sharded

    return [(f"{n}#{i}", b) for n, leaf in named
            for i, b in enumerate(leaf.shards if isinstance(leaf, Sharded) else [leaf])]


def stablelm_train(dev, mesh, cpu_mesh) -> dict:
    """stablelm-1.6b train_4k at full width, cut to LM_TRAIN: TRAIN_STEPS
    steps on one batch (two microbatches), then the same config cut to 2
    layers in float32 at B 1 x S 256, one step's loss and gradients on the
    card against the host."""
    from repro_torch.configs.lm_archs import STABLELM_1_6B
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import transformer
    from repro_torch.train.checkpoint import _flatten_with_names

    arch = cut_arch(STABLELM_1_6B, train_4k=("train", LM_TRAIN))
    built = build_step(arch, "train_4k", mesh)
    if built.meta["n_micro"] != 2 or not built.meta["bf16_gather"]:
        raise AssertionError(f"stablelm train: meta {built.meta}, want n_micro 2 with the bf16 gather")
    params, opt, batch = materialize_inputs(arch, "train_4k", built, seed=MODEL_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    for _ in range(TRAIN_STEPS):
        (params, opt, m), ms = timed(lambda: built.fn(params, opt, batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_ms.append(ms)
    peak = torch.cuda.max_memory_allocated()
    if not (all(np.isfinite(losses + norms)) and losses[-1] < losses[0]):
        raise AssertionError(f"stablelm train: losses {losses}, grad norms {norms}")
    del params, opt, batch
    torch.cuda.empty_cache()
    rec = {"dims": LM_TRAIN, "n_micro": built.meta["n_micro"], "losses": losses,
           "grad_norms": norms, "step_ms": step_ms, "peak_bytes": peak,
           "tokens_per_s": LM_TRAIN["global_batch"] * LM_TRAIN["seq_len"] / (statistics.median(step_ms) / 1e3)}

    from dataclasses import replace

    small = replace(arch, model_cfg=replace(arch.model_cfg, n_layers=2, dtype="float32"))
    small = cut_arch(small, train_4k=("train", {"seq_len": 256, "global_batch": 1}))
    built = build_step(small, "train_4k", mesh)
    params, _, batch = materialize_inputs(small, "train_4k", built, seed=MODEL_SEED)
    cfg = small.model_cfg
    args = (built.meta["n_micro"],)
    t = time.perf_counter()
    loss_c, grads_c = transformer.lm_grads_microbatched(
        cfg, params, batch["tokens"], batch["targets"], *args, mesh, ("data",),
        bf16_gather=built.meta["bf16_gather"])
    host_p, host_b = to_device(params, "cpu"), to_device(batch, "cpu")
    loss_h, grads_h = transformer.lm_grads_microbatched(
        cfg, host_p, host_b["tokens"], host_b["targets"], *args, cpu_mesh, ("data",),
        bf16_gather=built.meta["bf16_gather"])
    rel = abs(float(loss_c) / float(loss_h) - 1)
    if rel > LM_HOST_LOSS_RTOL:
        raise AssertionError(f"stablelm 2 layers: loss {float(loss_c)} on the card, "
                             f"{float(loss_h)} on the host")
    rec["card_vs_host"] = {"loss_card": float(loss_c), "loss_host": float(loss_h), "loss_rel": rel,
                           "grads": grads_close_bf16(dict(_flatten_with_names(grads_c)),
                                                     dict(_flatten_with_names(grads_h)),
                                                     "stablelm 2 layers gradient"),
                           "seconds": time.perf_counter() - t}
    del params, grads_c
    torch.cuda.empty_cache()
    return rec


def reduced_train_cells(dev, mesh, cpu_mesh) -> dict:
    """Every reduced train cell, two steps on the card against the port's
    CPU run from the same inputs, within the CPU tests' tolerances."""
    from repro_torch.configs.lm_archs import LM_ARCHS
    from repro_torch.configs.recsys_archs import RECSYS_ARCHS
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import tree_map

    out = {}
    for arch in [a.reduced() for a in LM_ARCHS + RECSYS_ARCHS]:
        shape = "train_4k" if arch.family == "lm" else "train_batch"
        card = build_step(arch, shape, mesh)
        host = build_step(arch, shape, cpu_mesh)
        p, o, b = materialize_inputs(arch, shape, card, seed=MODEL_SEED)
        hp, ho, hb = tree_map(lambda t: t.to("cpu", copy=True), (p, o, b))  # the steps write in place
        got, want = [], []
        for _ in range(2):
            p, o, m = card.fn(p, o, b)
            hp, ho, hm = host.fn(hp, ho, hb)
            got.append((float(m["loss"]), float(m["grad_norm"])))
            want.append((float(hm["loss"]), float(hm["grad_norm"])))
        rtol_loss, rtol_norm = TRAIN_TOL[arch.family]
        got, want = np.array(got), np.array(want)
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=rtol_loss, err_msg=arch.arch_id)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=rtol_norm, err_msg=arch.arch_id)
        out[arch.arch_id] = {"card": got.tolist(), "host": want.tolist()}
    return out


def supervisor_run(dev) -> dict:
    """launch/train.py's train_arch on the card: the default reduced
    stablelm, a failure injected at SUP_FAIL_AT, against an uninterrupted
    run; then the CLI for 5 steps."""
    from repro_torch.launch.train import train_arch

    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(steps=SUP_STEPS, ckpt_every=SUP_CKPT_EVERY, device=dev)
        t = time.perf_counter()
        clean = train_arch("stablelm-1.6b", ckpt_dir=f"{tmp}/clean", **kw)
        failed = train_arch("stablelm-1.6b", ckpt_dir=f"{tmp}/faulty",
                            inject_failures={SUP_FAIL_AT: "node_loss"}, **kw)
        sup_s = time.perf_counter() - t
        if failed.restarts != 1 or clean.restarts != 0:
            raise AssertionError(f"supervisor: restarts {failed.restarts} / {clean.restarts}")
        # the faulty run logs steps 0..SUP_FAIL_AT-1, then replays from the last checkpoint
        resumed = failed.losses[SUP_FAIL_AT:]
        replayed = clean.losses[SUP_FAIL_AT - SUP_FAIL_AT % SUP_CKPT_EVERY:]
        diff = max(abs(a - b) for a, b in zip(resumed, replayed))
        if len(resumed) != len(replayed) or failed.losses[:SUP_FAIL_AT] != clean.losses[:SUP_FAIL_AT]:
            raise AssertionError("supervisor: the runs' steps do not line up")
        if resumed != replayed:  # the reference's supervisor promises exact replay
            raise AssertionError(f"supervisor: losses after the restart differ by up to {diff}")
        t = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps", "5",
                              "--ckpt-dir", f"{tmp}/cli"],
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src")))
        if cli.returncode != 0 or "steps=5 restarts=0" not in cli.stdout:
            raise AssertionError(f"train CLI failed: {cli.stdout}{cli.stderr}")
    return {"restarts": failed.restarts, "resumed_max_abs_diff": diff,
            "resumed_bitwise": resumed == replayed, "losses_clean": clean.losses,
            "seconds": sup_s, "cli_s": time.perf_counter() - t,
            "cli_stdout": cli.stdout.strip().splitlines()[-1]}


def dp_problem():
    """check_compressed_dp.py's linear regression: make_batch(step)."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8, 1)).astype(np.float32)

    def make_batch(step):
        r = np.random.default_rng(step)
        x = r.normal(size=(64, 8)).astype(np.float32)
        y = x @ w_true + 0.01 * r.normal(size=(64, 1)).astype(np.float32)
        return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    return make_batch


def compressed_dp(devices) -> dict:
    """The three schemes over a (DP_SHARDS,) mesh of ``devices``, 40 steps
    each -> losses by scheme, checked against the reference script's
    thresholds."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import (
        AdamWConfig,
        init_error_state,
        init_opt_state,
        make_compressed_dp_train_step,
    )

    mesh = make_mesh((DP_SHARDS,), ("data",), devices=devices)
    make_batch = dp_problem()
    lead = torch.device(devices[0])

    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    out = {}
    for scheme in ("exact", "int8", "topk"):
        step = make_compressed_dp_train_step(loss_fn, AdamWConfig(lr=5e-2, weight_decay=0.0), mesh,
                                             "data", scheme, topk_frac=DP_TOPK_FRAC)
        params = {"w": torch.zeros((8, 1), device=lead)}
        opt, err = init_opt_state(params), [init_error_state(params)] * DP_SHARDS
        losses = []
        for i in range(DP_STEPS):
            params, opt, err, m = step(params, opt, err, to_device(make_batch(i), lead))
            losses.append(float(m["loss"]))
        out[scheme] = losses
    for scheme, losses in out.items():
        if not losses[-1] < 0.05 * losses[0]:
            raise AssertionError(f"compressed DP {scheme}: {losses[0]} -> {losses[-1]}")
    for scheme in ("int8", "topk"):
        if not out[scheme][-1] < out["exact"][-1] * 20 + 1e-3:
            raise AssertionError(f"compressed DP {scheme}: {out[scheme][-1]} against exact "
                                 f"{out['exact'][-1]}")
    return out


def train_phase(dev) -> dict:
    """Training on the card (see the module docstring), each cut listed
    under ``reduced``."""
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"))
    cpu_mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    n_cases = bag_backward_replays(dev)
    log(f"train: kernel embedding_bag.embedding_bag_backward: {n_cases} replay cases equal to "
        "the host's plain version to the bit")
    report = {"replay_cases": n_cases}

    tt = twotower_train(dev, mesh)
    report["twotower"] = tt
    bag = tt["bag_backward"]
    report["max_abs_err"] = bag["max_abs_err"]
    log(f"train: two-tower-retrieval train_batch B={tt['B']} V={bag['V']} D={bag['D']}: main path "
        f"launches {tt['launches']}; losses {tt['losses']}, grad norms {tt['grad_norms']}; ms per "
        f"step {[round(x, 1) for x in tt['step_ms']]}; peak {tt['peak_bytes'] / 1e9:.2f} GB; two "
        f"gradient calls on one state equal to the bit in all {len(tt['grad_max_abs_diff'])} "
        f"leaves, and {TRAIN_STEPS} steps replayed from the seeded state equal to the bit; "
        f"gradients through both kernels equal the plain bag's within tolerance (item_emb max "
        f"abs diff {tt['grad_max_abs_diff']['item_emb']}, bit-equal leaves "
        f"{len(tt['bitwise_equal_leaves'])} of {len(tt['grad_max_abs_diff'])}), loss to the bit")
    log(f"train: bag backward at B={bag['B']} S={bag['S']} into V={bag['V']} x D={bag['D']}: "
        f"kernel {bag['ms']:.4f} ms (every row written), plan {bag['plan_ms']:.4f} ms (stable "
        f"sort and offsets), wrapper {bag['wrapper_ms']:.4f} ms, plain {bag['plain_ms']:.4f} ms, "
        f"library {bag['library_ms']:.4f} ms, bound {bag['bound_ms']:.4f} ms by "
        f"{bag['bound_by']} ({bag['bytes'] / 1e9:.2f} GB: the gradient written once, g and the "
        f"ids read once; {bag['distinct_rows']} distinct rows); unit-scale grad_out equal to the "
        "host's plain version to the bit")
    lk = tt["lookup_backward"]
    log(f"train: kernel segment_sum at the item lookup's backward E={lk['E']} C={lk['C']} into "
        f"N={lk['N']}: kernel {lk['ms']:.4f} ms (every row written), plan {lk['plan_ms']:.4f} ms, "
        f"wrapper {lk['wrapper_ms']:.4f} ms, plain {lk['plain_ms']:.4f} ms, library "
        f"{lk['library_ms']:.4f} ms (index_add_), index_put_ accumulate {lk['index_put_ms']:.4f} "
        f"ms, zeros then index_put_ {lk['zeros_index_put_ms']:.4f} ms (the lookup's backward "
        f"before), bound {lk['bound_ms']:.4f} ms by {lk['bound_by']} "
        f"({lk['bytes'] / 1e9:.2f} GB), chain {lk['chain_bound_ms']:.4f} ms (longest "
        f"{lk['longest']}); equal to the host's plain version to the bit")

    from repro_torch.configs.lm_archs import LM_ARCHS

    report["lm_replays"] = {}
    for arch_id, dims in LM_REPLAYS:
        arch = next(a for a in LM_ARCHS if a.arch_id == arch_id)
        rep = lm_grads_twice(arch, dims, mesh)
        report["lm_replays"][arch_id] = rep
        differ = {n: k for n, k in rep["differing"].items() if k}
        log(f"train: replay {arch_id} B={dims['global_batch']} S={dims['seq_len']} (n_micro "
            f"{rep['n_micro']}, bf16 gather {rep['bf16_gather']}, Zipf({LM_ZIPF_A}) tokens, the "
            f"most frequent {rep['top_token_count']} times): two gradient calls from one state: "
            f"loss {'equal' if rep['loss_equal'] else 'DIFFERS'}; differing elements per leaf "
            f"{rep['differing']}")
        if differ or not rep["loss_equal"]:
            raise AssertionError(f"{arch_id}: two gradient calls from one state differ: {differ}")

    lm = stablelm_train(dev, mesh, cpu_mesh)
    report["stablelm"] = lm
    ch = lm["card_vs_host"]
    log(f"train: stablelm-1.6b train_4k B={LM_TRAIN['global_batch']} S={LM_TRAIN['seq_len']} "
        f"n_micro {lm['n_micro']}: losses {lm['losses']}, grad norms {lm['grad_norms']}; "
        f"ms per step {[round(x, 1) for x in lm['step_ms']]}; peak {lm['peak_bytes'] / 1e9:.2f} GB; "
        f"2 layers float32 B1 S256 card vs host: loss rel diff {ch['loss_rel']:.2e}, gradients "
        f"within one bfloat16 ulp (largest differing share "
        f"{max(v['differing_share'] for v in ch['grads'].values()):.4f})")

    cells = reduced_train_cells(dev, mesh, cpu_mesh)
    report["reduced_cells"] = cells
    log(f"train: {len(cells)} reduced train cells, two steps on the card equal to the CPU run "
        f"within the CPU tests' tolerances")

    sup = supervisor_run(dev)
    report["supervisor"] = sup
    log(f"train: supervisor {SUP_STEPS} steps, checkpoint every {SUP_CKPT_EVERY}, failure at "
        f"{SUP_FAIL_AT}: restarts {sup['restarts']}, resumed losses "
        f"{'equal to the bit' if sup['resumed_bitwise'] else 'max abs diff ' + str(sup['resumed_max_abs_diff'])}"
        f" ({sup['seconds']:.1f} s); CLI: {sup['cli_stdout']}")

    layouts = [[dev] * DP_SHARDS]
    if torch.cuda.device_count() >= DP_SHARDS:
        layouts.append([torch.device("cuda", i) for i in range(DP_SHARDS)])
    report["compressed_dp"] = {}
    for devices in layouts:
        tag = "one card" if len(set(devices)) == 1 else f"{DP_SHARDS} cards"
        dp = compressed_dp(devices)
        report["compressed_dp"][tag] = dp
        log(f"train: compressed DP ({DP_SHARDS},) mesh on {tag}: final loss "
            + ", ".join(f"{k} {v[-1]:.6f}" for k, v in dp.items())
            + " (check_compressed_dp.py's thresholds met)")
    report["reduced"] = [
        {"what": "two-tower-retrieval train_batch", "cut": f"B 65,536 -> {TT_TRAIN_B}",
         "why": "reckoned (not run) ~82.7 GB at B 65,536, over the 76 GB limit: 31.1 GB of "
                "parameters and moments plus three 17.2 GB (B, B) float32 tensors in the loss's "
                "backward (the 20.5 GB of table gradients come after those are freed)"},
        {"what": "stablelm-1.6b train_4k", "cut": "global_batch 256 -> 8 at S 4096",
         "why": "B 256 is 64 microbatches, minutes a step; 8 keeps two microbatches"},
        {"what": "stablelm card against host", "cut": "2 layers, float32, B 1 x S 256",
         "why": "a host step at full width takes too long"},
        {"what": "all models", "cut": "random weights from a seed, one repeated batch",
         "why": "no checkpoints"}]
    report["seconds"] = time.perf_counter() - t_phase
    log(f"train: phase {report['seconds']:.1f} s; reduced: "
        + "; ".join(f"{r['what']}: {r['cut']}" for r in report["reduced"]))
    return report


# -- the GNN: the sorted segment sum, the EGNN's train steps, the sampler -------
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")  # ogb_products reckoned, not run
GNN_STEPS = 2
GNN_RTOL = 1e-4  # card against host, float32: loss and grad norm after GNN_STEPS steps
SEG_WIDTHS = (64, 3, 1)  # the EGNN's message, coordinate and degree sums
ADD_LATENCY_CYCLES = 4  # a dependent float32 add, reckoned (not published by NVIDIA)
ZIPF_A = 1.5  # the power-law src: rng.zipf(ZIPF_A) clipped to N - 1, hubs of many sizes
REDDIT = (232_965, 492)  # gnn_archs.py's minibatch_lg source: nodes, average degree
STREAM_STEPS = 6  # minibatch_lg steps fed by minibatch_stream
OGB_PRODUCTS_GB = 79  # reckoned forward of one layer: the (E, 129) edge input + 3 (E, 64)


def segment_sum_replays(dev) -> int:
    """The segment-sum kernel against its plain version on the host, to the
    bit: ids past either end (dropped), empty segments, zipf ids (long
    segments beside short ones), one segment holding every term, no terms
    at all, widths off the group sizes and past one pass, misaligned data;
    segments of LONG_TERMS - 1, LONG_TERMS and LONG_TERMS + 1 terms (the
    long path's threshold) at C 1, 4, 64 and 257, every segment of a
    block's range long, and one long segment at C 600 on misaligned data."""
    from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain
    from repro_torch.kernels.segment_sum.ops import LONG_TERMS

    rng = np.random.default_rng(95)
    cases = []
    for n, R, C in ((1000, 37, 64), (5000, 1000, 3), (300, 40, 1), (777, 50, 5), (64, 2000, 17),
                    (4000, 300, 256), (1500, 60, 300), (900, 20, 600), (513, 7, 33)):
        cases.append((f"n{n} R{R} C{C}", rng.integers(-2, R + 3, n).astype(np.int32), R, C, False))
    for C in (1, 3, 64, 300, 600):  # zipf ids: long segments beside short ones in a block
        ids = np.minimum(rng.zipf(1.3, 6000) - 2, 202).astype(np.int32)
        cases.append((f"zipf C{C}", ids, 200, C, False))
    cases.append(("one segment C64", np.full(4096, 5, np.int32), 9, 64, False))
    cases.append(("no terms C3", np.zeros(0, np.int32), 11, 3, False))
    cases.append(("misaligned C129", rng.integers(0, 90, 2000).astype(np.int32), 90, 129, True))
    edge = np.repeat(np.arange(3, dtype=np.int32), [LONG_TERMS - 1, LONG_TERMS, LONG_TERMS + 1])
    for C in (1, 4, 64, 257):  # the threshold's edges, shuffled among short segments
        ids = np.concatenate([edge, rng.integers(3, 40, 500).astype(np.int32)])
        cases.append((f"threshold edges C{C}", rng.permutation(ids), 40, C, False))
    for C in (3, 64):  # 300 rows, each longer than the threshold (a short block's range)
        ids = np.repeat(np.arange(300, dtype=np.int32), rng.integers(LONG_TERMS + 1, 200, 300))
        cases.append((f"every row long C{C}", rng.permutation(ids), 300, C, False))
    ids = np.concatenate([np.full(3000, 2, np.int32), rng.integers(0, 30, 400).astype(np.int32)])
    cases.append(("long misaligned C600", rng.permutation(ids), 30, 600, True))
    cases.append(("one segment C1", np.full(20000, 0, np.int32), 3, 1, False))
    for name, ids, R, C, shifted in cases:
        data = torch.from_numpy(rng.normal(size=(ids.shape[0], C)).astype(np.float32))
        on_card = data.to(dev)
        if shifted:
            on_card = misaligned(on_card)
        got = segment_sum(on_card, torch.from_numpy(ids).to(dev), R)
        assert_equal_host(got, segment_sum_plain(data, torch.from_numpy(ids), R),
                          f"segment sum {name}")
    return len(cases)


def parent_segment_sum(parent: Path, data, plan, out) -> None:
    """The segment sum of an earlier ``csrc/segment_sum.cu`` (built from
    ``parent``), whose entry point takes no long-segment list."""
    from repro_torch.kernels.build import launch

    launch("segment_sum", "segment_sum",
           [data, plan.order, plan.offsets, out, plan.num_segments, data.shape[1]], data.device,
           parent)


def segment_sum_record(src: torch.Tensor, n: int, C: int, seed: int, sm_hz: float,
                       parent=None) -> dict:
    """The segment sum of (E, C) float32 rows by ``src`` into ``n`` rows:
    equal to the plain version on the host to the bit, then kernel (from a
    prebuilt plan), the plan, wrapper, the plain version on the card and
    ``index_add_`` and ``index_put_(..., accumulate=True)`` (the
    deterministic library call) into zeroed buffers timed, against the bound (rows,
    index and offsets read once, the output written once) and, beside it,
    the chain bound (the longest segment's terms, one dependent add each at
    ``sm_hz``), which no reordering may shorten. With ``parent``, the
    earlier kernel and this one in turns."""
    from repro_torch.kernels.segment_sum import segment_plan, segment_sum, segment_sum_plain
    from repro_torch.kernels.segment_sum.ops import launch_segment_sum

    E = src.shape[0]
    data_host = torch.from_numpy(np.random.default_rng(seed).normal(size=(E, C)).astype(np.float32))
    data = data_host.to(src.device)
    assert_equal_host(segment_sum(data, src, n), segment_sum_plain(data_host, src.cpu(), n),
                      f"segment sum E{E} C{C}")
    plan = segment_plan(src, n)
    longest = int((plan.offsets[1:] - plan.offsets[:-1]).max())
    out = torch.empty((n, C), dtype=torch.float32, device=src.device)
    lib = torch.zeros((n, C), dtype=torch.float32, device=src.device)
    put = torch.zeros((n, C), dtype=torch.float32, device=src.device)
    idx = src.long()
    rec = {"E": E, "N": n, "C": C, "max_abs_err": 0.0,
           "ms": device_ms(lambda: launch_segment_sum(data, plan, out)),
           "plan_ms": device_ms(lambda: segment_plan(src, n)),
           "wrapper_ms": call_ms(lambda: segment_sum(data, src, n)),
           "plain_ms": device_ms(lambda: segment_sum_plain(data, src, n)),
           "library_ms": device_ms(lambda: lib.index_add_(0, idx, data)),
           "library": "index_add_ (float32 atomics) into a zeroed buffer",
           "index_put_ms": device_ms(lambda: put.index_put_((idx,), data, accumulate=True)),
           "long_segments": int((plan.long_rows >= 0).sum()), "longest": longest,
           **window_bound(E * C * 4 + E * 4 + (n + 1) * 4, n * C * 4, 2 * E * C)}
    rec["chain_bound_ms"] = longest * ADD_LATENCY_CYCLES / sm_hz * 1e3
    if parent is not None:
        rec.update(turns(lambda: parent_segment_sum(parent, data, plan, out),
                         lambda: launch_segment_sum(data, plan, out)))
    return rec


def sm_clock_hz() -> float:
    """The SM clock nvidia-smi reports as the card's highest (the chain
    bound's clock: the least time)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def gnn_steps(dev, mesh, cpu_mesh, shape: str) -> dict:
    """The built EGNN step on one full-width shape: GNN_STEPS steps on the
    card against the same steps on the host (loss and grad norm within
    GNN_RTOL), the counts at 0; then the same steps again on the card from
    the state materialized anew from the seed, equal to the bit."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import tree_leaves, tree_map

    arch = get_arch("egnn")
    card = build_step(arch, shape, mesh)
    host = build_step(arch, shape, cpu_mesh)
    p, o, b = materialize_inputs(arch, shape, card, seed=MODEL_SEED)
    hp, ho, hb = tree_map(lambda t: t.to("cpu", copy=True), (p, o, b))  # the steps write in place
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got, step_ms = [], []
    for _ in range(GNN_STEPS):
        (p, o, m), ms = timed(lambda: card.fn(p, o, b))
        got.append((float(m["loss"]), float(m["grad_norm"])))
        step_ms.append(ms)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    # a layer: 3 segment sums, and the backward of the h[src], h[dst] gathers and (past the
    # first layer, whose x needs no gradient) the x[src], x[dst] ones
    want_launches = GNN_STEPS * (7 * arch.model_cfg.n_layers - 2)
    if launches["segment_sum.segment_sum"] != want_launches:
        raise AssertionError(f"egnn {shape}: {launches['segment_sum.segment_sum']} segment-sum "
                             f"launches in {GNN_STEPS} steps, want {want_launches}")
    first = [t.clone() for t in tree_leaves(p)]
    t = time.perf_counter()
    want = []
    for _ in range(GNN_STEPS):
        hp, ho, hm = host.fn(hp, ho, hb)
        want.append((float(hm["loss"]), float(hm["grad_norm"])))
    host_s = time.perf_counter() - t
    rel = np.abs(np.array(got) / np.array(want) - 1)
    if not (np.isfinite(got).all() and (rel <= GNN_RTOL).all()):
        raise AssertionError(f"egnn {shape}: card {got} against host {want}")
    del p, o, b
    p, o, b = materialize_inputs(arch, shape, card, seed=MODEL_SEED)
    again = []
    for _ in range(GNN_STEPS):
        p, o, m = card.fn(p, o, b)
        again.append((float(m["loss"]), float(m["grad_norm"])))
    same_params = all(torch.equal(x, y) for x, y in zip(first, tree_leaves(p)))
    if again != got or not same_params:
        raise AssertionError(f"egnn {shape}: a replay from the seeded state gives {again}, the "
                             f"first run {got} (parameters equal: {same_params})")
    dims = arch.shapes[shape].dims
    return {"dims": {k: v for k, v in dims.items() if k != "fanout"}, "card": got, "host": want,
            "rel_diff": rel.max().item(), "step_ms": step_ms, "host_s": host_s,
            "peak_bytes": peak, "launches": launches,
            "segment_sums_per_step": launches["segment_sum.segment_sum"] / GNN_STEPS,
            "replay_equal": True}


def gnn_stream(dev, mesh, keep: list) -> tuple[dict, torch.Tensor]:
    """minibatch_lg fed by minibatch_stream over a Reddit-sized
    CSRGraph.random: STREAM_STEPS built steps on fresh batches, losses
    finite and falling; returns the record and one batch's src, and keeps
    the first MD_STREAM_STEPS batches (host arrays) in ``keep``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.graph_data import CSRGraph, minibatch_stream
    from repro_torch.launch.steps import build_step, materialize_inputs

    arch = get_arch("egnn")
    dims = arch.shapes["minibatch_lg"].dims
    t = time.perf_counter()
    graph = CSRGraph.random(REDDIT[0], avg_degree=REDDIT[1], seed=MODEL_SEED)
    rng = np.random.default_rng(MODEL_SEED)
    feats = rng.normal(0, 0.5, (REDDIT[0], dims["d_feat"])).astype(np.float32)
    # a target the model can learn from the features, so the loss falls
    targets = np.tanh(feats[:, :8].sum(axis=1)).astype(np.float32)
    graph_s = time.perf_counter() - t
    stream = minibatch_stream(graph, feats, targets, dims["seeds"], dims["fanout"],
                              dims["n_nodes"], dims["n_edges"], seed=MODEL_SEED)
    built = build_step(arch, "minibatch_lg", mesh)
    params, opt, _ = materialize_inputs(arch, "minibatch_lg", built, seed=MODEL_SEED)
    losses, step_ms, sample_s, edges = [], [], [], []
    src = None
    for _ in range(STREAM_STEPS):
        t = time.perf_counter()
        batch = next(stream)
        sample_s.append(time.perf_counter() - t)
        if len(keep) < MD_STREAM_STEPS:
            keep.append(batch)
        edges.append(int(batch["edge_mask"].sum()))
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
        src = batch["src"] if src is None else src
        (params, opt, m), ms = timed(lambda: built.fn(params, opt, batch))
        losses.append(float(m["loss"]))
        step_ms.append(ms)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"egnn minibatch stream: losses {losses}")
    del params, opt, batch
    return ({"graph_nodes": graph.n_nodes, "graph_edges": int(graph.indptr[-1]),
             "graph_s": graph_s, "losses": losses, "step_ms": step_ms,
             "sample_s_per_batch": statistics.median(sample_s), "real_edges": edges}, src)


def gnn_phase(dev, parent=None, keep=None) -> dict:
    """The EGNN at full width (4 layers x 64) on the card, each cut listed
    under ``reduced``; then the segment-sum kernel at minibatch_lg's widths,
    with a uniform and the sampler's src, and at C 64 with a power-law src
    (with ``parent``: the earlier kernel in turns). The first sampled
    batches go into ``keep``."""
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"))
    cpu_mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    n_cases = segment_sum_replays(dev)
    log(f"gnn: kernel segment_sum.segment_sum: {n_cases} replay cases equal to the host's plain "
        "version to the bit")
    report = {"replay_cases": n_cases, "shapes": {}}
    for shape in GNN_SHAPES:
        rec = gnn_steps(dev, mesh, cpu_mesh, shape)
        report["shapes"][shape] = rec
        log(f"gnn: egnn {shape} {rec['dims']}: card {rec['card']}, host {rec['host']} (max rel "
            f"diff {rec['rel_diff']:.2e}, rtol {GNN_RTOL}); a replay from the seed equal to the "
            f"bit; ms per step {[round(x, 2) for x in rec['step_ms']]}; peak "
            f"{rec['peak_bytes'] / 1e9:.3f} GB; {rec['segment_sums_per_step']:g} segment sums a "
            f"step ({rec['launches']['segment_sum.segment_sum long'] / GNN_STEPS:g} with the "
            f"long-segment kernel); host {rec['host_s']:.1f} s")
    stream, sampler_src = gnn_stream(dev, mesh, [] if keep is None else keep)
    report["stream"] = stream
    log(f"gnn: minibatch_lg from minibatch_stream over CSRGraph.random({stream['graph_nodes']}, "
        f"avg_degree {REDDIT[1]}) = {stream['graph_edges']} edges ({stream['graph_s']:.1f} s): "
        f"losses {[round(x, 5) for x in stream['losses']]}; ms per step "
        f"{[round(x, 2) for x in stream['step_ms']]}; sampler "
        f"{stream['sample_s_per_batch']:.3f} s a batch; real edges {stream['real_edges']}")
    n = sampler_src.shape[0]
    rng = np.random.default_rng(96)
    srcs = {"uniform": (torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(dev),
                        SEG_WIDTHS),
            "sampler": (sampler_src, SEG_WIDTHS),
            "power-law": (torch.from_numpy(np.minimum(rng.zipf(ZIPF_A, n), n - 1).astype(
                np.int32)).to(dev), (64,))}
    sm_hz = sm_clock_hz()
    report["segment_sum"] = {}
    report["sm_clock_hz"] = sm_hz
    for tag, (src, widths) in srcs.items():
        for C in widths:
            rec = segment_sum_record(src, n, C, seed=C, sm_hz=sm_hz, parent=parent)
            report["segment_sum"][f"{tag} C{C}"] = rec
            log(f"gnn: kernel segment_sum {tag} src E={rec['E']} N={rec['N']} C={C}: kernel "
                f"{rec['ms']:.4f} ms, plan {rec['plan_ms']:.4f} ms, wrapper {rec['wrapper_ms']:.4f} "
                f"ms, plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms "
                f"(index_add_), {rec['index_put_ms']:.4f} ms (index_put_ accumulate); bound "
                f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({rec['bytes'] / 1e6:.2f} MB), "
                f"chain bound {rec['chain_bound_ms']:.4f} ms (the longest segment "
                f"{rec['longest']} terms x {ADD_LATENCY_CYCLES} cycles at {sm_hz / 1e6:.0f} MHz); "
                f"{rec['long_segments']} long segments; equal to the host's plain version to the "
                f"bit{in_turns(rec)}")
    report["reduced"] = [
        {"what": "egnn ogb_products", "cut": "reckoned, not run",
         "why": f"one layer's forward holds ~{OGB_PRODUCTS_GB} GB (61,859,328 padded edges: the "
                "(E, 129) float32 edge input 31.9 GB, the edge MLP's hidden, its SiLU and the "
                "message 15.8 GB each), over the 76 GB limit; edge-sharded over four cards its "
                f"backward still keeps ~{OGB_SAVED_GB} GB a card (the multidevice phase)"},
        {"what": "egnn card against host", "cut": f"{GNN_STEPS} steps a shape",
         "why": "a host step at minibatch_lg takes seconds"},
        {"what": "all shapes", "cut": "random weights and graphs from a seed",
         "why": "no checkpoints or datasets"}]
    report["seconds"] = time.perf_counter() - t_phase
    log(f"gnn: phase {report['seconds']:.1f} s; reduced: "
        + "; ".join(f"{r['what']}: {r['cut']}" for r in report["reduced"]))
    return report


# -- the search arch: build_search_step in the three payload modes ------------
SEARCH_RUNS = (("qt1_p99", 64), ("qt1_serve", 64), ("qt1_heavy", 4))  # shape, rows checked on the host
QT1_BULK_GB = 51.5  # qt1_bulk's B 32,768 x K 2 x L 65,536 x 3 int32 inputs


def search_phase(dev) -> dict:
    """proximity-search's QT1 step through build_search_step at full
    width, raw, offsets and delta payloads: warm ms per step, and the
    top-k records of the first rows equal, to the bit, to the same step on
    the host over those rows."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.torch_search import QT1Batch, compress_qt1_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import SEARCH_MODES, build_step, materialize_inputs

    t_phase = time.perf_counter()
    arch = get_arch("proximity-search")
    mesh = make_mesh((1, 1), ("data", "model"))
    cpu_mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    saved = os.environ.get("REPRO_SEARCH_COMPRESSED")
    report = {"shapes": {}}
    try:
        for shape, rows in SEARCH_RUNS:
            os.environ["REPRO_SEARCH_COMPRESSED"] = ""
            t = time.perf_counter()
            raw = materialize_inputs(arch, shape, build_step(arch, shape, cpu_mesh), seed=MODEL_SEED)
            draw_s = time.perf_counter() - t
            recs = {}
            for mode in SEARCH_MODES:
                os.environ["REPRO_SEARCH_COMPRESSED"] = mode
                card = build_step(arch, shape, mesh)
                host = build_step(arch, shape, cpu_mesh)
                args = raw if not mode else tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                                                  compress_qt1_batch(QT1Batch(*(x.numpy() for x in raw), 1),
                                                                     delta_g=mode == "delta"))
                on_card = tuple(a.to(dev) for a in args)
                out, first_ms = timed(lambda: card.fn(*on_card))
                warm = median_ms(lambda: card.fn(*on_card))
                want = host.fn(*(a[:rows] for a in args))
                for name, g, w in zip(("score", "g", "lo", "hi"), out, want):
                    if not torch.equal(g[:rows].cpu(), w):
                        raise AssertionError(f"search {shape} {mode or 'raw'}: {name} of the first "
                                             f"{rows} rows differs from the host's")
                if not torch.isfinite(out[0]).all():
                    raise AssertionError(f"search {shape} {mode or 'raw'}: scores not finite")
                recs[mode or "raw"] = {"first_ms": first_ms, "warm_ms": warm,
                                       "h2d_bytes": sum(a.numel() * a.element_size() for a in args)}
                del on_card, out
            torch.cuda.empty_cache()
            B, K, L = raw[0].shape
            report["shapes"][shape] = {"B": B, "K": K, "L": L, "host_rows": rows,
                                       "draw_s": draw_s, "modes": recs}
            log(f"search: {shape} B={B} K={K} L={L}: warm ms per step "
                + ", ".join(f"{m} {r['warm_ms']:.3f} ({r['h2d_bytes'] / 1e9:.2f} GB in)"
                            for m, r in recs.items())
                + f"; top-k records of the first {rows} rows equal to the host's in every mode; "
                f"inputs drawn in {draw_s:.1f} s")
            del raw
    finally:
        if saved is None:
            os.environ.pop("REPRO_SEARCH_COMPRESSED", None)
        else:
            os.environ["REPRO_SEARCH_COMPRESSED"] = saved
    report["reduced"] = [
        {"what": "search qt1_bulk", "cut": "reckoned, not run",
         "why": f"B 32,768: {QT1_BULK_GB} GB of raw int32 inputs before the membership join's "
                "int64 intermediates, over the 76 GB limit with them"},
        {"what": "search card against host", "cut": ", ".join(f"{s} B -> {r} rows"
                                                             for s, r in SEARCH_RUNS),
         "why": "a host step over a full batch takes minutes"}]
    report["seconds"] = time.perf_counter() - t_phase
    log(f"search: phase {report['seconds']:.1f} s; reduced: "
        + "; ".join(f"{r['what']}: {r['cut']}" for r in report["reduced"]))
    return report


# -- the multi-device model paths: row-sharded tables, expert parallelism, edges --
MD_SHARDS = 4  # the model axis of the phase's (1, 4) meshes
MD_SERVE = ("serve_p99", "serve_bulk", "retrieval_cand")  # two-tower's serving shapes
MD_LOOKUP_ARCHS = ("din", "bert4rec")  # serve_p99 with row-sharded tables
MD_EGNN_SHAPES = ("full_graph_sm", "minibatch_lg")
MD_STREAM_STEPS = 2  # minibatch_lg batches from minibatch_stream through both steps
MD_GRANITE = {"seq_len": 2048, "global_batch": 2}
MD_LM_COS, MD_LM_AGREE = 0.999, 0.9  # granite's logits at tp 4 against tp 1
MD_DP_ELEMS, MD_DP_TOPK = 1 << 20, 1 << 14  # each rank's tensor in the direct all-reduce check
OGB_SAVED_GB = 127  # reckoned: one layer's tensors kept for the backward at 61,859,328 edges
BAG_CHECK_ROWS = 16_384  # bags a slice when a shard's bag is held against its plain version
MIXED_STEPS = 2  # train steps a run on the (1, 2) mesh of the card and the host


def md_meshes(dev) -> list:
    """(name, the (1, 1) mesh, the (1, MD_SHARDS) mesh): the shards on this
    card, and on four cards when four are visible."""
    from repro_torch.launch.mesh import make_mesh

    cases = [("one card", [dev] * MD_SHARDS)]
    if torch.cuda.device_count() >= MD_SHARDS:
        cases.append(("four cards", [torch.device("cuda", i) for i in range(MD_SHARDS)]))
    one = make_mesh((1, 1), ("data", "model"), devices=[dev])
    return [(name, one, make_mesh((1, MD_SHARDS), ("data", "model"), devices=d))
            for name, d in cases]


def md_dp_meshes(dev) -> list:
    """(name, mesh) for two-tower's data-parallel train step at full width:
    a (2, 1) mesh of this card, and a (4, 1) mesh of four cards when four
    are visible."""
    from repro_torch.launch.mesh import make_mesh

    cases = [("one card", make_mesh((2, 1), ("data", "model"), devices=[dev] * 2))]
    if torch.cuda.device_count() >= 4:
        cases.append(("four cards", make_mesh((4, 1), ("data", "model"),
                                              devices=[torch.device("cuda", i) for i in range(4)])))
    return cases


def counted(total: dict, fn):
    """(fn(), the launches it made): every count set to 0 before the call
    and read after it, and added into ``total``."""
    reset_counts()
    out = fn()
    got = read_counts()
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return out, got


def expect_launches(got: dict, want: dict, what: str) -> None:
    for name, n in want.items():
        if got[name] != n:
            raise AssertionError(f"{what}: {got[name]} launches of {name}, want {n}")


def peak_bytes(mesh) -> list:
    return [torch.cuda.max_memory_allocated(d) for d in mesh.unique_devices()]


def reset_peaks(mesh) -> None:
    for d in mesh.unique_devices():
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)


def md_bag_shards(table, ids) -> list:
    """The bag kernel on each table shard at its shard's share of ``ids``
    (-1 for the rows it does not own): the wrapper's output equal to the
    plain version's on the same inputs to the bit (on the card, in slices
    of BAG_CHECK_ROWS bags: the float32 products and adds are the same
    on the card and the host, and a host gather of 13 GB a shard would
    take minutes), then the kernel alone against its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_plain
    from repro_torch.kernels.embedding_bag.ops import launch_embedding_bag
    from repro_torch.models.embedding import local_ids

    (B, S), rows, D = ids.shape, table.rows_per_shard, table.shape[1]
    recs = []
    for r, block in enumerate(table.shards):
        local = local_ids(ids.to(block.device), r, rows).to(torch.int32)
        valid = local >= 0
        n_valid, distinct = int(valid.sum()), int(torch.unique(local[valid]).numel())
        got = embedding_bag(local, block)
        plain_ms = 0.0
        for b0 in range(0, B, BAG_CHECK_ROWS):
            want, ms = timed(lambda: embedding_bag_plain(local[b0:b0 + BAG_CHECK_ROWS], block))
            plain_ms += ms
            assert_bag(got[b0:b0 + BAG_CHECK_ROWS], want, block.dtype,
                       f"shard {r} of {len(table.shards)}, bags {b0}..")
        del got, want
        out = torch.empty((B, D), dtype=block.dtype, device=block.device)
        lib_ids, lib_w = local.clamp(min=0), valid.to(block.dtype)
        recs.append({"shard": r, "rows": rows, "valid_ids": n_valid, "distinct_rows": distinct,
                     "matches_plain": True, "ms": device_ms(lambda: launch_embedding_bag(local, block, None, out,
                                                                  mean=False)),
                     "plain_ms": plain_ms, "plain": f"in slices of {BAG_CHECK_ROWS} bags, summed",
                     "library_ms": device_ms(lambda: F.embedding_bag(
                         lib_ids, block, per_sample_weights=lib_w, mode="sum")),
                     "library": "F.embedding_bag(mode='sum', per_sample_weights 0 on the ids "
                                "the shard does not own)",
                     **window_bound(4 * B * S + distinct * D * 4, B * D * 4, n_valid * D)})
        del lib_ids, lib_w
    return recs


def md_bag_backward_shards(table, ids) -> list:
    """The bag's backward on each table shard, a (V / 4, D) gradient from
    the shard's share of ``ids``: the wrapper's equal to the plain
    version's on the host to the bit, then the kernel alone from a
    prebuilt plan."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import (
        embedding_bag_backward,
        embedding_bag_backward_plain,
    )
    from repro_torch.kernels.embedding_bag.ops import launch_embedding_bag_backward
    from repro_torch.kernels.segment_sum import segment_plan
    from repro_torch.models.embedding import local_ids

    (B, S), rows, D = ids.shape, table.rows_per_shard, table.shape[1]
    g_host = torch.from_numpy(np.random.default_rng(91).normal(size=(B, D)).astype(np.float32))
    recs = []
    for r, block in enumerate(table.shards):
        local = local_ids(ids.to(block.device), r, rows).to(torch.int32)
        n_valid = int((local >= 0).sum())
        g = g_host.to(block.device)
        got = embedding_bag_backward(local, g, rows)
        assert_equal_host(got, embedding_bag_backward_plain(local.cpu(), g_host, rows),
                          f"bag backward, shard {r} of {len(table.shards)}")
        del got
        plan = segment_plan(local.reshape(-1), rows)
        buf = torch.empty((rows, D), dtype=torch.float32, device=block.device)
        ms = device_ms(lambda: launch_embedding_bag_backward(plan, None, g, buf, S), runs=9)
        del buf
        lib_table = block.detach().requires_grad_()
        lib_out = F.embedding_bag(local.clamp(min=0).long(), lib_table,
                                  per_sample_weights=(local >= 0).float(), mode="sum")
        recs.append({"shard": r, "rows": rows, "valid_ids": n_valid, "matches_plain": True,
                     "ms": ms, "long_rows": int((plan.long_rows >= 0).sum()),
                     "plain_ms": device_ms(lambda: embedding_bag_backward_plain(local, g, rows),
                                           runs=5),
                     "library_ms": device_ms(lambda: torch.autograd.grad(
                         lib_out, lib_table, g, retain_graph=True), runs=5),
                     "library": "backward of F.embedding_bag(mode='sum'), dense",
                     **window_bound(B * D * 4 + B * S * 4, rows * D * 4, 2 * n_valid * D)})
        del plan, lib_out, lib_table
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    return recs


def md_twotower_serve(one, mesh, total: dict) -> dict:
    """two-tower-retrieval at serve_p99, serve_bulk and retrieval_cand with
    item_emb and cate_emb row-sharded over the mesh (row views of the
    unsharded step's tables on one card): the user vectors within float32
    rounding of the unsharded tower, the bag launched once per shard, the
    scores within RECSYS_TOL and retrieval's top-k equal where not tied;
    each step timed against the unsharded one; then the bag kernel alone on
    each shard at serve_bulk."""
    from repro_torch.configs.recsys_archs import TWO_TOWER
    from repro_torch.launch.steps import (
        build_step,
        materialize_batch,
        materialize_inputs,
        place_params,
    )
    from repro_torch.models import recsys

    cfg = TWO_TOWER.model_cfg
    b1 = {n: build_step(TWO_TOWER, n, one) for n in MD_SERVE}
    bs = {n: build_step(TWO_TOWER, n, mesh) for n in MD_SERVE}
    params, first = materialize_inputs(TWO_TOWER, MD_SERVE[0], b1[MD_SERVE[0]], seed=MODEL_SEED)
    batches = {MD_SERVE[0]: first}
    for i, n in enumerate(MD_SERVE[1:], 1):
        (batches[n],) = materialize_batch(TWO_TOWER, n, b1[n], seed=MODEL_SEED + i)
    sp = place_params(bs[MD_SERVE[0]], params)
    if "item_emb" not in bs[MD_SERVE[0]].meta["sharded_tables"]:
        raise AssertionError(f"two-tower sharded tables: {bs[MD_SERVE[0]].meta['sharded_tables']}")
    rec = {"sharded_tables": list(bs[MD_SERVE[0]].meta["sharded_tables"]),
           "views": all(s.data_ptr() == params["item_emb"][r * sp["item_emb"].rows_per_shard:]
                        .data_ptr() for r, s in enumerate(sp["item_emb"].shards))}
    for n in MD_SERVE:
        batch = batches[n]
        pspec = (None, None) if n == "retrieval_cand" else None
        u1 = recsys.twotower_user(cfg, params, batch)
        us, got = counted(total, lambda: recsys.twotower_user(cfg, sp, batch, mesh, ("data",),
                                                             bag_pspec=pspec))
        expect_launches(got, {"embedding_bag.embedding_bag": MD_SHARDS}, f"two-tower {n} tower")
        u_diff = float((us - u1.to(us.device)).abs().max())
        torch.testing.assert_close(us, u1.to(us.device), rtol=RECSYS_TOL, atol=RECSYS_TOL)
        out1 = b1[n].fn(params, batch)
        outs, got = counted(total, lambda: bs[n].fn(sp, batch))
        expect_launches(got, {"embedding_bag.embedding_bag": MD_SHARDS}, f"two-tower {n} step")
        r = {"B": int(batch["hist"].shape[0]), "user_max_abs_diff": u_diff,
             "ms": median_ms(lambda: bs[n].fn(sp, batch)),
             "unsharded_ms": median_ms(lambda: b1[n].fn(params, batch))}
        if n == "retrieval_cand":
            r["C"] = int(batch["cand_items"].shape[0])
            r["tied_swaps"] = same_top_k(outs, tuple(t.cpu() for t in out1), f"two-tower {n}")
        else:
            r["score_max_abs_diff"] = float((outs - out1.to(outs.device)).abs().max())
            torch.testing.assert_close(outs, out1.to(outs.device), rtol=RECSYS_TOL, atol=RECSYS_TOL)
        rec[n] = r
        del out1, outs, us, u1
    rec["bag_shards_serve_bulk"] = md_bag_shards(sp["item_emb"], batches["serve_bulk"]["hist"])
    del params, sp, batches
    torch.cuda.empty_cache()
    return rec


def md_twotower_train(mesh, total: dict, unsharded: dict) -> dict:
    """two-tower-retrieval's train_batch (B TT_TRAIN_B) over ``mesh``: with
    its tables row-sharded over a model axis, or data-parallel over a data
    axis (each data shard's rows through its own bag and towers):
    TRAIN_STEPS built steps timed, the bag and its backward launched once
    per (data shard, table shard) a step, losses and grad norms within
    RECSYS_TOL of the train phase's unsharded steps from the same seed,
    peak memory, every replica (a leaf held once per data shard on
    distinct cards) equal to the bit after one more step with
    ``sum_replicas`` synchronised (:func:`synchronised_sum`); the same
    steps again from the state materialized anew, equal to the bit; then,
    where the table is row-sharded, the backward kernel alone on each
    shard."""
    from repro_torch.configs.recsys_archs import TWO_TOWER
    from repro_torch.launch.steps import build_step, materialize_inputs

    arch = cut_arch(TWO_TOWER, train_batch=("train", {"batch": TT_TRAIN_B}))
    built = build_step(arch, "train_batch", mesh)
    shards = mesh.size
    params, opt, batch = materialize_inputs(arch, "train_batch", built, seed=MODEL_SEED)
    reset_peaks(mesh)
    losses, norms, step_ms = [], [], []

    def steps():
        nonlocal params, opt
        for _ in range(TRAIN_STEPS):
            (params, opt, m), ms = timed(lambda: built.fn(params, opt, batch))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            step_ms.append(ms)

    _, got = counted(total, steps)
    peaks = peak_bytes(mesh)
    (params, opt, _), summed = synchronised_sum(built, (params, opt, batch), mesh)
    apart = max(_replica_gap(params), _replica_gap(opt))[1]
    if apart:  # replicas on distinct cards: every one updated with the same bits
        raise AssertionError(f"two-tower sharded train: replicas differ in {apart} elements")
    expect_launches(got, {"embedding_bag.embedding_bag": shards * TRAIN_STEPS,
                          "embedding_bag.embedding_bag_backward": shards * TRAIN_STEPS},
                    "two-tower sharded train")
    want = np.array([unsharded["losses"], unsharded["grad_norms"]])
    rel = np.abs(np.array([losses, norms]) / want - 1)
    if not (np.isfinite(rel).all() and (rel <= RECSYS_TOL).all()):
        raise AssertionError(f"two-tower sharded train: losses {losses}, norms {norms}; "
                             f"unsharded {want.tolist()}")
    del params, opt
    torch.cuda.empty_cache()
    params, opt, batch = materialize_inputs(arch, "train_batch", built, seed=MODEL_SEED)
    again = []
    for _ in range(TRAIN_STEPS):
        params, opt, m = built.fn(params, opt, batch)
        again.append((float(m["loss"]), float(m["grad_norm"])))
    if again != list(zip(losses, norms)):
        raise AssertionError(f"two-tower sharded train: a replay from the seed gives {again}, "
                             f"the first run {list(zip(losses, norms))}")
    del opt
    torch.cuda.empty_cache()
    rec = {"B": TT_TRAIN_B, "mesh": list(mesh.devices.shape), "split": built.meta["split"],
           "losses": losses, "grad_norms": norms, "rel_diff": float(rel.max()),
           "step_ms": step_ms, "unsharded_step_ms": unsharded["step_ms"],
           "peak_bytes": peaks, "unsharded_peak_bytes": unsharded["peak_bytes"],
           "launches": got, "replay_equal": True, "replicas_equal": True, **summed}
    if built.meta["sharded_tables"]:
        rec["bag_backward_shards"] = md_bag_backward_shards(params["item_emb"], batch["hist"])
    del params, batch
    torch.cuda.empty_cache()
    return rec


def synchronised_sum(built, args, mesh) -> tuple:
    """(one more built step's result, what its ``sum_replicas`` did): every
    card of the mesh synchronised before and after ``launch/steps.py``'s
    ``sum_replicas``, its time alone and its copies by kind
    (``row-lists`` for the tables summed over their touched rows)."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.parallel import copy_record

    devices, orig, rec = mesh.unique_devices(), steps_mod.sum_replicas, {}

    def timed_sum(grads, touched=None):
        if rec:  # its own recursion over the tree
            return orig(grads, touched)
        for d in devices:
            torch.cuda.synchronize(d)
        t = time.perf_counter()
        rec["sum_replicas_ms"] = None
        with copy_record() as copies:
            out = orig(grads, touched)
        for d in devices:
            torch.cuda.synchronize(d)
        rec.update(sum_replicas_ms=(time.perf_counter() - t) * 1e3,
                   sum_replicas_copies=dict(copies.bytes))
        return out

    steps_mod.sum_replicas = timed_sum
    try:
        out = built.fn(*args)
    finally:
        steps_mod.sum_replicas = orig
    return out, rec


TOUCHED_RUNS = 5  # timed calls of each sum at the one-card sum line


def md_touched_sum(dev) -> dict:
    """``parallel.all_reduce`` and ``parallel.all_reduce_rows`` side by side
    on two dense 10,000,000 x 256 float32 table gradients on this card,
    each the segment sum of seeded rows over one (2, 1) data shard's item
    lookups (its 16,384 rows' 50 history ids and item) of two-tower's B
    32,768 batch, drawn as the built step draws it: the two sums equal to
    the bit; each timed alone TOUCHED_RUNS times (CUDA events, the
    gradients made anew before each); the bytes a device each copies by
    kind, the list bound and the live rows. The replicas share the card:
    this times the adds and the plan, not the links."""
    from repro_torch.configs.recsys_archs import TWO_TOWER
    from repro_torch.kernels.segment_sum import segment_plan, segment_sum
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, materialize_batch
    from repro_torch.parallel import all_reduce, all_reduce_rows, copy_record, rows_move_less

    arch = cut_arch(TWO_TOWER, train_batch=("train", {"batch": TT_TRAIN_B}))
    V, D, n = arch.model_cfg.n_items, arch.model_cfg.embed_dim, 2
    built = build_step(arch, "train_batch", make_mesh((1, 1), ("data", "model"), devices=[dev]))
    batch = materialize_batch(arch, "train_batch", built, seed=MODEL_SEED)[0]
    ids = [torch.cat([h.reshape(-1), i]).to(torch.int32) for h, i in
           zip(batch["hist"].chunk(n), batch["item"].chunk(n))]
    del batch
    gen = torch.Generator(device=dev).manual_seed(MODEL_SEED)
    rows = [torch.randn((x.numel(), D), device=dev, generator=gen) for x in ids]
    plans = [segment_plan(x, V) for x in ids]

    def grads():
        return [segment_sum(r, p) for r, p in zip(rows, plans)]

    def one(fn):
        w = grads()
        with copy_record() as rec:
            fn(w)
        return w, {k: v / n for k, v in rec.bytes.items()}

    w, dense_bytes = one(all_reduce)
    want = w[0]
    del w
    w, rows_bytes = one(lambda x: all_reduce_rows(x, ids))
    apart = sum(int((x.view(torch.int32) != want.view(torch.int32)).sum()) for x in w)
    del w, want
    if apart:
        raise AssertionError(f"touched-row sum: {apart} elements differ from all_reduce's")

    def timed_ms(fn) -> list:
        out = []
        for _ in range(TOUCHED_RUNS):
            w = grads()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(w)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
            del w
        return out

    rec = {"V": V, "D": D, "replicas": n, "rows_a_shard": TT_TRAIN_B // n,
           "bound": [x.numel() for x in ids],
           "live_rows": [int(torch.unique(x).numel()) for x in ids],
           "equal_to_the_bit": True,
           "rows_move_less": rows_move_less(n, max(x.numel() for x in ids), (V, D)),
           "all_reduce_ms": timed_ms(all_reduce),
           "all_reduce_rows_ms": timed_ms(lambda x: all_reduce_rows(x, ids)),
           "all_reduce_bytes_a_device": dense_bytes, "all_reduce_rows_bytes_a_device": rows_bytes}
    del rows, plans, ids
    torch.cuda.empty_cache()
    return rec


def md_lookups(one, mesh, total: dict) -> dict:
    """din and bert4rec at serve_p99 with their tables row-sharded: the
    built step's output equal to the unsharded step's to the bit (each
    sharded lookup is its one owner's row); both timed."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_step, materialize_inputs, place_params

    rec = {}
    for arch_id in MD_LOOKUP_ARCHS:
        arch = get_arch(arch_id)
        b1, bs = build_step(arch, "serve_p99", one), build_step(arch, "serve_p99", mesh)
        params, batch = materialize_inputs(arch, "serve_p99", b1, seed=MODEL_SEED)
        sp = place_params(bs, params)
        out1 = b1.fn(params, batch)
        outs, _ = counted(total, lambda: bs.fn(sp, batch))
        if not torch.equal(outs, out1.to(outs.device)):
            raise AssertionError(f"{arch_id} serve_p99: the sharded lookups' output differs "
                                 f"(max {float((outs - out1.to(outs.device)).abs().max())})")
        rec[arch_id] = {"sharded_tables": list(bs.meta["sharded_tables"]), "bitwise": True,
                        "ms": median_ms(lambda: bs.fn(sp, batch)),
                        "unsharded_ms": median_ms(lambda: b1.fn(params, batch))}
        del params, sp, batch, out1, outs
        torch.cuda.empty_cache()
    return rec


def md_egnn(one, mesh, total: dict, gnn: dict, stream_batches: list) -> dict:
    """The EGNN with its edges sharded over the mesh: GNN_STEPS built steps
    at full_graph_sm and minibatch_lg (synthetic), within GNN_RTOL of the
    gnn phase's unsharded steps from the same seed, MD_SHARDS times their
    segment-sum launches, a replay from the seed equal to the bit; then
    minibatch_lg on the sampler's batches through the sharded and the
    unsharded step; then the segment-sum kernel alone on each edge shard
    of a sampled batch at C 64, equal to the host's plain version to the
    bit (the sampler's padding edges, all on node 0, make one long
    segment in the last shard)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.segment_sum import segment_plan, segment_sum, segment_sum_plain
    from repro_torch.kernels.segment_sum.ops import launch_segment_sum
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import tree_leaves

    arch = get_arch("egnn")
    rec = {}
    for shape in MD_EGNN_SHAPES:
        built = build_step(arch, shape, mesh)
        p, o, b = materialize_inputs(arch, shape, built, seed=MODEL_SEED)
        reset_peaks(mesh)
        got, step_ms = [], []

        def steps():
            nonlocal p, o
            for _ in range(GNN_STEPS):
                (p, o, m), ms = timed(lambda: built.fn(p, o, b))
                got.append((float(m["loss"]), float(m["grad_norm"])))
                step_ms.append(ms)

        _, launches = counted(total, steps)
        unsharded = gnn["shapes"][shape]
        expect_launches(launches, {"segment_sum.segment_sum":
                                   MD_SHARDS * unsharded["launches"]["segment_sum.segment_sum"]},
                        f"egnn {shape} edge-sharded")
        rel = np.abs(np.array(got) / np.array(unsharded["card"]) - 1)
        if not (np.isfinite(rel).all() and (rel <= GNN_RTOL).all()):
            raise AssertionError(f"egnn {shape} edge-sharded: {got} against {unsharded['card']}")
        first = [t.clone() for t in tree_leaves(p)]
        del p, o, b
        p, o, b = materialize_inputs(arch, shape, built, seed=MODEL_SEED)
        again = []
        for _ in range(GNN_STEPS):
            p, o, m = built.fn(p, o, b)
            again.append((float(m["loss"]), float(m["grad_norm"])))
        if again != got or not all(torch.equal(x, y) for x, y in zip(first, tree_leaves(p))):
            raise AssertionError(f"egnn {shape} edge-sharded: a replay gives {again}, first {got}")
        rec[shape] = {"steps": got, "unsharded": unsharded["card"], "rel_diff": float(rel.max()),
                      "step_ms": step_ms, "unsharded_step_ms": unsharded["step_ms"],
                      "peak_bytes": peak_bytes(mesh), "unsharded_peak_bytes":
                      unsharded["peak_bytes"], "launches": launches, "replay_equal": True}
        del p, o, b, first
        torch.cuda.empty_cache()
    b1, bs = build_step(arch, "minibatch_lg", one), build_step(arch, "minibatch_lg", mesh)
    p1, o1, _ = materialize_inputs(arch, "minibatch_lg", b1, seed=MODEL_SEED)
    ps, os_, _ = materialize_inputs(arch, "minibatch_lg", bs, seed=MODEL_SEED)
    stream = {"losses": [], "unsharded_losses": [], "ms": [], "unsharded_ms": [], "launches": {}}
    for host in stream_batches:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.lead)
                 for k, v in host.items()}
        (p1, o1, m1), ms1 = timed(lambda: b1.fn(p1, o1, batch))
        ((ps, os_, ms_), mss), got = counted(total, lambda: timed(lambda: bs.fn(ps, os_, batch)))
        for k, v in got.items():
            stream["launches"][k] = stream["launches"].get(k, 0) + v
        stream["losses"].append(float(ms_["loss"]))
        stream["unsharded_losses"].append(float(m1["loss"]))
        stream["ms"].append(mss)
        stream["unsharded_ms"].append(ms1)
    rel = np.abs(np.array(stream["losses"]) / np.array(stream["unsharded_losses"]) - 1)
    if not (np.isfinite(rel).all() and (rel <= GNN_RTOL).all()):
        raise AssertionError(f"egnn sampled minibatch_lg edge-sharded: {stream['losses']} against "
                             f"{stream['unsharded_losses']}")
    stream["rel_diff"] = float(rel.max())
    rec["stream"] = stream
    del p1, o1, ps, os_
    src = torch.from_numpy(np.ascontiguousarray(stream_batches[0]["src"]))
    n = int(stream_batches[0]["feats"].shape[0])
    sm_hz = gnn.get("sm_clock_hz") or sm_clock_hz()
    shards = []
    for r, (s_r, dev) in enumerate(zip(src.chunk(MD_SHARDS), list(mesh.grid()[0]))):
        s_host, s_r = s_r, s_r.to(dev)
        E = s_r.shape[0]
        data_host = torch.from_numpy(np.random.default_rng(r).normal(size=(E, 64)).astype(np.float32))
        data = data_host.to(dev)
        assert_equal_host(segment_sum(data, s_r, n), segment_sum_plain(data_host, s_host, n),
                          f"segment sum, edge shard {r} of {MD_SHARDS}")
        plan = segment_plan(s_r, n)
        out = torch.empty((n, 64), dtype=torch.float32, device=dev)
        lib, idx = torch.zeros((n, 64), dtype=torch.float32, device=dev), s_r.long()
        put = torch.zeros((n, 64), dtype=torch.float32, device=dev)
        longest = int((plan.offsets[1:] - plan.offsets[:-1]).max())
        shards.append({"shard": r, "E": E, "N": n, "C": 64, "longest": longest, "matches_plain": True,
                       "chain_bound_ms": longest * ADD_LATENCY_CYCLES / sm_hz * 1e3,
                       "long_segments": int((plan.long_rows >= 0).sum()),
                       "ms": device_ms(lambda: launch_segment_sum(data, plan, out)),
                       "plain_ms": device_ms(lambda: segment_sum_plain(data, s_r, n)),
                       "library_ms": device_ms(lambda: lib.index_add_(0, idx, data)),
                       "library": "index_add_ (float32 atomics) into a zeroed buffer",
                       "index_put_ms": device_ms(
                           lambda: put.index_put_((idx,), data, accumulate=True)),
                       **window_bound(E * 64 * 4 + E * 4 + (n + 1) * 4, n * 64 * 4, 2 * E * 64)})
    if not any(r["long_segments"] for r in shards):
        raise AssertionError("egnn edge shards: no shard of the sampled batch holds a long segment")
    rec["segment_sum_shards"] = shards
    torch.cuda.empty_cache()
    return rec


def md_granite(one, mesh) -> dict:
    """granite-moe-1b-a400m's prefill at MD_GRANITE with its 32 experts
    over the mesh's 4 model ranks on one card: the logits of every
    position against tp 1 (cosine and argmax agreement), both prefill
    steps timed; then two gradient calls from one state, every leaf equal
    to the bit."""
    from repro_torch.configs.lm_archs import GRANITE_MOE
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import transformer

    cut = cut_arch(GRANITE_MOE, prefill_32k=("prefill", MD_GRANITE))
    cfg = GRANITE_MOE.model_cfg
    b1, bs = build_step(cut, "prefill_32k", one), build_step(cut, "prefill_32k", mesh)
    params, tokens = materialize_inputs(cut, "prefill_32k", b1, seed=MODEL_SEED)
    l1 = transformer.forward(cfg, params, tokens, one, ("data",))[0]
    ls = transformer.forward(cfg, params, tokens, mesh, ("data",))[0]
    cos = cosine(ls, l1)
    agree = float((ls.argmax(-1) == l1.argmax(-1)).double().mean())
    if not (cos >= MD_LM_COS and agree >= MD_LM_AGREE):
        raise AssertionError(f"granite tp {MD_SHARDS}: cosine {cos}, argmax agreement {agree}")
    rec = {"B": MD_GRANITE["global_batch"], "S": MD_GRANITE["seq_len"],
           "experts": cfg.moe.n_experts, "ranks": MD_SHARDS, "cosine": cos,
           "argmax_agreement": agree,
           "prefill_ms": median_ms(lambda: bs.fn(params, tokens), n=3),
           "unsharded_prefill_ms": median_ms(lambda: b1.fn(params, tokens), n=3)}
    del params, tokens, l1, ls
    torch.cuda.empty_cache()
    twice = lm_grads_twice(GRANITE_MOE, {"seq_len": MD_GRANITE["seq_len"],
                                         "global_batch": MD_GRANITE["global_batch"]}, mesh)
    if not twice["loss_equal"] or any(twice["differing"].values()):
        raise AssertionError(f"granite tp {MD_SHARDS}: two gradient calls differ: {twice}")
    rec["grads_twice"] = twice
    return rec


def md_compressed(devices) -> dict:
    """The public int8_allreduce_mean and topk_allreduce_mean over
    MD_SHARDS ranks on ``devices`` against the same calls on the host: the
    int8 mean, the top-k mean and every rank's error state equal to the
    bit."""
    from repro_torch.train.grad_compression import int8_allreduce_mean, topk_allreduce_mean

    rng = np.random.default_rng(MODEL_SEED)
    xs = [torch.from_numpy(rng.normal(size=MD_DP_ELEMS).astype(np.float32))
          for _ in range(MD_SHARDS)]
    errs = [torch.from_numpy(rng.normal(0, 0.1, MD_DP_ELEMS).astype(np.float32))
            for _ in range(MD_SHARDS)]
    lead = torch.device(devices[0])
    on = lambda ts: [t.to(d) for t, d in zip(ts, devices)]  # noqa: E731
    card_i8, host_i8 = int8_allreduce_mean(on(xs), lead), int8_allreduce_mean(xs, "cpu")
    (card_k, card_e), (host_k, host_e) = (topk_allreduce_mean(on(xs), on(errs), MD_DP_TOPK, lead),
                                          topk_allreduce_mean(xs, errs, MD_DP_TOPK, "cpu"))
    checks = {"int8": torch.equal(card_i8.cpu(), host_i8),
              "topk": torch.equal(card_k.cpu(), host_k),
              "topk_errors": all(torch.equal(a.cpu(), b) for a, b in zip(card_e, host_e))}
    if not all(checks.values()):
        raise AssertionError(f"compressed all-reduce means, card against host: {checks}")
    return {"ranks": MD_SHARDS, "elements": MD_DP_ELEMS, "k": MD_DP_TOPK, **checks,
            "int8_ms": median_ms(lambda: int8_allreduce_mean(on(xs), lead)),
            "topk_ms": median_ms(lambda: topk_allreduce_mean(on(xs), on(errs), MD_DP_TOPK, lead))}


def md_collectives(devices) -> tuple:
    """``replicate``, ``split_rows`` and ``sum_to_lead`` of one card tensor
    over ``devices``, and its gradient through all three."""
    from repro_torch.parallel import replicate, split_rows, sum_to_lead

    rng = np.random.default_rng(MODEL_SEED)
    lead = torch.device(devices[0])
    x = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)).to(lead).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(4, 4)).astype(np.float32)).to(lead)
    parts = [p[:4] * (i + 2) * b for i, (p, b) in enumerate(zip(replicate(x, devices),
                                                                 split_rows(x, devices)))]
    y = sum_to_lead(parts, lead)
    y.backward(g)
    return y.detach(), x.grad


def md_mixed(dev, total: dict) -> dict:
    """The collectives' copies between distinct devices, forward and
    backward: ``replicate``, ``split_rows`` and ``sum_to_lead`` over this
    card and the host equal to the same over the card twice, to the bit;
    then the reduced two-tower and EGNN train steps on a (1, 2) mesh of
    the card and the host (the host's shard runs each kernel's plain
    version): MIXED_STEPS steps from the seed, twice, with equal losses,
    grad norms and every leaf to the bit; within tolerance of the same
    steps on a (1, 1) mesh of the card; the card's shard launching each
    kernel as often as the (1, 1) step does."""
    from repro_torch.configs.recsys_archs import TWO_TOWER
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import tree_leaves

    one = make_mesh((1, 1), ("data", "model"), devices=[dev])
    mixed = make_mesh((1, 2), ("data", "model"), devices=[dev, torch.device("cpu")])
    rec = {"devices": [str(d) for d in mixed.devices.flat]}
    (y_mixed, g_mixed), (y_card, g_card) = (md_collectives([dev, torch.device("cpu")]),
                                            md_collectives([dev, dev]))
    if not (torch.equal(y_mixed, y_card) and torch.equal(g_mixed, g_card)):
        raise AssertionError("the collectives over the card and the host differ from the same "
                             "over the card")
    rec["collectives_equal"] = True
    cases = (("two-tower", TWO_TOWER.reduced(), "train_batch", RECSYS_TOL,
              ("embedding_bag.embedding_bag", "embedding_bag.embedding_bag_backward")),
             ("egnn", get_arch("egnn").reduced(), "full_graph_sm", GNN_RTOL,
              ("segment_sum.segment_sum",)))
    for name, arch, shape, tol, kernels in cases:
        def run(mesh):
            built = build_step(arch, shape, mesh)
            p, o, b = materialize_inputs(arch, shape, built, seed=MODEL_SEED)
            metrics = []
            for _ in range(MIXED_STEPS):
                p, o, m = built.fn(p, o, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            leaves = tree_leaves(p)
            return metrics, [t.detach().cpu() for t in leaves], sum(
                t.device.type == "cpu" for t in leaves)

        (want, _, _), one_launches = counted({}, lambda: run(one))
        (got, leaves, on_host), launches = counted(total, lambda: run(mixed))
        (again, leaves_again, _), _ = counted({}, lambda: run(mixed))
        if name == "two-tower" and not on_host:
            raise AssertionError("two-tower (1, 2) mesh of the card and the host: no table shard "
                                 "on the host")
        if again != got or not all(torch.equal(a, b) for a, b in zip(leaves, leaves_again)):
            raise AssertionError(f"{name} on the card and the host: a replay gives {again}, "
                                 f"the first run {got}")
        rel = np.abs(np.array(got) / np.array(want) - 1)
        if not (np.isfinite(rel).all() and (rel <= tol).all()):
            raise AssertionError(f"{name} on the card and the host: {got} against the card's "
                                 f"(1, 1) step {want}")
        expect_launches(launches, {k: one_launches[k] for k in kernels},
                        f"{name} on the card and the host")
        if not all(launches[k] for k in kernels):
            raise AssertionError(f"{name} on the card and the host: launches {launches}")
        rec[name] = {"steps": got, "one_card": want, "rel_diff": float(rel.max()),
                     "replay_equal": True, "leaves": len(leaves), "host_leaves": on_host,
                     "launches": {k: launches[k] for k in kernels}}
    rec["serving_replicas"] = md_serving_replicas(dev, one)
    return rec


def md_serving_replicas(dev, one) -> dict:
    """The reduced din and bert4rec serve_p99 steps on a (2, 2) mesh whose
    first data shard is this card and second the host: ``place_params``
    puts each row-sharded table once per data shard (the host's blocks on
    the host), the step copies none of them, and its output is within
    RECSYS_TOL of the (1, 1) step's on the card (the second data shard's
    rows go through its dense layers on the host)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, materialize_inputs, place_params
    from repro_torch.parallel import Sharded, copy_record

    cpu = torch.device("cpu")
    grid = make_mesh((2, 2), ("data", "model"), devices=[dev, dev, cpu, cpu])
    out = {}
    for arch_id in MD_LOOKUP_ARCHS:
        arch = get_arch(arch_id).reduced()
        b1, bs = build_step(arch, "serve_p99", one), build_step(arch, "serve_p99", grid)
        params, batch = materialize_inputs(arch, "serve_p99", b1, seed=MODEL_SEED)
        placed = place_params(bs, params)
        names = bs.meta["sharded_tables"]
        if not names or not all(isinstance(placed[k], Sharded) and placed[k].grid == (2, 2)
                                and placed[k].block(1, 0).device == cpu for k in names):
            raise AssertionError(f"{arch_id} serve_p99 on (2, 2): tables {names} are not placed "
                                 "once per data shard")
        want = b1.fn(params, batch)
        with copy_record() as copies:
            got = bs.fn(placed, batch)
        table_bytes = sum(placed[k].shards[0].numel() * 4 for k in names)
        torch.testing.assert_close(got.to(want.device), want, rtol=RECSYS_TOL, atol=RECSYS_TOL)
        if copies.bytes.get("broadcast", 0) >= table_bytes:
            raise AssertionError(f"{arch_id} serve_p99 on (2, 2): copies {copies.bytes}")
        out[arch_id] = {"tables": list(names), "bitwise": torch.equal(got.to(want.device), want),
                        "max_abs_diff": float((got.to(want.device) - want).abs().max()),
                        "copies": dict(copies.bytes), "table_block_bytes": table_bytes}
    return out


DP_MIXED = ((2, 1), (2, 2))  # data shard 0 on the card, data shard 1 on the host
DP_ARCHS = ("bert4rec", "sasrec", "din", "two-tower-retrieval")
DP_SHAPES = ("train_batch", "serve_p99", "retrieval_cand")


def _dense_devices(calls: list):
    """Record the device of each dense call's rows (the towers, DIN's head,
    each seqrec block's MLP) into ``calls`` -> a function that undoes it."""
    from repro_torch.models import recsys

    saved = {n: getattr(recsys, n) for n in ("_tower", "_din_head", "mlp_block")}

    def wrap(fn):
        def recorded(p, x, *a, **k):
            calls.append((x.device.type, int(x.shape[0])))
            return fn(p, x, *a, **k)
        return recorded

    for n, fn in saved.items():
        setattr(recsys, n, wrap(fn))
    return lambda: [setattr(recsys, n, fn) for n, fn in saved.items()]


def _replica_gap(tree) -> tuple[float, int]:
    """(the largest absolute difference, the elements that differ) between
    every replica row of every ``Sharded`` leaf and its first row, wherever
    each lives: (0.0, 0) where all are equal to the bit."""
    from repro_torch.parallel import Sharded

    if isinstance(tree, dict):
        gaps = [_replica_gap(v) for v in tree.values()]
        return max((g for g, _ in gaps), default=0.0), sum(n for _, n in gaps)
    if not isinstance(tree, Sharded) or tree.axes[0] is not None:
        return 0.0, 0
    rows, cols = tree.grid
    gap, differ = 0.0, 0
    for i in range(1, rows):
        for j in range(cols):
            d = (tree.block(i, j).cpu() - tree.block(0, j).cpu()).abs()
            gap, differ = max(gap, float(d.max())), differ + int((d != 0).sum())
    return gap, differ


def _replicated(params, mesh, names):
    """Every table of ``names`` once per (data shard, model shard), every
    other leaf once per data shard, copies of ``params`` (one copy each,
    as ``place_params`` keeps them on a mesh whose devices are one)."""
    from repro_torch.parallel import Sharded

    grid = mesh.grid()

    def leaf(name, x):
        if isinstance(x, dict):
            return {k: leaf(name, v) for k, v in x.items()}
        if name in names:
            return Sharded.split(x.full(), grid, (None, 0))
        return Sharded.split(x.clone(), grid[:, :1], (None, None))

    return {k: leaf(k, v) for k, v in params.items()}


def md_recsys_dp(dev, one, total: dict) -> dict:
    """The reduced four recsys archs data-parallel on a (2, 1) mesh
    [card, host] and a (2, 2) mesh [card, card, host, host]: every table
    and leaf placed once per data shard (the second on the host), each
    data shard's rows (retrieval: candidates) through its own lookups and
    dense layers (each dense call's device recorded: as many on the host
    as on the card); serve and retrieval outputs within RECSYS_TOL of the
    card's (1, 1) step (top-k ids equal where not tied); TRAIN_STEPS train
    steps with every replica of every parameter and moment on the card
    within RECSYS_TOL of its replica on the host after each (the host's
    float32 root is not the card's: the gap is recorded), losses and grad
    norms within RECSYS_TOL of the (1, 1) steps, and the same steps from
    the seed again equal in every leaf (deterministic algorithms off: every
    lookup's backward is the sorted segment sum, on the host too). Then
    the train steps on the same mesh shapes of the card alone, with
    the replicas placed by hand (``place_params`` keeps one copy where the
    devices are one): every replica equal to the bit after each step."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh

    cpu = torch.device("cpu")
    out, calls = {}, []
    undo = _dense_devices(calls)
    try:
        for shape in DP_MIXED:
            cols = shape[1]
            mesh = make_mesh(shape, ("data", "model"), devices=[dev] * cols + [cpu] * cols)
            for arch_id in DP_ARCHS:
                for name in DP_SHAPES:
                    what = f"{arch_id} {name} on {shape} of the card and the host"
                    r = _dp_case(get_arch(arch_id).reduced(), name, one, mesh, total, calls, what)
                    # retrieval's user side runs once, on the card; a seqrec scores its
                    # candidates with no dense layer
                    on = r["dense_calls"]
                    if name != "retrieval_cand" and on["cpu"] != on["cuda"]:
                        raise AssertionError(f"{what}: dense calls on the card {on['cuda']}, "
                                             f"on the host {on['cpu']}")
                    if not on["cpu"] and (name != "retrieval_cand" or arch_id in DP_ARCHS[2:]):
                        raise AssertionError(f"{what}: no dense call on the host")
                    out[f"{arch_id} {name} {shape[0]}x{shape[1]}"] = r
        for shape in DP_MIXED:
            mesh = make_mesh(shape, ("data", "model"), devices=[dev] * (shape[0] * shape[1]))
            for arch_id in DP_ARCHS:
                what = f"{arch_id} train_batch on {shape} of the card, replicas by hand"
                out[f"{arch_id} train_batch {shape[0]}x{shape[1]} card"] = _dp_case(
                    get_arch(arch_id).reduced(), "train_batch", one, mesh, total, calls, what,
                    by_hand=True)
    finally:
        undo()
    return out


def _dp_case(arch, name: str, one, mesh, total: dict, calls: list, what: str,
             by_hand: bool = False) -> dict:
    """One arch and shape of :func:`md_recsys_dp` on ``mesh`` against the
    (1, 1) mesh ``one``; ``dense_calls``: the devices of the dense calls
    the counted run on ``mesh`` made (recorded into ``calls``). A train
    step's replicas (placed by hand where ``by_hand``) are held to the bit
    where they are all on one kind of device, else within RECSYS_TOL."""
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import tree_leaves
    from repro_torch.train.optimizer import init_opt_state

    b1, bs = build_step(arch, name, one), build_step(arch, name, mesh)
    first = materialize_inputs(arch, name, b1, seed=MODEL_SEED)
    r = {"split": bs.meta["split"]}

    def tally():
        return {t: sum(c[0] == t for c in calls) for t in ("cuda", "cpu")}

    def inputs():
        args = materialize_inputs(arch, name, bs, seed=MODEL_SEED)
        if not by_hand:
            return args
        p = _replicated(args[0], mesh, bs.meta["sharded_tables"])
        return p, init_opt_state(p), args[2]

    args = inputs()
    if name != "train_batch":
        want = b1.fn(*first)
        calls.clear()
        got, _ = counted(total, lambda: bs.fn(*args))
        r["dense_calls"] = tally()
        if isinstance(got, tuple):
            r["tied_swaps"] = same_top_k(got, tuple(t.cpu() for t in want), what)
        else:
            torch.testing.assert_close(got.to(want.device), want, rtol=RECSYS_TOL,
                                       atol=RECSYS_TOL)
            r["max_abs_diff"] = float((got.to(want.device) - want).abs().max())
        return r
    kinds = {d.type for d in mesh.unique_devices()}
    gaps = []

    def run(built, args, check=False):
        p, o, b = args
        metrics = []
        for _ in range(TRAIN_STEPS):
            p, o, m = built.fn(p, o, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if check:
                gap = max(_replica_gap(p), _replica_gap(o))
                gaps.append(gap)
                if (gap[1] if len(kinds) == 1 else gap[0] > RECSYS_TOL):
                    raise AssertionError(f"{what}: replicas {gap[0]:.3e} apart in {gap[1]} "
                                         f"elements after step {len(metrics)}")
        return metrics, [t.detach().cpu() for t in tree_leaves((p, o))]

    want, _ = run(b1, first)
    calls.clear()
    (got, leaves), _ = counted(total, lambda: run(bs, args, True))
    r["dense_calls"] = tally()
    again, leaves_again = run(bs, inputs())
    if again != got or not all(torch.equal(a, b) for a, b in zip(leaves, leaves_again)):
        raise AssertionError(f"{what}: a replay gives {again}, the first run {got}")
    rel = np.abs(np.array(got) / np.array(want) - 1)
    if not (np.isfinite(rel).all() and (rel <= RECSYS_TOL).all()):
        raise AssertionError(f"{what}: {got} against the card's (1, 1) {want}")
    r.update(steps=got, one_card=want, rel_diff=float(rel.max()),
             replica_gap=max(g for g, _ in gaps), replica_elements_apart=max(n for _, n in gaps),
             replay_equal=True)
    return r


def multidevice_phase(dev, train: dict, gnn: dict, stream_batches: list) -> dict:
    """The multi-device model paths over a (1, MD_SHARDS) mesh of this card
    (and of four cards when four are visible), each case against the same
    step unsharded on the card (see the module docstring); the launches of
    the sharded runs alone under ``launches``."""
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    report = {"device_count": torch.cuda.device_count(), "cases": {}, "launches": {}}
    total = report["launches"]
    for name, one, mesh in md_meshes(dev):
        t0 = time.perf_counter()
        rec = {"devices": [str(d) for d in mesh.devices.flat]}
        rec["twotower_serve"] = tt = md_twotower_serve(one, mesh, total)
        for n in MD_SERVE:
            r = tt[n]
            log(f"multidevice {name}: two-tower {n} B {r['B']}: sharded {r['ms']:.3f} ms against "
                f"unsharded {r['unsharded_ms']:.3f} ms; user vectors max diff "
                f"{r['user_max_abs_diff']:.2e}"
                + (f", top-k ids equal but {r['tied_swaps']} tied swaps" if "C" in r else
                   f", scores max diff {r['score_max_abs_diff']:.2e}")
                + f"; bag launched {MD_SHARDS}x a tower call (table shards are views: "
                f"{tt['views']})")
        log(f"multidevice {name}: bag kernel per shard at serve_bulk (V/{MD_SHARDS} rows): "
            + ", ".join(f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, "
                        f"library {r['library_ms']:.4f}, {r['valid_ids']} ids)"
                        for r in tt["bag_shards_serve_bulk"]))
        rec["twotower_train"] = tr = md_twotower_train(mesh, total, train["twotower"])
        log(f"multidevice {name}: two-tower train B {tr['B']}: losses {tr['losses']} (max rel "
            f"diff {tr['rel_diff']:.2e} to unsharded); ms per step "
            f"{[round(x, 2) for x in tr['step_ms']]} against unsharded "
            f"{[round(x, 2) for x in tr['unsharded_step_ms']]}; peak "
            f"{[round(b / 1e9, 3) for b in tr['peak_bytes']]} GB against "
            f"{tr['unsharded_peak_bytes'] / 1e9:.3f} GB; replay equal to the bit; backward kernel "
            "per shard " + ", ".join(f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain "
                                     f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f})"
                                     for r in tr["bag_backward_shards"]))
        rec["lookups"] = lk = md_lookups(one, mesh, total)
        for arch_id, r in lk.items():
            log(f"multidevice {name}: {arch_id} serve_p99, tables {r['sharded_tables']} sharded: "
                f"output equal to the unsharded step's to the bit; {r['ms']:.3f} ms against "
                f"{r['unsharded_ms']:.3f} ms")
        rec["egnn"] = eg = md_egnn(one, mesh, total, gnn, stream_batches)
        for shape in MD_EGNN_SHAPES:
            r = eg[shape]
            log(f"multidevice {name}: egnn {shape} edge-sharded: {r['steps']} against unsharded "
                f"{r['unsharded']} (max rel diff {r['rel_diff']:.2e}); replay equal to the bit; "
                f"ms per step {[round(x, 2) for x in r['step_ms']]} against "
                f"{[round(x, 2) for x in r['unsharded_step_ms']]}; segment sums "
                f"{r['launches']['segment_sum.segment_sum']} "
                f"({r['launches']['segment_sum.segment_sum long']} with the long kernel); peak "
                f"{[round(b / 1e9, 3) for b in r['peak_bytes']]} GB")
        st = eg["stream"]
        log(f"multidevice {name}: egnn minibatch_lg on {len(stream_batches)} sampled batches: "
            f"losses {st['losses']} against {st['unsharded_losses']}; ms "
            f"{[round(x, 2) for x in st['ms']]} against {[round(x, 2) for x in st['unsharded_ms']]}"
            f"; segment sums {st['launches'].get('segment_sum.segment_sum')} "
            f"({st['launches'].get('segment_sum.segment_sum long')} long)")
        log(f"multidevice {name}: segment sum per edge shard of a sampled batch, C 64: "
            + ", ".join(f"E {r['E']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, chain "
                        f"{r['chain_bound_ms']:.4f}: longest {r['longest']}; plain "
                        f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} index_add_, "
                        f"{r['index_put_ms']:.4f} index_put_ accumulate)"
                        for r in eg["segment_sum_shards"]))
        rec["granite"] = gr = md_granite(one, mesh)
        log(f"multidevice {name}: granite-moe prefill B {gr['B']} x S {gr['S']}, "
            f"{gr['experts']} experts and its attention and vocabulary over {gr['ranks']} ranks: "
            f"cosine {gr['cosine']:.6f}, argmax agreement {gr['argmax_agreement']:.4f} against "
            f"tp 1; prefill {gr['prefill_ms']:.2f} ms against {gr['unsharded_prefill_ms']:.2f} "
            f"ms; two gradient calls equal in all {len(gr['grads_twice']['differing'])} leaves")
        rec["compressed"] = cp = md_compressed(list(mesh.devices.flat))
        log(f"multidevice {name}: int8_allreduce_mean and topk_allreduce_mean over "
            f"{cp['ranks']} ranks of {cp['elements']} elements equal to the host's to the bit "
            f"({cp['int8_ms']:.3f} / {cp['topk_ms']:.3f} ms)")
        rec["seconds"] = time.perf_counter() - t0
        report["cases"][name] = rec
    report["recsys_dp"] = dp = md_recsys_dp(dev, make_mesh((1, 1), ("data", "model"),
                                                           devices=[dev]), total)
    for key, r in dp.items():
        log(f"multidevice: {key} data-parallel (split {r['split']}): "
            + (f"{r['steps']} against the card's (1, 1) {r['one_card']} (max rel diff "
               f"{r['rel_diff']:.2e}); replicas at most {r['replica_gap']:.2e} apart, in "
               f"{r['replica_elements_apart']} elements; a replay equal in every leaf"
               if "steps" in r else
               f"top-k within {RECSYS_TOL} of the card's (1, 1), {r['tied_swaps']} tied swaps"
               if "tied_swaps" in r else
               f"max abs diff {r['max_abs_diff']:.2e} to the card's (1, 1)")
            + f"; dense calls card {r['dense_calls']['cuda']}, host {r['dense_calls']['cpu']}")
    report["touched_sum"] = ts = md_touched_sum(dev)
    log(f"multidevice: two-tower item_emb gradients ({ts['V']} x {ts['D']} float32), "
        f"{ts['replicas']} replicas on this card, each a (2, 1) data shard's {ts['rows_a_shard']} "
        f"rows (list bound {ts['bound']}, live rows {ts['live_rows']}): all_reduce_rows equal to "
        f"all_reduce to the bit; ms all_reduce {[round(x, 3) for x in ts['all_reduce_ms']]}, "
        f"all_reduce_rows {[round(x, 3) for x in ts['all_reduce_rows_ms']]}; bytes a device "
        f"{ts['all_reduce_bytes_a_device']} against {ts['all_reduce_rows_bytes_a_device']} "
        f"(rows_move_less {ts['rows_move_less']}; the replicas share the card: the adds and the "
        "plan, not the links)")
    report["twotower_dp"] = {}
    for name, mesh in md_dp_meshes(dev):
        report["twotower_dp"][name] = tr = md_twotower_train(mesh, total, train["twotower"])
        log(f"multidevice {name}: two-tower train B {tr['B']} data-parallel on {tr['mesh']}: "
            f"losses {tr['losses']} (max rel diff {tr['rel_diff']:.2e} to (1, 1)); ms per step "
            f"{[round(x, 2) for x in tr['step_ms']]} against (1, 1) "
            f"{[round(x, 2) for x in tr['unsharded_step_ms']]}; peak "
            f"{[round(b / 1e9, 3) for b in tr['peak_bytes']]} GB against "
            f"{tr['unsharded_peak_bytes'] / 1e9:.3f} GB; bag and backward "
            f"{tr['launches']['embedding_bag.embedding_bag']} / "
            f"{tr['launches']['embedding_bag.embedding_bag_backward']} launches in "
            f"{TRAIN_STEPS} steps; sum_replicas synchronised {tr['sum_replicas_ms']:.3f} ms, "
            f"copies {tr['sum_replicas_copies']}; replay equal to the bit")
    report["mixed"] = mx = md_mixed(dev, total)
    log("multidevice: replicate, split_rows and sum_to_lead over the card and the host, and "
        "their gradient, equal to the same over the card to the bit")
    for name in ("two-tower", "egnn"):
        r = mx[name]
        log(f"multidevice: {name} reduced on a (1, 2) mesh of the card and the host: "
            f"{r['steps']} against the card's (1, 1) {r['one_card']} (max rel diff "
            f"{r['rel_diff']:.2e}); a replay equal in all {r['leaves']} leaves "
            f"({r['host_leaves']} on the host); card launches {r['launches']}, as the (1, 1) step's")
    for arch_id, r in mx["serving_replicas"].items():
        log(f"multidevice: {arch_id} reduced serve_p99 on a (2, 2) mesh of the card and the "
            f"host: tables {r['tables']} placed once per data shard, the output within "
            f"{RECSYS_TOL} of the card's (1, 1) step's (max abs diff {r['max_abs_diff']:.2e}, "
            f"bitwise {r['bitwise']}); copies {r['copies']} (a table block "
            f"{r['table_block_bytes']} B)")
    if torch.cuda.device_count() < MD_SHARDS:
        log("multidevice: fewer than four cards visible; the shards share one card and no "
            "cross-card copy was exercised")
    for name in ("embedding_bag.embedding_bag", "embedding_bag.embedding_bag_backward",
                 "segment_sum.segment_sum"):
        if not total.get(name):
            raise AssertionError(f"multidevice: {name} was not launched")
    report["reduced"] = [
        {"what": "egnn ogb_products", "cut": "reckoned, not run",
         "why": f"the backward keeps ~{OGB_SAVED_GB} GB a layer at 61,859,328 edges (the (E, 129) "
                "float32 input 31.9 GB; the edge MLP's hidden, its SiLU and output, the masked "
                "message, the coordinate MLP's hidden and its SiLU, 15.8 GB each), ~510 GB for 4 "
                f"layers: ~{OGB_SAVED_GB} GB a card over four cards, over the 76 GB limit; the "
                "reference built it for its 256-device mesh"},
        {"what": "granite-moe", "cut": f"prefill B {MD_GRANITE['global_batch']} x S "
                                       f"{MD_GRANITE['seq_len']}",
         "why": "the expert-parallel path's check; the LM meshes run in the tp phase"},
        {"what": "din, bert4rec", "cut": "serve_p99", "why": "the lookups are bitwise; their "
                                                             "retrieval runs in the models phase"}]
    report["seconds"] = time.perf_counter() - t_phase
    log(f"multidevice: phase {report['seconds']:.1f} s; launches of the sharded runs "
        f"{ {k: v for k, v in total.items() if v} }; reduced: "
        + "; ".join(f"{r['what']}: {r['cut']}" for r in report["reduced"]))
    return report


# -- the LM's tensor parallelism and FSDP (no kernel on this path) -------------------
TP_SHARDS = (4, 16)  # qwen's model axes on one card: whole heads at 4, inside heads at 16
TP_QWEN_LAYERS = 4  # qwen1.5-32b's depth, cut from 64: 5.8 GB of bf16 weights
TP_PREFILL = {"seq_len": 4096, "global_batch": 2}
TP_DECODE = {"seq_len": 16384, "global_batch": 4}  # a 5.4 GB bf16 cache at 4 layers
TP_DECODE_STEPS = 3  # decode steps at the cache's last positions, the (1, 1) greedy tokens
TP_COS = 0.999  # (1, 4) and (1, 16) logits against (1, 1)
TP_TIE = 4.0  # a row's top-1 may differ only where (1, 1)'s top-2 gap < TP_TIE x the rows' rms diff
TP_HEAD_COS = 0.999  # each kv head's cache against (1, 1)
# stablelm on (2, 2), cut from the train phase's B 8: at B 8 the (2, 2) step peaked at 70.28 GB
TP_TRAIN = {"seq_len": 4096, "global_batch": 4}
TP_LOSS_RTOL, TP_GNORM_RTOL = 1e-3, 1e-2  # the (2, 2) step's first loss and grad norm
TP_MIXED_TOL = 1e-5  # float32, (1, 2) of the card and the host against (1, 1) on the card
TP_MIXED_ARCHS = ("stablelm-1.6b", "phi3.5-moe-42b-a6.6b")


def with_env(name: str, value: str, fn):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def tp_meshes(dev) -> dict:
    from repro_torch.launch.mesh import make_mesh

    shapes = ((1, 1), (2, 2)) + tuple((1, n) for n in TP_SHARDS)
    return {shape: make_mesh(shape, ("data", "model"), devices=[dev] * (shape[0] * shape[1]))
            for shape in shapes}


def cache_split(built, cfg, S: int) -> tuple:
    """(the cache axis its model blocks split, their (start, stop) spans)
    per the step's ``cache_pspecs``: kv heads (axis 3), positions (axis
    2), or (None, None) where the cache is not split over the model
    shards."""
    from repro_torch.models import transformer

    spec = built.meta["cache_pspecs"]["k"]
    cols = built.meta["mesh"].grid().shape[1]
    if "model" not in spec or cols == 1:
        return None, None
    axis = spec.index("model")
    if axis == 3:
        return axis, transformer.head_spans(cfg, cols)[1]
    return axis, [(r * S // cols, (r + 1) * S // cols) for r in range(cols)]


def tp_cache(built, cfg, B: int, S: int, quantized: bool, seed: int):
    """The decode step's cache on its mesh (zeros, ``Sharded`` per
    ``cache_pspecs`` over several shards: kv heads or positions), every
    layer then drawn from a generator seeded by (seed, layer): the same
    values in either layout, one layer's draw alive at a time."""
    from repro_torch.models import transformer
    from repro_torch.parallel import Sharded

    grid = built.meta["mesh"].grid()
    dev = grid[0, 0]
    shapes = transformer.init_cache(cfg, B, S, quantized=quantized, device="meta")
    if grid.shape[0] != 1:
        raise ValueError("tp_cache fills caches of one data shard")
    axis, spans = cache_split(built, cfg, S)
    if axis is None:
        cache = transformer.init_cache(cfg, B, S, quantized=quantized, device=dev)
    else:
        cache = {k: Sharded([torch.zeros((*v.shape[:axis], b - a, *v.shape[axis + 1:]),
                                         dtype=v.dtype, device=grid[0, r])
                             for r, (a, b) in enumerate(spans)],
                            (1, len(spans)), (1, axis), spans) for k, v in shapes.items()}
    for layer in range(cfg.n_layers):
        gen = torch.Generator(device=dev).manual_seed(seed * 1000 + layer)
        for name in sorted(cache):
            shape = tuple(shapes[name].shape[1:])
            if shapes[name].dtype == torch.int8:
                x = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            elif "scale" in name:
                x = torch.rand(shape, generator=gen, device=dev).mul_(0.02).add_(1e-3)
            else:
                x = torch.randn(shape, generator=gen, device=dev).mul_(0.5).to(torch.bfloat16)
            c = cache[name]
            if isinstance(c, Sharded):
                for r, (a, b) in enumerate(c.spans):
                    c.block(0, r)[layer].copy_(x.narrow(axis - 1, a, b - a))
            else:
                c[layer].copy_(x)
            del x
    return cache


def cache_rows(cache: dict, positions: list) -> dict:
    """Each name's rows at ``positions`` (L, B, P, H[, Dh]) whole on the
    first block's device, from the blocks that hold them."""
    from repro_torch.parallel import Sharded

    idx = torch.tensor(positions)
    out = {}
    for k, c in cache.items():
        if not isinstance(c, Sharded):
            out[k] = c.index_select(2, idx.to(c.device))
        elif c.axes[1] == 2:  # positions over the model shards
            dev = c.shards[0].device
            out[k] = torch.cat([c.block(0, r).narrow(2, p - a, 1).to(dev)
                                for p in positions
                                for r, (a, b) in enumerate(c.spans) if a <= p < b], 2)
        else:
            out[k] = Sharded([b.index_select(2, idx.to(b.device)) for b in c.shards], c.grid,
                             c.axes, c.spans).full()
    return out


def head_cosines(a, b) -> list:
    """The cosine of each kv head (axis 3) of two (L, B, S, H[, Dh])
    caches, summed layer by layer in float64."""
    H = a.shape[3]
    dot, na, nb = (torch.zeros(H, dtype=torch.float64, device=a.device) for _ in range(3))
    for la, lb in zip(a, b):
        la = la.to(torch.float64).transpose(0, 2).reshape(H, -1)
        lb = lb.to(a.device, torch.float64).transpose(0, 2).reshape(H, -1)
        dot += (la * lb).sum(1)
        na += la.square().sum(1)
        nb += lb.square().sum(1)
    return (dot / (na.sqrt() * nb.sqrt())).tolist()


def block_positions(cache: dict) -> dict:
    """By name, a ``Sharded`` cache's split axis (2: positions, 3: kv heads)
    and the distinct sizes of its model blocks along it."""
    from repro_torch.parallel import Sharded

    return {k: (c.axes[1], sorted({b.shape[c.axes[1]] for b in c.shards}))
            for k, c in cache.items() if isinstance(c, Sharded)}


def tp_qwen(meshes) -> dict:
    """qwen1.5-32b at full width, its depth cut to TP_QWEN_LAYERS: the
    built prefill and decode steps (bf16 and int8 caches) on the (1, 1)
    mesh, then, with the weights placed TP-split (one contiguous block per
    model shard), on each (1, n) mesh of TP_SHARDS on the same card: at
    4 attention splits by whole heads and the cache by kv heads, at 16 it
    splits inside heads and the cache by positions (each block S / 16 of
    them); logits and caches against the (1, 1) steps', times and peaks.
    One set of weights and one decode cache live at a time."""
    from dataclasses import replace

    from repro_torch.configs.lm_archs import QWEN_32B
    from repro_torch.launch.steps import build_step, materialize_inputs, place_params
    from repro_torch.models import transformer
    from repro_torch.parallel import Sharded

    arch = replace(QWEN_32B, model_cfg=replace(QWEN_32B.model_cfg, n_layers=TP_QWEN_LAYERS))
    arch = cut_arch(arch, prefill_32k=("prefill", TP_PREFILL), decode_32k=("decode", TP_DECODE))
    cfg = arch.model_cfg
    B, S = TP_DECODE["global_batch"], TP_DECODE["seq_len"]
    positions = list(range(S - TP_DECODE_STEPS, S))
    first = torch.from_numpy(np.random.default_rng(MODEL_SEED).integers(
        0, cfg.vocab, (B, 1)).astype(np.int32))
    rec = {"layers": cfg.n_layers, "prefill": dict(TP_PREFILL), "decode": dict(TP_DECODE),
           "decode_steps": TP_DECODE_STEPS}
    params = tokens = None
    runs = {}
    for shape in ((1, 1),) + tuple((1, n) for n in TP_SHARDS):
        mesh = meshes[shape]
        dev = mesh.lead
        pre = build_step(arch, "prefill_32k", mesh)
        decs = {"bf16": build_step(arch, "decode_32k", mesh),
                "int8": with_env("REPRO_KV_INT8", "1", lambda: build_step(arch, "decode_32k", mesh))}
        t0 = time.perf_counter()
        if params is None:
            params, tokens = materialize_inputs(arch, "prefill_32k", pre, seed=MODEL_SEED)
            rec["weight_bytes"] = sum(t.numel() * t.element_size() for t in _leaves(params))
        else:
            whole = _whole_tree(params)
            del params
            params = place_params(pre, whole)
            del whole
            wq = params["layers"]["attn"]["wq"]
            if not isinstance(wq, Sharded) or wq.grid != shape:
                raise AssertionError(f"qwen {shape}: the attention weights are not split")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = {"place_s": time.perf_counter() - t0}
        pre.fn(params, tokens)  # first call: the allocator's pools
        (logits, cache), run["prefill_ms"] = timed(lambda: pre.fn(params, tokens))
        run["prefill_logits"] = logits.float()
        run["prefill_blocks"] = block_positions(cache)
        run["prefill_cache"] = {k: (v.full() if isinstance(v, Sharded) else v).to(dev)
                                for k, v in cache.items()}
        del cache
        torch.cuda.empty_cache()
        for kind, dec in decs.items():
            cache = tp_cache(dec, cfg, B, S, kind == "int8", MODEL_SEED)
            run[f"decode_{kind}_blocks"] = block_positions(cache)
            fed = [first.to(dev)] + ([t.to(dev) for t in runs[(1, 1)][f"fed_{kind}"][1:]]
                                    if (1, 1) in runs else [])
            logits, ms = [], []
            for i, pos in enumerate(positions):
                (lg, cache), t = timed(lambda: dec.fn(params, fed[i], cache, pos))
                logits.append(lg.float())
                ms.append(t)
                if len(fed) <= i + 1:
                    fed.append(lg.argmax(-1, keepdim=True).to(torch.int32))
            run[f"decode_{kind}_logits"] = torch.stack(logits)
            run[f"decode_{kind}_ms"] = ms
            run[f"decode_{kind}_rows"] = cache_rows(cache, positions)
            run[f"fed_{kind}"] = fed
            del cache
            torch.cuda.empty_cache()
        run["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        runs[shape] = run
    del params
    torch.cuda.empty_cache()
    one = runs[(1, 1)]
    bad = []
    for n in TP_SHARDS:
        tp = runs[(1, n)]
        checks = {}
        for key in ("prefill_logits", "decode_bf16_logits", "decode_int8_logits"):
            a = tp[key].reshape(-1, tp[key].shape[-1])
            b = one[key].reshape(-1, one[key].shape[-1])
            same = a.argmax(-1) == b.argmax(-1)
            top2 = b.topk(2, dim=-1).values
            noise = (a - b).square().mean(-1).sqrt()
            checks[key] = {"cosine": cosine(a, b), "top1": float(same.double().mean()),
                           "flips_outside_ties": int((~same & (top2[:, 0] - top2[:, 1]
                                                               > TP_TIE * noise)).sum())}
        head = {"prefill": {k: min(head_cosines(tp["prefill_cache"][k], one["prefill_cache"][k]))
                            for k in ("k", "v")}}
        for kind in ("bf16", "int8"):
            a, b = tp[f"decode_{kind}_rows"], one[f"decode_{kind}_rows"]
            if kind == "int8":  # the dequantised rows the step reads
                a = {m: a[m].float() * a[f"{m}_scale"][..., None] for m in ("k", "v")}
                b = {m: b[m].float() * b[f"{m}_scale"][..., None] for m in ("k", "v")}
            head[f"decode_{kind}"] = {m: min(head_cosines(a[m], b[m])) for m in ("k", "v")}
        blocks = {"prefill": tp["prefill_blocks"], "decode_bf16": tp["decode_bf16_blocks"],
                  "decode_int8": tp["decode_int8_blocks"]}
        r = {"checks": checks, "top1_agreement": min(c["top1"] for c in checks.values()),
             "head_cosine_min": head, "blocks": blocks}
        rec[f"vs_1x{n}"] = r
        bad += [f"(1, {n}) {k}" for k, c in checks.items()
                if c["cosine"] < TP_COS or c["flips_outside_ties"]]
        bad += [f"(1, {n}) {k} {m}" for k, v in head.items() for m, c in v.items()
                if c < TP_HEAD_COS]
        if not transformer.attention_splits(cfg, n):  # inside heads: S / n positions a block
            want = {"prefill": TP_PREFILL["seq_len"] // n, "decode_bf16": S // n,
                    "decode_int8": S // n}
            bad += [f"(1, {n}) {k} blocks {v}" for k, v in blocks.items()
                    if any(ax != 2 or sizes != [want[k]] for ax, sizes in v.values())]
    for shape, run in runs.items():
        rec[f"{shape[0]}x{shape[1]}"] = {
            "prefill_ms": run["prefill_ms"], "place_s": run["place_s"],
            "decode_bf16_ms": run["decode_bf16_ms"], "decode_int8_ms": run["decode_int8_ms"],
            "peak_bytes": run["peak_bytes"]}
    if bad:
        raise AssertionError(f"qwen against (1, 1): {bad}; {rec}")
    return rec


def _whole_tree(tree):
    from repro_torch.parallel import Sharded

    if isinstance(tree, dict):
        return {k: _whole_tree(v) for k, v in tree.items()}
    return tree.full() if isinstance(tree, Sharded) else tree


def tp_train(meshes) -> dict:
    """stablelm-1.6b train_4k at TP_TRAIN: one step on the (1, 1) mesh,
    then on the (2, 2) mesh (FSDP over 2 data shards x TP over 2 model
    shards, one microbatch) two steps from the seed, the state copied to
    the host after the first; then the first step again from the seed,
    every leaf equal to the copy."""
    from repro_torch.configs.lm_archs import STABLELM_1_6B
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import tree_leaves
    from repro_torch.parallel import Sharded

    arch = cut_arch(STABLELM_1_6B, train_4k=("train", TP_TRAIN))
    one, grid = meshes[(1, 1)], meshes[(2, 2)]
    b1, b22 = build_step(arch, "train_4k", one), build_step(arch, "train_4k", grid)
    rec = {"dims": dict(TP_TRAIN), "n_micro": {"1x1": b1.meta["n_micro"],
                                               "2x2": b22.meta["n_micro"]}}
    p, o, batch = materialize_inputs(arch, "train_4k", b1, seed=MODEL_SEED)
    reset_peaks(one)
    (p, o, m), ms = timed(lambda: b1.fn(p, o, batch))
    rec["1x1"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "ms": ms,
                  "peak_bytes": torch.cuda.max_memory_allocated(one.lead)}
    del p, o, m
    torch.cuda.empty_cache()
    host, runs = None, []
    for steps in (2, 1):
        p, o, batch = materialize_inputs(arch, "train_4k", b22, seed=MODEL_SEED)
        if not isinstance(p["layers"]["mlp"]["w_up"], Sharded) or p["embed"].grid != (2, 2):
            raise AssertionError("stablelm (2, 2): the parameters are not FSDP x TP split")
        reset_peaks(grid)
        run = {"metrics": [], "step_ms": []}
        for step in range(steps):
            (p, o, m), ms = timed(lambda: b22.fn(p, o, batch))
            run["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
            run["step_ms"].append(ms)
            if step == 0:
                leaves = tree_leaves((p, o))
                if host is None:
                    host = [t.detach().to("cpu", copy=True) for t in leaves]
                    run["blocks"] = len(host)
                else:
                    run["differing"] = sum(int((t.detach().cpu() != h).sum())
                                           for t, h in zip(leaves, host))
                del leaves
        run["peak_bytes"] = torch.cuda.max_memory_allocated(grid.lead)
        runs.append(run)
        del p, o, m
        torch.cuda.empty_cache()
    del host
    rec["2x2"] = runs
    first = runs[0]["metrics"][0]
    rel = (abs(first[0] / rec["1x1"]["loss"] - 1), abs(first[1] / rec["1x1"]["grad_norm"] - 1))
    rec["rel_diff"] = rel
    if rel[0] > TP_LOSS_RTOL or rel[1] > TP_GNORM_RTOL or runs[1]["differing"] \
            or runs[1]["metrics"][0] != first:
        raise AssertionError(f"stablelm (2, 2) train: {rec}")
    return rec


def tp_mixed(dev) -> dict:
    """The reduced stablelm and phi3.5-moe in float32 on a (1, 2) mesh of
    this card and the host (the only run whose collectives copy between
    distinct devices): two train steps, prefill and a decode step against
    the (1, 1) steps on the card within TP_MIXED_TOL, each run twice on the
    mixed mesh with every output and leaf equal to the bit. Then stablelm's
    prefill and decode on a (2, 1) mesh of the card and the host, whose
    every weight is a replica per data shard (no step copies weights
    between them), against the same (1, 1) steps."""
    from dataclasses import replace

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, materialize_inputs, place_caches
    from repro_torch.models import transformer, tree_leaves
    from repro_torch.parallel import Sharded

    one = make_mesh((1, 1), ("data", "model"), devices=[dev])
    mixed = make_mesh((1, 2), ("data", "model"), devices=[dev, torch.device("cpu")])
    rows = make_mesh((2, 1), ("data", "model"), devices=[dev, torch.device("cpu")])
    rec = {}

    def host(x):
        return (x.full("cpu") if isinstance(x, Sharded) else x.detach().cpu()).float()

    def close(a, b) -> float:
        a, b = host(a), host(b)
        if not torch.allclose(a, b, rtol=TP_MIXED_TOL, atol=TP_MIXED_TOL):
            return float("inf")
        return float((a - b).abs().max())

    for arch_id in TP_MIXED_ARCHS:
        arch = get_arch(arch_id).reduced()
        arch = replace(arch, model_cfg=replace(arch.model_cfg, dtype="float32"))
        cfg = arch.model_cfg

        def train(mesh):
            b = build_step(arch, "train_4k", mesh)
            p, o, batch = materialize_inputs(arch, "train_4k", b, seed=MODEL_SEED)
            out = []
            for _ in range(2):
                p, o, m = b.fn(p, o, batch)
                out.append((float(m["loss"]), float(m["grad_norm"])))
            return out, [host(t) for t in tree_leaves((p, o))], sum(
                t.device.type == "cpu" for t in tree_leaves(p))

        def serve(mesh):
            pre = build_step(arch, "prefill_32k", mesh)
            dec = build_step(arch, "decode_32k", mesh)
            params, tokens = materialize_inputs(arch, "prefill_32k", pre, seed=MODEL_SEED)
            logits, cache = pre.fn(params, tokens)
            B, S = (arch.shapes["decode_32k"].dims[k] for k in ("global_batch", "seq_len"))
            rng = np.random.default_rng(MODEL_SEED)
            whole = transformer.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
            for v in whole.values():
                v.copy_(torch.from_numpy(rng.normal(0, 0.5, v.shape).astype(np.float32)))
            token = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32))
            placed = place_caches(dec, {k: v.to(dev) for k, v in whole.items()})
            dl, dc = transformer.decode_step(cfg, params, token.to(dev), placed, S // 2, mesh)
            replicas = sum(isinstance(x, Sharded) and x.grid[0] == 2
                           and x.block(1, 0).device.type == "cpu" for x in _leaves(params))
            outs = [logits, dl] + [cache[k] for k in sorted(cache)] + [dc[k] for k in sorted(dc)]
            return outs, (replicas, len(_leaves(params)))

        (want, _, _), (got, leaves, on_host), (again, leaves2, _) = (train(one), train(mixed),
                                                                     train(mixed))
        rel = np.abs(np.array(got)[:, 0] / np.array(want)[:, 0] - 1)
        (s_one, _), (s_mixed, _), (s_again, _) = serve(one), serve(mixed), serve(mixed)
        diffs = [close(a, b) for a, b in zip(s_mixed, s_one)]
        replay = (again == got and all(torch.equal(a, b) for a, b in zip(leaves, leaves2))
                  and all(torch.equal(host(a), host(b)) for a, b in zip(s_mixed, s_again)))
        r = {"steps": got, "one_card": want, "loss_rel_diff": float(rel.max()),
             "serve_max_abs_diff": max(diffs), "replay_equal": replay, "host_leaves": on_host,
             "leaves": len(leaves)}
        ok = rel.max() <= TP_MIXED_TOL and max(diffs) <= TP_MIXED_TOL and replay and on_host
        if arch_id == "stablelm-1.6b":  # dense: its capacity does not depend on the data shards
            s_rows, (replicas, n_leaves) = serve(rows)
            r["rows_serve_max_abs_diff"] = max(close(a, b) for a, b in zip(s_rows, s_one))
            r["rows_replica_leaves"] = [replicas, n_leaves]
            ok = ok and r["rows_serve_max_abs_diff"] <= TP_MIXED_TOL and replicas == n_leaves
        rec[arch_id] = r
        if not ok:
            raise AssertionError(f"{arch_id} on the card and the host: {r}")
    return rec


def tp_phase(dev, smi: str) -> dict:
    """The LM's tensor parallelism and FSDP (see the module docstring);
    each cut listed under ``reduced``. No kernel runs on this path: the
    counts are read around the phase and must stay at 0."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    meshes = tp_meshes(dev)
    reset_counts()
    report = {"qwen": tp_qwen(meshes)}
    q = report["qwen"]
    one = q["1x1"]
    for n in TP_SHARDS:
        tp, vs = q[f"1x{n}"], q[f"vs_1x{n}"]
        log(f"tp: qwen1.5-32b ({q['layers']} layers, {q['weight_bytes'] / 1e9:.2f} GB bf16) "
            f"prefill B {TP_PREFILL['global_batch']} x S {TP_PREFILL['seq_len']}: (1, {n}) "
            f"{tp['prefill_ms']:.1f} ms against (1, 1) {one['prefill_ms']:.1f} ms; decode B "
            f"{TP_DECODE['global_batch']} on {TP_DECODE['seq_len']} rows, ms per step bf16 "
            f"{[round(x, 2) for x in tp['decode_bf16_ms']]} against "
            f"{[round(x, 2) for x in one['decode_bf16_ms']]}, int8 "
            f"{[round(x, 2) for x in tp['decode_int8_ms']]} against "
            f"{[round(x, 2) for x in one['decode_int8_ms']]}; peak {tp['peak_bytes'] / 1e9:.2f} "
            f"against {one['peak_bytes'] / 1e9:.2f} GB ({smi})")
        log(f"tp: qwen (1, {n}) against (1, 1): " + ", ".join(
            f"{k} cosine {c['cosine']:.6f} top-1 {c['top1']:.3f} ({c['flips_outside_ties']} "
            "flips outside near-ties)" for k, c in vs["checks"].items())
            + "; least kv-head cosine "
            + ", ".join(f"{k} {min(v.values()):.6f}" for k, v in vs["head_cosine_min"].items())
            + "; cache blocks (axis: sizes) "
            + ", ".join(f"{k} {v['k'][0]}: {v['k'][1]}" for k, v in vs["blocks"].items()))
    report["train"] = tr = tp_train(meshes)
    runs, one = tr["2x2"], tr["1x1"]
    log(f"tp: stablelm-1.6b train B {TP_TRAIN['global_batch']} x S {TP_TRAIN['seq_len']} on "
        f"(2, 2) (FSDP x TP, n_micro {tr['n_micro']['2x2']}): steps {runs[0]['metrics']}, ms "
        f"{[round(x, 1) for x in runs[0]['step_ms']]}, peak {runs[0]['peak_bytes'] / 1e9:.2f} "
        f"GB; (1, 1) first step loss {one['loss']:.6f} grad norm {one['grad_norm']:.6f}, "
        f"{one['ms']:.1f} ms, peak {one['peak_bytes'] / 1e9:.2f} GB; rel diff "
        f"{tr['rel_diff']}; the first step again from the seed differs in "
        f"{runs[1]['differing']} elements of {runs[0]['blocks']} blocks ({smi})")
    report["mixed"] = mx = tp_mixed(dev)
    for arch_id, r in mx.items():
        log(f"tp: {arch_id} reduced, float32, on a (1, 2) mesh of the card and the host: train "
            f"{r['steps']} against the card's (1, 1) {r['one_card']} (loss rel diff "
            f"{r['loss_rel_diff']:.2e}); prefill and decode max abs diff "
            f"{r['serve_max_abs_diff']:.2e}; replays equal to the bit ({r['host_leaves']} of "
            f"{r['leaves']} parameter blocks on the host)"
            + (f"; on a (2, 1) mesh of the card and the host, prefill and decode max abs diff "
               f"{r['rows_serve_max_abs_diff']:.2e}, {r['rows_replica_leaves'][0]} of "
               f"{r['rows_replica_leaves'][1]} weights a replica per data shard"
               if "rows_replica_leaves" in r else ""))
    report["launches"] = {k: v for k, v in read_counts().items() if v}
    if report["launches"]:
        raise AssertionError(f"tp: the LM path launched {report['launches']}")
    report["reduced"] = [
        {"what": "qwen1.5-32b", "cut": f"{TP_QWEN_LAYERS} of 64 layers; prefill B "
                                       f"{TP_PREFILL['global_batch']} x S {TP_PREFILL['seq_len']},"
                                       f" decode B {TP_DECODE['global_batch']} on "
                                       f"{TP_DECODE['seq_len']} rows",
         "why": "64 layers are 70.4 GB of bf16 weights, over the card's 76 GB with a cache; "
                "4 keep the (1, 1), (1, 4) and (1, 16) runs inside the script's time beside "
                "the recsys data shards' runs; the (1, 1) step it is held to must fit the "
                "same card"},
        {"what": "stablelm-1.6b train_4k on (2, 2)", "cut": f"B {TP_TRAIN['global_batch']} "
                                                            "(the train phase's B 8 halved)",
         "why": "one card holds all four shards: at B 8, one microbatch of 8, the (2, 2) step "
                "peaked at 70.28 GB, over a 70 GB margin under the 76 GB limit"},
        {"what": "the (1, 2) mesh of the card and the host", "cut": "reduced configs, float32",
         "why": "the host's share of a full-width step would take minutes"}]
    report["seconds"] = time.perf_counter() - t_phase
    log(f"tp: phase {report['seconds']:.1f} s; no kernel launched; reduced: "
        + "; ".join(f"{r['what']}: {r['cut']}" for r in report["reduced"]))
    return report


# -- the analysis tools: count, roofline, layer probe, a profiled step ---------
ANALYSIS_SHARE_MAX = 1.05  # a share of the roofline above this: the count overstates the work
BAG_5B_BYTES = 10_280_108_032  # PERF.md row 5b's bound: two-tower train B 32,768 S 50, V 10M D 256
SEG_6_BYTES = 89_456_644  # row 6's bytes: E 172,032 C 64 into 172,032 rows
BAG_SERVE_BULK = (7_800.48e6, 4.1023)  # row 5 at serve_bulk: distinct rows' bytes, every lookup ms
PROFILE_TOP = 10


def analysis_cells() -> list:
    """(tag, arch, shape, kernels its step must launch, timed calls): the
    shapes the models, train, gnn and search phases run at."""
    from repro_torch.configs.lm_archs import STABLELM_1_6B
    from repro_torch.configs.recsys_archs import TWO_TOWER
    from repro_torch.configs.registry import get_arch

    lm = cut_arch(STABLELM_1_6B, prefill=("prefill", {"seq_len": 4096, "global_batch": 4}),
                  decode=("decode", {"seq_len": 32768, "global_batch": 4}),
                  train=("train", LM_TRAIN))
    tt = cut_arch(TWO_TOWER, serve_bulk=("serve", TWO_TOWER.shapes["serve_bulk"].dims),
                  train_batch=("train", {"batch": TT_TRAIN_B}))
    bag, bwd, seg = ("embedding_bag.embedding_bag", "embedding_bag.embedding_bag_backward",
                     "segment_sum.segment_sum")
    return [("search qt1_heavy", get_arch("proximity-search"), "qt1_heavy", (), 5),
            ("egnn minibatch_lg", get_arch("egnn"), "minibatch_lg", (seg,), 5),
            ("two-tower serve_bulk", tt, "serve_bulk", (bag,), 5),
            ("two-tower train_batch", tt, "train_batch", (bag, bwd, seg), 3),
            ("stablelm prefill", lm, "prefill", (), 3),
            ("stablelm decode", lm, "decode", (), 5),
            ("stablelm train", lm, "train", (), 2)]


def search_inputs_on_card(arch, shape: str, dev) -> tuple:
    """The QT1 step's raw inputs made on the card: every row full, strictly
    increasing keys 4 l + U[0, 4) with fragment bounds 2 either side (the
    host's draw takes minutes at qt1_heavy; the count reads shapes only)."""
    B, L, K = (arch.shapes[shape].dims["batch"], arch.shapes[shape].dims["postings"],
               arch.model_cfg.n_keys)
    gen = torch.Generator(device=dev).manual_seed(MODEL_SEED)
    g = (torch.arange(L, device=dev, dtype=torch.int32) * 4
         + torch.randint(0, 4, (B, K, L), device=dev, generator=gen, dtype=torch.int32))
    idf = torch.rand(B, device=dev, generator=gen) * 4 + 1
    return g, g - 2, g + 2, idf, torch.full((B,), 3.0, device=dev)


def decode_inputs_on_card(arch, shape: str, built, dev) -> tuple:
    """A decode step's inputs: seeded bf16 weights, a token per row, a
    zeroed cache made on the card (the host's draw of 6.4G cache values
    takes minutes; a step's time does not depend on them) and the position
    of its last row, where the count puts it."""
    from repro_torch.launch.steps import place_params
    from repro_torch.models import transformer

    cfg = arch.model_cfg
    B, S = arch.shapes[shape].dims["global_batch"], arch.shapes[shape].dims["seq_len"]
    params = place_params(built, transformer.init_params(cfg, MODEL_SEED, device=dev,
                                                         dtype=torch.bfloat16))
    token = torch.randint(0, cfg.vocab, (B, 1), device=dev, dtype=torch.int32,
                          generator=torch.Generator(device=dev).manual_seed(MODEL_SEED))
    return params, token, transformer.init_cache(cfg, B, S, device=dev), S - 1


def analysis_cell(dev, one, meta_one, tag, arch, shape, kernels, runs) -> dict:
    """One cell: its dry-run count on a (1, 1) mesh of ``meta``, then its
    built step on the card, warm, ``runs`` calls timed by CUDA events with
    the counts at 0 and the peak reset; the roofline bound of the count,
    max(flops / peak of its type, bytes / HBM), against the median."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.steps import build_step, materialize_inputs

    t = time.perf_counter()
    rec = run_cell(arch, shape, False, layer_probe=False, mesh=meta_one)
    count_s = time.perf_counter() - t
    built = build_step(arch, shape, one)
    if arch.family == "search":
        args = search_inputs_on_card(arch, shape, dev)
    elif "cache_pspecs" in built.meta:
        args = decode_inputs_on_card(arch, shape, built, dev)
    else:
        args = materialize_inputs(arch, shape, built, seed=MODEL_SEED)
    _, first_ms = timed(lambda: built.fn(*args))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = [timed(lambda: built.fn(*args))[1] for _ in range(runs)]
    launches = {k: v for k, v in read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times)
    cost = rec["cost"]
    peak_rate = PEAK_FLOPS[rec["compute_dtype"]]
    bound_ms = max(cost["flops"] / peak_rate, cost["bytes_accessed"] / HBM_BW) * 1e3
    out = {"tag": tag, "shape": dict(arch.shapes[shape].dims), "count_s": count_s,
           "cost": cost, "memory": rec["memory"], "kernels": rec["kernels"],
           "extrapolated": rec.get("extrapolated"), "compute_dtype": rec["compute_dtype"],
           "first_ms": first_ms, "ms": ms, "step_ms": times, "peak_bytes": peak,
           "bound_ms": bound_ms, "bound_by": "operations" if cost["flops"] / peak_rate
           >= cost["bytes_accessed"] / HBM_BW else "bytes", "share": bound_ms / ms,
           "launches": launches}
    del args, built
    torch.cuda.empty_cache()
    if out["share"] > ANALYSIS_SHARE_MAX:
        raise AssertionError(f"analysis {tag}: the count's bound {bound_ms:.4f} ms is "
                             f"{out['share']:.3f} of the step's {ms:.4f} ms: it overstates the work")
    if rec["memory"]["argument_bytes"] > peak:
        raise AssertionError(f"analysis {tag}: reckoned arguments {rec['memory']['argument_bytes']} "
                             f"B exceed the measured peak {peak} B")
    for name in kernels:
        counted = rec["kernels"].get(name, {}).get("launches", 0)
        if launches.get(name, 0) != runs * counted or not counted:
            raise AssertionError(f"analysis {tag}: {name} launched {launches.get(name, 0)} times "
                                 f"in {runs} steps, counted {counted} a step")
    return out


def kernel_bytes_checks() -> dict:
    """The counting pass's bytes for 5b and row 6 at PERF.md's shapes
    (shape-only bounds): each must equal the table's."""
    from repro_torch.kernels.embedding_bag import embedding_bag_backward
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.obs.cost import count

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    _, bag = count(embedding_bag_backward, meta(TT_TRAIN_B, 50),
                   meta(TT_TRAIN_B, 256, dtype=torch.float32), 10_000_000)
    _, seg = count(segment_sum, meta(172_032, 64, dtype=torch.float32), meta(172_032), 172_032)
    got = {"5b": bag.kernels["embedding_bag.embedding_bag_backward"]["bytes_accessed"],
           "6": seg.kernels["segment_sum.segment_sum"]["bytes_accessed"]}
    if got != {"5b": BAG_5B_BYTES, "6": SEG_6_BYTES}:
        raise AssertionError(f"analysis: kernel bytes {got}, PERF.md's bounds "
                             f"{BAG_5B_BYTES} and {SEG_6_BYTES}")
    return got


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def profiled_step(fn) -> dict:
    """One call of ``fn`` under torch.profiler (CPU and CUDA): the top
    device ops by their own device time, and the device's busy share of
    the call's CUDA-event time (the sum of its kernels' and copies' times
    over the wall time; one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_ms = timed(fn)
    events = prof.key_averages()
    on_device = [e for e in events if "CUDA" in str(e.device_type)]
    busy_ms = sum(_device_us(e) for e in on_device) / 1e3
    if busy_ms <= 0:
        raise AssertionError("analysis: the profiler saw no device time")
    ops = sorted((e for e in events if "CUDA" not in str(e.device_type) and _device_us(e) > 0),
                 key=_device_us, reverse=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "top": [{"op": e.key, "device_ms": _device_us(e) / 1e3, "calls": e.count,
                     "share": _device_us(e) / 1e3 / busy_ms} for e in ops[:PROFILE_TOP]]}


def layer_probe_run(dev, one, meta_one, arch, step) -> dict:
    """stablelm's layer probe at the prefill shape: its count (24 of its
    FLOPs must not exceed the step's) and its warm time on the card, on
    layer 0 of bf16 weights, against the step's."""
    from dataclasses import replace

    from repro_torch.launch.dryrun import count_built
    from repro_torch.launch.steps import build_lm_layer_probe
    from repro_torch.models import layer_slice, transformer

    shape = arch.shapes["prefill"]
    probe = build_lm_layer_probe(arch, shape, meta_one)
    _, _, pcost = count_built(probe)
    cfg = arch.model_cfg
    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    params = transformer.init_params(replace(cfg, n_layers=1), MODEL_SEED, device=dev,
                                     dtype=torch.bfloat16)
    layer = layer_slice(params["layers"], 0)
    x = torch.randn((B, S, cfg.d_model), device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(MODEL_SEED))
    built = build_lm_layer_probe(arch, shape, one)
    timed(lambda: built.fn(x, layer))
    ms = median_ms(lambda: built.fn(x, layer), 3)
    L = cfg.n_layers
    rec = {"flops": pcost.flops, "bytes_accessed": pcost.bytes_accessed, "ms": ms,
           "layers_ms": L * ms, "step_ms": step["ms"], "layers_flops": L * pcost.flops,
           "step_flops": step["cost"]["flops"]}
    del params, layer, x
    torch.cuda.empty_cache()
    if L * pcost.flops > step["cost"]["flops"]:
        raise AssertionError(f"analysis: {L} x the layer probe's FLOPs exceed the step's: {rec}")
    return rec


def analysis_phase(dev, smi: str) -> dict:
    """The analysis tools on the card (see the module docstring): each
    cell's dry-run count against its measured step, the kernels' reported
    bytes against PERF.md's bounds, stablelm's layer probe and a profiled
    prefill step."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, materialize_inputs

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    one = make_mesh((1, 1), ("data", "model"))
    meta_one = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    report = {"kernel_bytes": kernel_bytes_checks(), "cells": {}}
    log(f"analysis: counted kernel bytes 5b {report['kernel_bytes']['5b'] / 1e6:.2f} MB, "
        f"6 {report['kernel_bytes']['6'] / 1e6:.2f} MB (PERF.md's bounds)")
    lm = None
    for tag, arch, shape, kernels, runs in analysis_cells():
        rec = analysis_cell(dev, one, meta_one, tag, arch, shape, kernels, runs)
        report["cells"][tag] = rec
        c = rec["cost"]
        log(f"analysis: {tag} {rec['shape']}: count {c['flops']:.4e} FLOP, "
            f"{c['bytes_accessed'] / 1e9:.3f} GB, {c['transcendentals']:.4e} transcendentals "
            f"({rec['count_s']:.1f} s on the host{', extrapolated ' + str(rec['extrapolated']) if rec['extrapolated'] else ''}); "
            f"step {rec['ms']:.4f} ms (median of {len(rec['step_ms'])}, first {rec['first_ms']:.1f}); "
            f"peak {rec['peak_bytes'] / 1e9:.2f} GB against reckoned arguments "
            f"{rec['memory']['argument_bytes'] / 1e9:.2f} GB, peak/dev "
            f"{rec['memory']['peak_per_device_gib']} GiB; bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} ({rec['compute_dtype']}), share {rec['share']:.4f}; launches "
            f"{rec['launches']} ({smi})")
        if arch.family == "lm":
            gib = rec["memory"]["peak_per_device_gib"]
            if gib is None:
                raise AssertionError(f"analysis: {tag} has no reckoned peak")
            log(f"analysis: {tag} reckoned peak {gib} GiB ({gib * 2**30 / 1e9:.2f} GB"
                f"{', reckoned from ' + str(rec['extrapolated']) if rec['extrapolated'] else ''}) "
                f"beside torch.cuda.max_memory_allocated {rec['peak_bytes'] / 1e9:.2f} GB ({smi})")
        if tag == "two-tower serve_bulk":
            got = rec["kernels"]["embedding_bag.embedding_bag"]["bytes_accessed"]
            log(f"analysis: row 5 at serve_bulk counted {got / 1e6:.2f} MB ({got / HBM_BYTES_PER_S * 1e3:.4f} ms) "
                f"beside {BAG_SERVE_BULK[0] / 1e6:.2f} MB for its distinct rows and "
                f"{BAG_SERVE_BULK[1]:.4f} ms counting every lookup")
        if tag == "two-tower train_batch":
            k = rec["kernels"]["embedding_bag.embedding_bag_backward"]
            if k["bytes_accessed"] != BAG_5B_BYTES * k["launches"]:
                raise AssertionError(f"analysis: the train step's bag backward counted {k}")
        if tag == "stablelm prefill":
            lm = arch
            report["probe"] = pr = layer_probe_run(dev, one, meta_one, arch, rec)
            log(f"analysis: stablelm layer probe at B 4 x S 4096: {pr['flops']:.4e} FLOP, "
                f"{pr['ms']:.3f} ms; x {arch.model_cfg.n_layers} = {pr['layers_ms']:.1f} ms "
                f"against the step's {pr['step_ms']:.1f} ms, {pr['layers_flops']:.4e} FLOP "
                f"against {pr['step_flops']:.4e}")
    built = build_step(lm, "prefill", one)
    args = materialize_inputs(lm, "prefill", built, seed=MODEL_SEED)
    report["profile"] = prof = profiled_step(lambda: built.fn(*args))
    del args, built
    torch.cuda.empty_cache()
    log(f"analysis: stablelm prefill under torch.profiler: {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms ({prof['busy_share']:.4f}), idle {prof['idle_share']:.4f}; top "
        + ", ".join(f"{t['op']} {t['device_ms']:.1f} ms x{t['calls']}" for t in prof["top"]))
    report["launches"] = {}
    for r in report["cells"].values():
        for k, v in r["launches"].items():
            report["launches"][k] = report["launches"].get(k, 0) + v
    report["seconds"] = time.perf_counter() - t_phase
    log(f"analysis: phase {report['seconds']:.1f} s")
    return report


def kernel_entry(name, source, replaces, launches, err, rec, extra) -> dict:
    """One kernel of the kernels line, from its primary shape's record."""
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "matches_plain": True,
            "max_abs_err": err, **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms")},
            "wrapper_ms": rec["wrapper_ms"], **extra}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", help="also write the full report as JSON here")
    parser.add_argument("--parent-csrc", type=Path,
                        help="also time nearest_r.cu, embedding_bag.cu, intersect.cu (raw and "
                             "compressed), proximity.cu and segment_sum.cu (the entry point with "
                             "no long-segment list) "
                             "built from this directory, in turns with the current kernels")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build

    smi = header()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    built = build(SOURCES)
    log("build: " + ", ".join(f"{n}.cu {t:.1f} s" for n, t in built.items())
        + f" (all sources, in parallel, {time.perf_counter() - t0:.1f} s)")
    parent = args.parent_csrc
    if parent is not None:
        parent = parent.resolve()
        built_parent = build(PARENT_SOURCES, parent)
        log(f"build: earlier kernels from {parent}: "
            + ", ".join(f"{n}.cu {t:.1f} s" for n, t in built_parent.items()))
    kern = kernel_phase(dev, parent)
    errs = replay_phase(dev)
    lib = library_phase(dev, errs, parent)
    index, queries, table, lex = serve_world()
    serve, want = serve_phase(dev, index, queries)
    comp, comp_svc = compressed_serve_phase(dev, index, queries, want)
    load = load_phase(comp_svc, queries)
    del comp_svc
    sharded = sharded_phase(dev, index, queries, want)
    del index
    steps = compressed_steps_phase(dev)
    segmented = segmented_phase(dev, table, lex, queries)
    tuned = tune_phase(dev)
    models = models_phase(dev)
    train = train_phase(dev)
    stream_batches = []
    gnn = gnn_phase(dev, parent, stream_batches)
    search = search_phase(dev)
    multi = multidevice_phase(dev, train, gnn, stream_batches)
    del stream_batches
    tp = tp_phase(dev, smi)
    analysis = analysis_phase(dev, smi)
    qt5 = kern["shapes"]["qt5"]
    sh, n = lib["shapes"], lib["launches"]
    heavy, bag = FULL_SHAPES[-1][0], f"B{BAG_BATCHES[-1]}"  # each kernel's primary shape

    def others(kind, primary, wrapper="wrapper_ms"):
        return {"shape": {k: v for k, v in sh[kind][primary].items()
                          if k in ("Na", "Nb", "d", "k_tiles", "B", "S", "V", "D")},
                "other_shapes": {tag: {"wrapper_ms": r[wrapper],
                                       **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "bound_by", "library_ms")}}
                                 for tag, r in sh[kind].items() if tag != primary}}

    line = {"kernels": [
        {"name": "nearest_r.window_join",
         "route": "cuda",
         "source": "src/repro_torch/csrc/nearest_r.cu",
         "replaces": "src/repro/kernels/nearest_r/nearest_r.py:207",
         "launches": serve["launches"],
         "launches_compressed": comp["launches"]["nearest_r.window_join"],
         "launches_segmented": segmented["launches"],
         "launches_sharded": sharded["launches"],
         "matches_plain": True,
         "max_abs_err": kern["max_abs_err"],
         "ms": qt5["ms"],
         "plain_ms": qt5["plain_ms"],
         "bound_ms": qt5["bound_ms"],
         "bound_by": qt5["bound_by"],
         "library_ms": None,
         "shape": {k: qt5[k] for k in ("B", "Kn", "Ks", "L")},
         "qt34": {k: kern["shapes"]["qt34"][k]
                  for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        kernel_entry("intersect.intersect_sorted", "intersect.cu",
                     "src/repro/kernels/intersect/intersect.py:153",
                     n["intersect.intersect_sorted"], lib["max_abs_err"]["intersect"],
                     sh["intersect"][heavy], others("intersect", heavy)),
        kernel_entry("intersect.intersect_compressed_streams", "intersect.cu",
                     "src/repro/kernels/intersect/intersect.py:106",
                     n["intersect.intersect_compressed_streams"], lib["max_abs_err"]["compressed"],
                     dict(sh["compressed"][heavy], wrapper_ms=sh["compressed"][heavy]["streams_ms"]),
                     others("compressed", heavy, "streams_ms")),
        kernel_entry("intersect.intersect_sorted_compressed", "intersect.cu",
                     "src/repro/kernels/intersect/intersect.py:106",
                     n["intersect.intersect_sorted_compressed"],
                     lib["max_abs_err"]["compressed"], sh["compressed"][heavy], others("compressed", heavy)),
        kernel_entry("proximity.proximity_join", "proximity.cu",
                     "src/repro/kernels/proximity/proximity.py:69",
                     n["proximity.proximity_join"], lib["max_abs_err"]["proximity"],
                     sh["proximity"][heavy], others("proximity", heavy)),
        kernel_entry("embedding_bag.embedding_bag", "embedding_bag.cu",
                     "src/repro/kernels/embedding_bag/embedding_bag.py:73",
                     n["embedding_bag.embedding_bag"], lib["max_abs_err"]["embedding_bag"],
                     sh["embedding_bag"][bag],
                     {**others("embedding_bag", bag),
                      "launches_models": models["launches"]["embedding_bag.embedding_bag"],
                      "launches_train": train["twotower"]["launches"]["embedding_bag.embedding_bag"],
                      "launches_multidevice": multi["launches"]["embedding_bag.embedding_bag"],
                      "launches_analysis": analysis["launches"]["embedding_bag.embedding_bag"],
                      "models_serve_bulk": {k: models["bag_serve_bulk"][k] for k in (
                          "B", "S", "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
                          "bound_by", "bound_all_lookups_ms")}}),
        kernel_entry("embedding_bag.embedding_bag_backward", "embedding_bag.cu",
                     "none: the gradient of src/repro/models/embedding.py:26 embedding_bag_sum, "
                     "which the reference differentiates through XLA",
                     train["twotower"]["launches"]["embedding_bag.embedding_bag_backward"],
                     train["max_abs_err"], train["twotower"]["bag_backward"],
                     {"matches_plain": "bitwise, against the plain version on the host",
                      "launches_multidevice": multi["launches"][
                          "embedding_bag.embedding_bag_backward"],
                      "launches_analysis": analysis["launches"][
                          "embedding_bag.embedding_bag_backward"],
                      "long_launches": train["twotower"]["launches"][
                          "embedding_bag.embedding_bag_backward long"],
                      "shape": {k: train["twotower"]["bag_backward"][k] for k in ("B", "S", "V", "D")},
                      **{k: train["twotower"]["bag_backward"][k] for k in (
                          "plan_ms", "distinct_rows")}}),
        kernel_entry("segment_sum.segment_sum", "segment_sum.cu",
                     "none: jax.ops.segment_sum in src/repro/models/gnn.py:70-72, which XLA lowers",
                     sum(rec["launches"]["segment_sum.segment_sum"]
                         for rec in gnn["shapes"].values()), 0.0,
                     gnn["segment_sum"]["sampler C64"],
                     {"matches_plain": "bitwise, against the plain version on the host",
                      "also_replaces": "the gradient of jnp.take in src/repro/models/"
                                       "embedding.py:19-24 and :34-40 (every recsys lookup)",
                      "launches_models": models["launches"].get("segment_sum.segment_sum", 0),
                      "launches_train": train["twotower"]["launches"]["segment_sum.segment_sum"],
                      "launches_multidevice": multi["launches"]["segment_sum.segment_sum"],
                      "launches_analysis": analysis["launches"]["segment_sum.segment_sum"],
                      "long_launches_multidevice": multi["launches"]["segment_sum.segment_sum long"],
                      "shape": {k: gnn["segment_sum"]["sampler C64"][k] for k in ("E", "N", "C")},
                      "long_launches": sum(rec["launches"]["segment_sum.segment_sum long"]
                                           for rec in gnn["shapes"].values()),
                      **{k: gnn["segment_sum"]["sampler C64"][k] for k in (
                          "plan_ms", "chain_bound_ms", "longest", "index_put_ms")},
                      "launches_per_step": {shape: rec["segment_sums_per_step"]
                                            for shape, rec in gnn["shapes"].items()},
                      "other_shapes": {tag: {k: r[k] for k in (
                          "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                          "index_put_ms", "chain_bound_ms")}
                                       for tag, r in {**gnn["segment_sum"], "two-tower item "
                                                      "lookup backward": train["twotower"][
                                                          "lookup_backward"]}.items()
                                       if tag != "sampler C64"},
                      "touched_sum": {k: multi["touched_sum"][k] for k in (
                          "bound", "live_rows", "all_reduce_ms", "all_reduce_rows_ms",
                          "all_reduce_bytes_a_device", "all_reduce_rows_bytes_a_device")}}),
    ]}
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(
            {"nvidia_smi": smi, "build_s": built, "kernel": kern, "library": lib,
             "serve": serve, "compressed": comp, "load": load, "compressed_steps": steps,
             "segmented": segmented, "sharded": sharded, "tune": tuned, "models": models,
             "train": train, "gnn": gnn, "search": search, "multidevice": multi, "tp": tp,
             "analysis": analysis},
            indent=1, default=float))
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
