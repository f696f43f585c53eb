"""Smoke run of the PyTorch port on one NVIDIA card.

    python chip_smoke.py [--report PATH]

Builds every CUDA kernel of the serving path from ``src/repro_torch/csrc``,
holds each kernel against its plain PyTorch version on the card (replayed
case families and the top-of-ladder shapes of the default ServeConfig),
times both with CUDA events, then serves mixed QT1-QT5 traffic through
``SearchService`` on the card and checks that its records equal a CPU run
of the same service and that the main path went through the kernels.

The second-to-last line of standard output is the kernels JSON line, the
last line ``{"ok": true, "device": {...}}``. The script fails (non-zero
exit, no result line) without a card, and outside a checkout of the repo.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores; no int32 row is published beside it
MAX_SEP, R_MAX = 5, 4  # ServeConfig defaults: max_distance=5, r_max=4
N_DOCS, N_QUERIES = 20_000, 256
TIMING_RUNS = 25


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


def median_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median device time of ``fn`` over ``runs`` calls, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def replay_cases():
    """Seeded numpy replays of the case families: ties, r = 0..r_max,
    empty rows, SENTINEL anchors, the stop fold, ragged L."""
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
        cases.append((f"random{seed}", arrays, 1 + seed % 7))
    for r in range(R_MAX + 1):
        rng = np.random.default_rng(100 + r)
        a = _rows(rng, 2, 1, 200, 2)[:, 0]
        ns = _rows(rng, 2, 3, 200, 2)
        cases.append((f"r={r}", [a, ns, np.full((2, 3), r, np.int32)], MAX_SEP))
    a = np.full((2, 8), SENTINEL, np.int32)
    a[0, :3] = [10, 20, 30]
    ns = np.full((2, 2, 8), SENTINEL, np.int32)
    ns[0, 1, :4] = [8, 12, 19, 33]
    cases.append(("empty+sentinel", [a, ns, np.ones((2, 2), np.int32)], 3))
    tie_a = np.array([[100, SENTINEL]], np.int32)
    tie_ns = np.array([[[98, 102]]], np.int32)
    for r in (1, 2):
        cases.append((f"tie r={r}", [tie_a, tie_ns, np.array([[r]], np.int32)], 5))
    return cases


def ladder_case(rng, B, Kn, Ks, L):
    """Top-of-ladder inputs: strictly increasing rows with gaps like a
    frequent lemma's packed postings (1..6 positions), filled to between
    half and all of the bucket, every key and stop active, multiplicities
    mostly 1 as in real queries."""
    from repro_torch.kernels.common import SENTINEL

    def rows(n_rows):
        gaps = rng.integers(1, 7, (n_rows, L), dtype=np.int64)
        vals = np.cumsum(gaps, axis=1) + 1000
        fill = rng.integers(L // 2, L + 1, n_rows)
        vals[np.arange(L)[None, :] >= fill[:, None]] = SENTINEL
        return vals.astype(np.int32)

    a = rows(B)
    ns = rows(B * Kn).reshape(B, Kn, L)
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


def bound(arrays) -> dict:
    """Least time for the join on this card: bytes it must move (each
    input read once — rows of inactive keys and stops excluded, as this
    data needs them not — and each output written once) over the memory
    rate, against its integer operations over the 32-bit rate."""
    from repro_torch.kernels.common import SENTINEL

    a, ns, ns_r = arrays[:3]
    B, Kn, L = ns.shape
    active = int((ns_r > 0).sum())
    nbytes = a.nbytes + active * L * 4 + ns_r.nbytes
    if len(arrays) > 3:
        st_r = arrays[5]
        nbytes += 2 * int((st_r > 0).sum()) * L * 4 + st_r.nbytes
    nbytes += B * L * (1 + 4 + 4)  # valid (bool), lo, hi
    # per (real anchor lane, active key): a binary search of log2(L)
    # compare-and-step pairs, 2*r_max candidate reads and distance tests,
    # and the 2*r_max^2 pairwise comparisons (two ops each) of the rank
    pairs = int(((a != SENTINEL).sum(axis=1) * (ns_r > 0).sum(axis=1)).sum())
    ops = pairs * (2 * np.log2(max(L, 2)) + 4 * R_MAX + 4 * R_MAX ** 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    return {"bytes": int(nbytes), "ops": int(ops), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def kernel_phase(dev) -> dict:
    from repro_torch.kernels.nearest_r import window_join, window_join_plain
    from repro_torch.kernels.nearest_r.ops import launch_kernel

    def on_card(arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    worst = 0
    cases = replay_cases()
    for name, arrays, max_sep in cases:
        ts = on_card(arrays)
        got = window_join(*ts, max_sep=max_sep, r_max=R_MAX)
        want = window_join_plain(*ts, max_sep=max_sep, r_max=R_MAX)
        torch.cuda.synchronize()
        ok, err = compare(got, want)
        if not ok:
            raise AssertionError(f"kernel disagrees with the plain version on {name}")
        worst = max(worst, err)
    log(f"kernel nearest_r.window_join: {len(cases)} replay cases exact")

    shapes = {}
    rng = np.random.default_rng(2024)
    for tag, (B, Kn, Ks, L) in (("qt34", (64, 4, 0, 65536)), ("qt5", (64, 3, 3, 65536))):
        arrays = ladder_case(rng, B, Kn, Ks, L)
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
        ms = median_ms(lambda: launch_kernel(*ts[:3], *stops, *outs,
                                             max_sep=MAX_SEP, r_max=R_MAX))
        wrapper_ms = median_ms(lambda: window_join(*ts, max_sep=MAX_SEP, r_max=R_MAX))
        plain_ms = median_ms(lambda: window_join_plain(*ts, max_sep=MAX_SEP, r_max=R_MAX))
        b = bound(arrays)
        shapes[tag] = {"B": B, "Kn": Kn, "Ks": Ks, "L": L, "ms": ms,
                       "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                       "valid_share": valid_share, **b}
        log(f"kernel nearest_r.window_join {tag} B={B} Kn={Kn} Ks={Ks} L={L}: exact; "
            f"kernel {ms:.4f} ms (wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({b['bytes'] / 1e6:.1f} MB -> {b['bytes_ms'] * 1e3:.1f} us; "
            f"{b['ops'] / 1e9:.2f} Gop -> {b['ops_ms'] * 1e3:.1f} us), "
            f"valid lanes {valid_share:.3f}; library_ms: null")
    return {"max_abs_err": worst, "shapes": shapes}


# -- the serving path ----------------------------------------------------------
def serve_phase(dev) -> dict:
    from repro_torch.core.index_builder import build_index
    from repro_torch.data.corpus import generate_corpus, sample_mixed_queries
    from repro_torch.kernels.nearest_r import window_join
    from repro_torch.serving import SearchService, ServeConfig

    t0 = time.perf_counter()
    table, lex = generate_corpus(N_DOCS, mean_doc_len=160, vocab_size=40_000, seed=1)
    index = build_index(table, lex, max_distance=MAX_SEP)
    queries = sample_mixed_queries(table, lex, N_QUERIES, seed=2)
    log(f"serve: corpus {N_DOCS} docs / {int(table.doc_lengths.sum())} tokens, "
        f"index built, {len(queries)} queries in {time.perf_counter() - t0:.1f} s")

    svc = SearchService(index, ServeConfig(), device=dev)
    window_join.launches = 0
    drains, per_drain = [], {}
    for name in ("cold", "warm"):
        for q in queries:
            svc.submit(q)
        before = window_join.launches
        t = time.perf_counter()
        drains.append(svc.drain())
        per_drain[name] = window_join.launches - before
        log(f"serve: {name} drain on {dev} {time.perf_counter() - t:.3f} s, "
            f"{per_drain[name]} window_join launches")
    launches = window_join.launches

    cpu = SearchService(index, ServeConfig(), device="cpu")
    for q in queries:
        cpu.submit(q)
    t = time.perf_counter()
    want = cpu.drain()
    log(f"serve: reference drain on cpu {time.perf_counter() - t:.3f} s")

    hits = 0
    for drain in drains:
        assert len(drain) == len(want) == len(queries)
        for qi, (g, w) in enumerate(zip(drain, want)):
            for col in ("doc", "start", "end", "score"):
                if not np.array_equal(g.results[col], w.results[col]):
                    raise AssertionError(f"query {qi} {queries[qi]}: {col} differs "
                                         "between the card and the cpu run")
            assert np.isfinite(g.results["score"]).all()
            hits += int(g.results["doc"].size)
    if launches <= 0:
        raise AssertionError("the serve path never launched the nearest_r kernel")
    stats = svc.stats_snapshot()
    routes = stats["plans"]["routes"]
    log(f"serve: records equal the cpu run ({hits} hits over 2 drains); "
        f"window_join launches {launches}; routes {routes}; "
        f"fallbacks {stats['plans']['fallbacks']}")
    # serve.step.* and serve.batch.* hold warm batches only (a shape's
    # first batch is its warm-up); serve.phase.* holds every request
    metrics = {}
    for prefix in ("serve.step.", "serve.batch.", "serve.phase."):
        for name, h in sorted(svc.metrics_snapshot(prefix).items()):
            metrics[name] = {"p50_us": h["p50"], "count": h["count"]}
            log(f"serve: {name} p50 {h['p50']:.1f} us (n={h['count']})")
    return {"launches": launches, "launches_per_drain": per_drain,
            "routes": routes, "hits": hits, "metrics": metrics,
            "executables": {f"{k}/B{b}/L{l}": n
                            for (k, b, l), n in svc.compiled.executables.items()}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", help="also write the full report as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build

    smi = header()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    built = build(["nearest_r"])
    log(f"build: nearest_r.cu in {built['nearest_r']:.1f} s "
        f"(all sources {time.perf_counter() - t0:.1f} s)")
    kern = kernel_phase(dev)
    serve = serve_phase(dev)
    qt5 = kern["shapes"]["qt5"]
    line = {"kernels": [{
        "name": "nearest_r.window_join",
        "route": "cuda",
        "source": "src/repro_torch/csrc/nearest_r.cu",
        "replaces": "src/repro/kernels/nearest_r/nearest_r.py:207",
        "launches": serve["launches"],
        "matches_plain": True,
        "max_abs_err": kern["max_abs_err"],
        "ms": qt5["ms"],
        "plain_ms": qt5["plain_ms"],
        "bound_ms": qt5["bound_ms"],
        "bound_by": qt5["bound_by"],
        "library_ms": None,
        "shape": {k: qt5[k] for k in ("B", "Kn", "Ks", "L")},
        "qt34": {k: kern["shapes"]["qt34"][k]
                 for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
    }]}
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(
            {"nvidia_smi": smi, "build_s": built, "kernel": kern, "serve": serve},
            indent=1, default=float))
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
