"""Replay one benchmark cell's stream through fresh services and read the
serving path's own instruments, per batch and per query.

    python tools/serve_probe.py --workload d9-mixed-c128 --seed 7 --queries 8192 \
        --variants on,off [--src DIR] [--index DIR] [--n-docs N] [--platform cpu]

Builds the cell's corpus and stream from ``--seed`` as ``cardbench/run.py``
does (``--n-docs`` cuts the corpus for a CPU try), and its index, or loads
the one saved at ``--index`` (saving it there first if it is missing), so
that processes running different trees serve the same index. Then, for each
variant in turn, a fresh ``SearchService`` with the tracer ``on`` or
``off`` is warmed as the cell warms it, serves the mix's
``served_in_setup`` prefix, and replays the stream's next ``--queries``
queries in the cell's closed-loop turns (``clients`` submits, then
``drain()``). Every variant serves the same queries in the same turns, so
two trees or two variants do the same work and differ only in what the
code costs. ``--src`` puts another tree's package first on the path (the
parent's, to compare two commits on one machine).

Prints one JSON line a variant: ``qps`` (queries over the replay's wall
time), ``cpu_s`` (the process's CPU time over it), an ``answers`` digest of
every response's records (equal across trees that answer alike), and, from
the registry's counters and the sums and counts of its histograms over the
replay: ``host_ms_per_batch`` and ``step_ms_per_batch`` (as the benchmark
reads them), ``derive_ms_per_batch`` (``cache.pack.derive_us``),
``miss_mb_per_batch`` (``cache.pack.miss_bytes``), ``h2d_ms_per_batch``
(``serve.h2d.<family>``), ``h2d_mb_per_batch`` (``serve.h2d.bytes``),
``step_device_ms_per_batch`` (``serve.step_device.*``), ``plan_us_per_query``
(``serve.phase.plan``), ``queue_ms`` (``serve.phase.queue``),
``scalar_ms_per_query`` (``serve.step.scalar``), and the span ring's
``spans_per_s`` and ``dropped``. A reading the tree lacks the instrument for
is null.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "cardbench"


def sums(service) -> dict:
    """Counters as they are; each histogram's (count, sum)."""
    out = {}
    for name, v in service.metrics_snapshot().items():
        out[name] = (v["count"], v["sum"]) if isinstance(v, dict) else v
    return out


def over(after: dict, before: dict, prefix: str, skip=lambda name: False):
    """(count, sum) of the histograms under ``prefix`` over the replay."""
    n = s = 0.0
    for name, v in after.items():
        if name.startswith(prefix) and isinstance(v, tuple) and not skip(name):
            b = before.get(name, (0, 0.0))
            n += v[0] - b[0]
            s += v[1] - b[1]
    return n, s


def readings(after: dict, before: dict, spans: int, dropped: int, wall: float) -> dict:
    def ratio(num, den, scale=1.0):
        return num * scale / den if den else None

    not_scalar = lambda name: name.endswith(".scalar")  # noqa: E731
    nb, sb = over(after, before, "serve.batch.", not_scalar)
    ns, ss = over(after, before, "serve.step.", not_scalar)

    def sum_of(prefix):  # None where the tree has no such instrument
        if not any(name.startswith(prefix) for name in after):
            return None
        return over(after, before, prefix)[1]

    def count_of(name):
        v = after.get(name)
        return None if v is None else v - before.get(name, 0)

    derive = sum_of("cache.pack.derive_us")
    miss = count_of("cache.pack.miss_bytes")
    h2d = sum_of("serve.h2d.")
    h2d_bytes = count_of("serve.h2d.bytes")
    dev_n, dev_s = over(after, before, "serve.step_device.")
    plan_n, plan_s = over(after, before, "serve.phase.plan")
    queue_n, queue_s = over(after, before, "serve.phase.queue")
    sc_n, sc_s = over(after, before, "serve.step.scalar")
    return {
        "batches": nb,
        "host_ms_per_batch": ratio(sb - ss, nb, 1e-3),
        "step_ms_per_batch": ratio(ss, ns, 1e-3),
        "derive_ms_per_batch": None if derive is None else ratio(derive, nb, 1e-3),
        "miss_mb_per_batch": None if miss is None else ratio(miss, nb, 1e-6),
        "h2d_ms_per_batch": None if h2d is None else ratio(h2d, nb, 1e-3),
        "h2d_mb_per_batch": None if h2d_bytes is None else ratio(h2d_bytes, nb, 1e-6),
        "step_device_ms_per_batch": ratio(dev_s, dev_n, 1e-3),
        "plan_us_per_query": ratio(plan_s, plan_n),
        "queue_ms": ratio(queue_s, queue_n, 1e-3),
        "scalar_ms_per_query": ratio(sc_s, sc_n, 1e-3),
        "spans_per_s": spans / wall,
        "dropped": dropped,
    }


def replay(service, stream, clients: int, deadline_s: float, n: int):
    """The closed loop's turns over ``n`` queries; returns the responses."""
    tickets = []
    sent = 0
    while sent < n:
        turn = [service.submit(stream.next(), deadline_s=deadline_s)
                for _ in range(min(clients, n - sent))]
        service.drain()
        tickets += turn
        sent += len(turn)
    return [t.response for t in tickets]


def digest(responses) -> str:
    h = hashlib.sha256()
    for r in responses:
        if r is None:
            h.update(b"unanswered")
            continue
        for key in ("doc", "start", "end", "score"):
            h.update(r.results[key].tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--queries", type=int, required=True)
    ap.add_argument("--variants", default="on", help="the tracer per replay, e.g. on,off")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--index", help="a saved index to load, or to save if missing")
    ap.add_argument("--n-docs", type=int)
    ap.add_argument("--platform", default="cuda")
    args = ap.parse_args()
    for p in (str(BENCH), str(Path(args.src).resolve())):
        sys.path.insert(0, p)
    from harness import cell, sut, traffic
    from harness.window import serve_prefix
    from repro_torch.index.persist import load_index, save_index

    bench = cell.Bench(ROOT)
    spec = bench.cell(args.workload)
    config = bench.config(spec["config"])
    if args.n_docs:
        config["n_docs"] = args.n_docs
    mix = bench.traffic(spec["traffic"])
    clients, deadline_s = int(mix["clients"]), float(mix["deadline_s"])
    t = time.perf_counter()
    corpus, _ = cell.inputs(config, mix, args.seed)
    if args.index and (Path(args.index) / "meta.json").exists():
        index = load_index(args.index)
    else:
        index = sut.build_index(corpus, int(config["max_distance"]))
        if args.index:
            save_index(index, args.index)
    print(f"index {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    for variant in args.variants.split(","):
        stream = traffic.Stream(corpus, mix, cell.seeds(args.seed)[1])
        serve = dict(config["serve"], trace_enabled=variant == "on")
        service = sut.make_service(index, serve, args.platform)
        t = time.perf_counter()
        sut.warm(service, stream.queries)
        serve_prefix(service, stream, clients, deadline_s, int(mix.get("served_in_setup", 0)))
        setup = time.perf_counter() - t
        gc.collect()
        gc.freeze()
        before, spans0 = sums(service), len(service.tracer.snapshot())
        c0, t0 = time.process_time(), time.perf_counter()
        responses = replay(service, stream, clients, deadline_s, args.queries)
        wall, cpu = time.perf_counter() - t0, time.process_time() - c0
        after = sums(service)
        spans = len(service.tracer.snapshot()) - spans0 + service.tracer.dropped
        line = {"variant": variant, "src": args.src, "seed": args.seed, "queries": args.queries,
                "setup_s": setup, "qps": args.queries / wall, "cpu_s": cpu,
                "answers": digest(responses),
                **readings(after, before, spans, service.tracer.dropped, wall)}
        print(json.dumps(line), flush=True)
        gc.unfreeze()
        del service, responses
        gc.collect()


if __name__ == "__main__":
    main()
