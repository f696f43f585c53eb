"""What the serving tracer costs a warm batch: its spans, and the CUDA
events that time a sample of the steps on the card.

    python tools/trace_cost.py [--device cuda|cpu] [--passes 20] [--step-event-every N]

Builds a small index (400 documents of ~400 positions, MaxDistance 5) and
one service, serves 1,024 QT1 queries twice so that every shape is warm and
every row cached, then serves them again ``--passes`` times under each of
three variants, in ABBA turns: the tracer off, on, and on with the step's
events not recorded. ``--step-event-every`` sets how many warm steps go
to one timed by the events (``CompiledExecutor.step_event_every``; 1
times every step). Prints one JSON line: for each variant the medians of
the step's host time per batch (``serve.step.*``, dispatch to synchronise,
where the events are recorded), of the whole batch (``serve.batch.*``) and
of a pass's wall time; on a card also the host time of one
``_record_events`` call, of one ``Event.elapsed_time`` and of one
``torch.cuda.current_stream``.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.index_builder import build_index  # noqa: E402
from repro_torch.data.corpus import generate_corpus, sample_typed_queries  # noqa: E402
from repro_torch.serving import SearchService, ServeConfig, executors  # noqa: E402

VARIANTS = ("off", "on", "on_noevents")


def per_batch(svc, prefix: str) -> tuple[float, float]:
    """(count, sum in µs) of the compiled families' histograms."""
    n = s = 0.0
    for name, h in svc.metrics_snapshot(prefix).items():
        if not name.endswith(".scalar"):
            n += h["count"]
            s += h["sum"]
    return n, s


def host_us(fn, n: int = 10_000) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--passes", type=int, default=20)
    ap.add_argument("--step-event-every", type=int)
    args = ap.parse_args()
    if args.step_event_every:
        executors.CompiledExecutor.step_event_every = args.step_event_every
    table, lex = generate_corpus(n_docs=400, mean_doc_len=400, vocab_size=3000, seed=3)
    lex.sw_count, lex.fu_count = 50, 150
    index = build_index(table, lex, max_distance=5)
    queries = sample_typed_queries(table, lex, 1024, "qt1", window=5, seed=6)
    svc = SearchService(index, ServeConfig(buckets=(1024, 4096, 16384), max_batch=64,
                                           top_k=16), device=args.device)

    def serve_all():
        for lo in range(0, len(queries), 64):
            for q in queries[lo:lo + 64]:
                svc.submit(q)
            svc.drain()

    serve_all()
    serve_all()
    record = executors._record_events
    readings = {v: [] for v in VARIANTS}
    for _ in range(args.passes):
        for v in VARIANTS + VARIANTS[::-1]:
            svc.tracer.enabled = v != "off"
            executors._record_events = (lambda devices, events: None) if v == "on_noevents" \
                else record
            step0, batch0 = per_batch(svc, "serve.step."), per_batch(svc, "serve.batch.")
            t0 = time.perf_counter()
            serve_all()
            wall = time.perf_counter() - t0
            step1, batch1 = per_batch(svc, "serve.step."), per_batch(svc, "serve.batch.")
            readings[v].append(((step1[1] - step0[1]) / (step1[0] - step0[0]),
                                (batch1[1] - batch0[1]) / (batch1[0] - batch0[0]), wall))
    executors._record_events = record
    out = {v: {"step_us": statistics.median(r[0] for r in rs),
               "batch_us": statistics.median(r[1] for r in rs),
               "pass_s": statistics.median(r[2] for r in rs), "passes": len(rs)}
           for v, rs in readings.items()}
    out["batches_a_pass"] = -(-len(queries) // 64)
    out["step_event_every"] = executors.CompiledExecutor.step_event_every
    if args.device == "cuda":
        cards = svc.compiled._cards
        starts = [torch.cuda.Event(enable_timing=True) for _ in cards]
        ends = [torch.cuda.Event(enable_timing=True) for _ in cards]
        out["record_events_us"] = host_us(lambda: record(cards, starts))
        record(cards, ends)
        torch.cuda.synchronize()
        out["elapsed_time_us"] = host_us(lambda: starts[0].elapsed_time(ends[0]))
        out["current_stream_us"] = host_us(lambda: torch.cuda.current_stream(cards[0]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
