"""Serving launcher: builds a proximity index and serves batched QT1
requests through the deadline-aware `SearchService` on a (1, 1) mesh of
one device (thin CLI over serving/service.py). The card is the default;
``--device cpu`` runs the plain PyTorch path on the host.

  PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 3000 --requests 512 --deadline-ms 50

With ``--load-qps`` the launcher replays an open-loop Poisson trace
instead of one closed batch, and ``--admission`` turns on the §17
deadline control loop (admission verdicts, shedding, EDF splits):

  PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 3000 \
      --deadline-ms 50 --admission --load-qps 2000

``--config`` loads a tuned (MaxDistance, ServeConfig) artifact emitted by
the §19 autotuner (``repro_torch.tune.report``, or the JAX package's);
explicit ``--deadline-ms`` / ``--admission`` flags still overlay the
loaded config:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --config results/tuned_serve_config.json
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from repro_torch.core.index_builder import build_index
from repro_torch.data.corpus import generate_corpus, sample_stop_queries
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving import (
    SearchService,
    ServeConfig,
    poisson_arrivals,
    run_open_loop,
    warm_service,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=3000)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--max-distance", type=int, default=5)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="load a tuned (MaxDistance, ServeConfig) JSON "
                         "artifact (repro_torch.tune.report); overrides "
                         "--max-distance/--max-batch/--top-k, while "
                         "explicit --deadline-ms/--admission still apply")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on: cuda (the default; fails without "
                         "a card) or cpu")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request budget; responses report deadline_met "
                         "(<= 0 disables deadlines)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the drain's span tree as Chrome JSON trace "
                         "format (load in https://ui.perfetto.dev)")
    ap.add_argument("--admission", action="store_true",
                    help="enable the §17 deadline control loop (admission "
                         "verdicts, load shedding, EDF splits); requires "
                         "--deadline-ms to have any effect")
    ap.add_argument("--load-qps", type=float, default=None, metavar="QPS",
                    help="replay an open-loop Poisson trace at QPS instead "
                         "of one closed batch (repro_torch.serving.load); "
                         "reports met/shed/reject rates")
    ap.add_argument("--load-duration-s", type=float, default=2.0,
                    help="open-loop trace length (with --load-qps)")
    return ap


def resolve_config(args) -> tuple[int, ServeConfig]:
    """(max_distance, ServeConfig) from flags, or from a tuned artifact
    with explicit deadline/admission flags overlaid on top."""
    deadline_on = args.deadline_ms is not None and args.deadline_ms > 0
    if args.config is not None:
        from repro_torch.tune.report import load_serve_config

        max_distance, cfg, meta = load_serve_config(args.config)
        overlay: dict = {}
        if args.deadline_ms is not None:
            overlay["default_deadline_s"] = (
                args.deadline_ms / 1e3 if deadline_on else None)
        if args.admission:
            overlay["admission"] = True
            if cfg.max_queue is None:
                overlay["max_queue"] = 4 * cfg.max_batch
        if overlay:
            cfg = dataclasses.replace(cfg, **overlay)
        origin = meta.get("workload", meta.get("bench", "sweep"))
        dropped = meta.get("dropped_fields")
        print(f"loaded tuned config from {args.config} "
              f"(max_distance={max_distance}, tuned on {origin!r}"
              + (f", dropped {sorted(dropped)}" if dropped else "") + ")",
              file=sys.stderr)
        return max_distance, cfg
    cfg = ServeConfig(
        max_batch=args.max_batch, top_k=args.top_k,
        default_deadline_s=args.deadline_ms / 1e3 if deadline_on else None,
        admission=args.admission,
        max_queue=4 * args.max_batch if args.admission else None,
    )
    return args.max_distance, cfg


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)

    table, lex = generate_corpus(args.n_docs, mean_doc_len=160, vocab_size=40_000, seed=1)
    max_distance, cfg = resolve_config(args)
    index = build_index(table, lex, max_distance=max_distance)
    deadline_on = args.deadline_ms is not None and args.deadline_ms > 0
    mesh = make_mesh((1, 1), ("data", "model"),
                     devices=[resolve_device(args.device)])
    service = SearchService(index, cfg, mesh=mesh)
    queries = sample_stop_queries(table, lex, args.requests, window=3, seed=2)

    if args.load_qps is not None:
        warm_service(service, queries)
        arrivals = poisson_arrivals(args.load_qps, args.load_duration_s, seed=2)
        rep = run_open_loop(
            service, queries, arrivals,
            deadline_s=(args.deadline_ms / 1e3 if deadline_on
                        else cfg.default_deadline_s or 0.05),
            offered_qps=len(arrivals) / args.load_duration_s,
        )
        print(f"open loop: offered {rep.offered_qps:.0f} qps for "
              f"{args.load_duration_s:.1f}s -> served {rep.n_served}/"
              f"{rep.n_offered} (goodput {rep.achieved_qps:.0f} qps); "
              f"met={rep.met_rate:.3f} shed={rep.shed_rate:.3f} "
              f"reject={rep.reject_rate:.3f}")
        stats = service.stats_snapshot()
        if cfg.admission:
            print(f"admission: {stats['admission']}")
        if args.trace_out:
            trace = service.write_trace(args.trace_out)
            print(f"wrote {len(trace['traceEvents'])} trace events to "
                  f"{args.trace_out} (open in https://ui.perfetto.dev)")
        return

    for q in queries:
        service.submit(q)
    t0 = time.time()
    responses = service.drain()
    wall = time.time() - t0
    lat = np.array([r.latency_s for r in responses])
    stats = service.stats_snapshot()
    print(
        f"served {len(responses)} requests in {wall:.2f}s ({len(responses)/wall:.1f} qps); "
        f"batch p50={np.percentile(lat, 50)*1e3:.1f}ms p99={np.percentile(lat, 99)*1e3:.1f}ms; "
        f"buckets={stats['bucket_hist']}"
    )
    phase = service.metrics_snapshot("serve.phase.")
    breakdown = "  ".join(
        f"{name.rsplit('.', 1)[-1]}={h['p50']/1e3:.2f}ms"
        for name, h in phase.items() if h["count"]
    )
    print(f"phase p50: {breakdown}")
    if deadline_on:
        met = sum(1 for r in responses if r.deadline_met)
        print(f"deadline {args.deadline_ms:.0f}ms: met {met}/{len(responses)} "
              f"({met/len(responses):.1%}); miss blame: "
              f"{stats['deadlines']['miss_blame']}")
    if args.trace_out:
        trace = service.write_trace(args.trace_out)
        print(f"wrote {len(trace['traceEvents'])} trace events to "
              f"{args.trace_out} (open in https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
