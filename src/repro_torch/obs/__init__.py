"""Observability tier: metrics + trace spans for the serving stack
(DESIGN.md §15).

The paper's product is a *response-time guarantee*; this package is how
the reproduction observes whether — and *where* — a budget is spent:

* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` of counters,
  gauges and streaming histograms (p50/p95/p99 over a bounded sample
  ring). Every ``SearchService`` owns one; the service, both executors
  and both packed-row caches record into it (``serve.phase.*``,
  ``serve.step.*``, ``serve.batch.*``, ``serve.step_device.*``,
  ``serve.h2d.*``, ``serve.compile.*``, ``serve.admission.*``,
  ``serve.deadline.*``, ``cache.{pack,compressed}.{derive_us,miss_bytes}``).
* :mod:`repro_torch.obs.trace` — :class:`Tracer` of nested per-drain /
  per-batch spans, each with an id and its parent's, exported as Chrome
  JSON trace format via :func:`chrome_trace` / :func:`write_chrome_trace`
  — loadable in https://ui.perfetto.dev as one span tree per drained
  batch (``SearchService.trace_snapshot()`` / ``write_trace()``,
  ``launch/serve.py --trace-out``) — and mirrored as ``serve:`` ranges
  on a recording ``torch.profiler``'s timeline.

The instruments need numpy (and torch for the profiler ranges) and are
serving-agnostic: they know nothing about query types, so the index
build path or the LM batcher can adopt the same registry later.
"""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import Span, Tracer, chrome_trace, write_chrome_trace  # noqa: F401

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "chrome_trace",
    "write_chrome_trace",
]
