"""Low-overhead metrics registry: counters, gauges, streaming
histograms (DESIGN.md §15).

One :class:`MetricsRegistry` instance lives on each
``repro_torch.serving.service.SearchService`` and is shared by every layer of
the serving tier: the service records per-phase request latencies, the
executors record per-(step_family, B, L) measured step costs and
compile times, and the packed-posting caches record hit/miss counts and
derivation timings. Names are dotted strings (``serve.phase.pack``,
``serve.step.qt1.B16.L1024``); the registry is the single
source the phase rows of BENCH_serve.json, ``stats_snapshot()`` and
``explain(costs=True)`` all read from.

Design constraints (the overhead budget of §15):

* ``observe()``/``inc()`` on the hot path are a dict lookup plus a few
  float ops under a per-instrument lock — no allocation after the
  first observation of a name;
* histograms keep a bounded sample ring (default 4096); percentiles
  are computed only at snapshot time (numpy quantile over the resident
  samples), never on the record path;
* ``snapshot()`` returns plain dicts/floats only — safe to json-dump,
  deep-copy free of live references, and consistent per instrument
  (each instrument is snapshotted under its own lock).
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic counter. ``inc`` is the only mutator."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins scalar (queue depth, resident cache bytes)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value


class Histogram:
    """Streaming histogram: exact count/sum/min/max plus a bounded
    sample ring for percentiles.

    The ring keeps the *last* ``capacity`` observations (overwrite in
    arrival order), so percentiles reflect recent behaviour — the right
    bias for serving telemetry, where an old compile-time outlier must
    not dominate p99 forever. While fewer than ``capacity`` samples
    have been observed the percentiles are exact (tests pin them
    against ``np.quantile`` directly)."""

    __slots__ = ("name", "capacity", "_ring", "_n_seen", "_sum", "_min",
                 "_max", "_lock")

    def __init__(self, name: str, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self.capacity = capacity
        self._ring = np.empty(capacity, np.float64)
        self._n_seen = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._ring[self._n_seen % self.capacity] = v
            self._n_seen += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._n_seen

    def _samples(self) -> np.ndarray:
        n = min(self._n_seen, self.capacity)
        return self._ring[:n]

    def percentile(self, q: float) -> float:
        """q in [0, 100], linear interpolation — bit-identical to
        ``np.percentile`` over the resident samples."""
        with self._lock:
            s = self._samples()
            if s.size == 0:
                return float("nan")
            return float(np.percentile(s, q))

    def snapshot(self) -> dict:
        with self._lock:
            s = self._samples().copy()
            n, total = self._n_seen, self._sum
        if s.size == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        p50, p95, p99 = (float(x) for x in np.percentile(s, (50, 95, 99)))
        return {
            "count": n, "sum": total, "mean": total / n,
            "min": self._min, "max": self._max,
            "p50": p50, "p95": p95, "p99": p99,
        }


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    A name is permanently bound to the first instrument kind created
    under it (creating ``counter("x")`` then ``histogram("x")``
    raises): mixed-type metrics are always a bug, and catching it at
    the registration site beats a corrupt snapshot later."""

    def __init__(self, histogram_capacity: int = 4096):
        self.histogram_capacity = histogram_capacity
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, **kw)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} is a {type(inst).__name__}, "
                f"not a {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, capacity: int | None = None) -> Histogram:
        cap = capacity if capacity is not None else self.histogram_capacity
        return self._get(name, Histogram, capacity=cap)

    # -- hot-path shorthands ----------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # -- introspection -----------------------------------------------------
    def names(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(n for n in self._instruments if n.startswith(prefix))

    def get(self, name: str):
        return self._instruments.get(name)

    def snapshot(self, prefix: str = "") -> dict:
        """``{name: value-or-histogram-dict}`` for every instrument under
        ``prefix``. Plain data only — json-dumpable, no live references;
        per-instrument consistency (each snapshotted under its lock)."""
        with self._lock:
            items = [(n, i) for n, i in self._instruments.items()
                     if n.startswith(prefix)]
        return {n: inst.snapshot() for n, inst in sorted(items)}
