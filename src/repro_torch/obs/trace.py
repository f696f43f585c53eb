"""Per-request / per-batch trace spans with Chrome-trace (Perfetto)
export (DESIGN.md §15).

A :class:`Tracer` records *complete spans*: named intervals with a
start timestamp, a duration, a thread id, a depth, and free-form args.
Spans nest via a per-thread stack — ``with tracer.span("drain"):``
makes every span opened inside it a child — so one
``SearchService.drain()`` produces one span tree per drained batch:

    drain
    ├─ plan
    ├─ group
    └─ batch(qt1, B=16, L=1024)
       ├─ pack
       ├─ compress
       ├─ dispatch
       ├─ execute          (args: compile=True on the first (kind,B,L))
       └─ decode

Timestamps come from ``time.perf_counter()`` rebased to the tracer's
creation (so they are small, strictly monotonic per thread, and share
one epoch across threads). :func:`chrome_trace` renders the buffer as
Chrome JSON trace format — ``{"traceEvents": [{"ph": "X", ...}]}`` with
microsecond ``ts``/``dur`` — which https://ui.perfetto.dev and
``chrome://tracing`` both load directly; nesting is expressed by time
containment per track, which is exactly the invariant the span stack
enforces (tests/test_obs.py pins it).

The buffer is a bounded ring (default 8192 completed spans, oldest
evicted first) so a long-lived service cannot grow without bound;
``enabled=False`` turns ``span()`` into a no-op context manager whose
overhead is one attribute read.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from collections import deque
from dataclasses import dataclass, field

__all__ = ["Span", "Tracer", "chrome_trace", "write_chrome_trace"]


@dataclass
class Span:
    """One completed interval. ``ts``/``dur`` are seconds relative to
    the tracer's epoch; ``tid`` the recording thread's ident; ``depth``
    the nesting level at record time (0 = root); ``args`` free-form
    metadata rendered into the Chrome trace ``args`` field."""

    name: str
    cat: str
    ts: float
    dur: float
    tid: int
    depth: int = 0
    args: dict = field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.ts + self.dur


class _NullSpan:
    """The disabled-tracer span handle: accepts arg updates, keeps
    nothing."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Handle yielded by :meth:`Tracer.span` while the span is open —
    lets the body attach args discovered mid-span (e.g. the payload
    kind a compressed pack settled on)."""

    __slots__ = ("args",)

    def __init__(self, args: dict):
        self.args = args

    def set(self, **kw) -> None:
        self.args.update(kw)


class Tracer:
    """Bounded recorder of nested spans; thread-safe, one per service."""

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self.epoch = time.perf_counter()
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._dropped = 0

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, cat: str = "serve", **args):
        """Record ``name`` over the ``with`` body. Exceptions propagate;
        the span is still recorded (with ``error=True``) so a trace of
        a failing drain shows where it died."""
        if not self.enabled:
            yield _NULL_SPAN
            return
        stack = self._stack()
        depth = len(stack)
        live = _LiveSpan(dict(args))
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield live
        except BaseException:
            live.args["error"] = True
            raise
        finally:
            t1 = time.perf_counter()
            stack.pop()
            sp = Span(name=name, cat=cat, ts=t0 - self.epoch, dur=t1 - t0,
                      tid=threading.get_ident(), depth=depth, args=live.args)
            with self._lock:
                if len(self._spans) == self.capacity:
                    self._dropped += 1
                self._spans.append(sp)

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> list[Span]:
        """Completed spans, oldest first, ordered by start timestamp
        (record order is *end* order — a parent records after its
        children — so export re-sorts by ``ts``)."""
        with self._lock:
            spans = list(self._spans)
        return sorted(spans, key=lambda s: (s.ts, -s.dur))

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0


def chrome_trace(spans: list[Span], process_name: str = "repro_torch.serving") -> dict:
    """Render completed spans as a Chrome JSON trace object.

    Complete events (``ph: "X"``) with integer-microsecond ``ts`` and
    ``dur``, one track per recording thread; Perfetto nests events on a
    track by time containment. Metadata events name the process and
    threads so the UI shows something better than bare ids."""
    events = []
    tids = []
    for sp in sorted(spans, key=lambda s: (s.ts, -s.dur)):
        if sp.tid not in tids:
            tids.append(sp.tid)
        events.append({
            "name": sp.name, "cat": sp.cat, "ph": "X",
            "ts": round(sp.ts * 1e6, 3), "dur": round(sp.dur * 1e6, 3),
            "pid": 0, "tid": tids.index(sp.tid),
            "args": {k: _jsonable(v) for k, v in sp.args.items()},
        })
    meta = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": process_name},
    }]
    meta += [{
        "name": "thread_name", "ph": "M", "pid": 0, "tid": i,
        "args": {"name": f"serve-thread-{i}"},
    } for i in range(len(tids))]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def write_chrome_trace(path: str, spans: list[Span], **kw) -> dict:
    """Write :func:`chrome_trace` JSON to ``path``; returns the object
    (callers report event counts)."""
    obj = chrome_trace(spans, **kw)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return obj
