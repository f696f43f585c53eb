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

Every span carries an ``id`` (numbered from 1 as spans open) and the
``parent`` id of the span open around it on its thread (0 at a root),
so a trace reads as a tree without relying on time containment; the
service adds request ids to its spans' args (``requests`` on a batch,
``request`` on an admission decision). While a ``torch.profiler``
session records, each span is also a ``record_function`` range named
``serve:<name>`` (``serve:<name>:<kind>`` for a span with a ``kind``,
``serve:batch:<family>:B<B>:L<L>`` for a batch), so every stretch of the
profiler's timeline falls under a program span; when none records, the
cost is one check a span.

The buffer is a bounded ring (oldest evicted first, ``dropped`` counts
the evictions) so a long-lived service cannot grow without bound;
``enabled=False`` turns ``span()`` into a no-op context manager whose
overhead is one attribute read.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import torch
from torch.autograd import _profiler_enabled

__all__ = ["Span", "Tracer", "chrome_trace", "write_chrome_trace"]


@dataclass
class Span:
    """One completed interval. ``ts``/``dur`` are seconds relative to
    the tracer's epoch; ``tid`` the recording thread's ident; ``depth``
    the nesting level at record time (0 = root); ``args`` free-form
    metadata rendered into the Chrome trace ``args`` field; ``id`` the
    span's number and ``parent`` that of the span open around it on the
    same thread (0 at a root)."""

    name: str
    cat: str
    ts: float
    dur: float
    tid: int
    depth: int = 0
    args: dict = field(default_factory=dict)
    id: int = 0
    parent: int = 0

    @property
    def end(self) -> float:
        return self.ts + self.dur


class _NullSpan:
    """The disabled-tracer span: a context manager that accepts arg
    updates and keeps nothing; its ``id`` is 0."""

    __slots__ = ()
    id = 0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **kw) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """An open span, the context manager :meth:`Tracer.span` returns: it
    is numbered and pushed on its thread's stack on entry and recorded on
    exit, and lets the body attach args discovered mid-span (e.g. the
    payload kind a compressed pack settled on)."""

    __slots__ = ("tracer", "name", "cat", "args", "id", "parent", "depth",
                 "range", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **kw) -> None:
        self.args.update(kw)

    def __enter__(self):
        stack = self.tracer._stack()
        self.depth = len(stack)
        self.parent = stack[-1] if stack else 0
        self.id = next(self.tracer._ids)
        stack.append(self.id)
        self.range = None
        if _profiler_enabled():
            self.range = torch.profiler.record_function(_range_label(self.name, self.args))
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if exc_type is not None:
            self.args["error"] = True
        if self.range is not None:
            self.range.__exit__(None, None, None)
        tracer = self.tracer
        tracer._stack().pop()
        # the ring holds Span's fields as a tuple; snapshot() builds Spans
        sp = (self.name, self.cat, self.t0 - tracer.epoch, t1 - self.t0,
              threading.get_ident(), self.depth, self.args, self.id, self.parent)
        with tracer._lock:
            if len(tracer._spans) == tracer.capacity:
                tracer._dropped += 1
            tracer._spans.append(sp)
        return False


class Tracer:
    """Bounded recorder of nested spans; thread-safe, one per service."""

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self.epoch = time.perf_counter()
        self._spans: deque[tuple] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._dropped = 0
        self._ids = itertools.count(1)

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, cat: str = "serve", **args):
        """A context manager that records ``name`` over the ``with``
        body. Exceptions propagate; the span is still recorded (with
        ``error=True``) so a trace of a failing drain shows where it
        died. Disabled, it is a shared no-op."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, cat, args)

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> list[Span]:
        """Completed spans, oldest first, ordered by start timestamp
        (record order is *end* order — a parent records after its
        children — so export re-sorts by ``ts``)."""
        with self._lock:
            spans = [Span(*sp) for sp in self._spans]
        return sorted(spans, key=lambda s: (s.ts, -s.dur))

    @property
    def dropped(self) -> int:
        """Completed spans evicted from the full ring."""
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0


def _range_label(name: str, args: dict) -> str:
    """The profiler range of a span: ``serve:<name>``, with the batch's
    family and shape or the span's kind after it."""
    if name == "batch":
        return f"serve:batch:{args.get('family')}:B{args.get('B')}:L{args.get('bucket')}"
    if "kind" in args:
        return f"serve:{name}:{args['kind']}"
    return f"serve:{name}"


def chrome_trace(spans: list[Span], process_name: str = "repro_torch.serving") -> dict:
    """Render completed spans as a Chrome JSON trace object.

    Complete events (``ph: "X"``) with integer-microsecond ``ts`` and
    ``dur``, one track per recording thread; Perfetto nests events on a
    track by time containment. Metadata events name the process and
    threads so the UI shows something better than bare ids. Each
    event's ``args`` carry the span's ``id`` and ``parent``."""
    events = []
    tids = []
    for sp in sorted(spans, key=lambda s: (s.ts, -s.dur)):
        if sp.tid not in tids:
            tids.append(sp.tid)
        events.append({
            "name": sp.name, "cat": sp.cat, "ph": "X",
            "ts": round(sp.ts * 1e6, 3), "dur": round(sp.dur * 1e6, 3),
            "pid": 0, "tid": tids.index(sp.tid),
            "args": {**{k: _jsonable(v) for k, v in sp.args.items()},
                     "id": sp.id, "parent": sp.parent},
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
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


def write_chrome_trace(path: str, spans: list[Span], **kw) -> dict:
    """Write :func:`chrome_trace` JSON to ``path``; returns the object
    (callers report event counts)."""
    obj = chrome_trace(spans, **kw)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return obj
