"""The device trace of a traced run: ``torch.profiler`` over a slice of the
window, read back from its Chrome trace.

The program's spans (drain, plan, group, batch, pack, dispatch, execute,
decode, ...) reach the profiler's timeline as ``cardbench:<span>`` ranges
(``harness.sut.annotated``). From the trace this module takes:

* the slice's length and the seconds in which a kernel, copy or memset
  ran on the card (their union);
* the idle time, cut into gaps, each named by the innermost program span
  the host was in at the gap's middle (``harness`` where it was in none:
  the benchmark's own loop);
* device time by operation name;
* the window-join kernel's launches and device time;
* per QT1 step (a ``dispatch`` of a qt1 kind), the device time of every
  operation it launched, with the step's (B, L) from its batch span.
"""

from __future__ import annotations

import bisect
import json
import os
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SLICE = "cardbench:slice"
QT1_KINDS = ("base", "delta", "offsets")
WINDOW_JOIN = "window_join_kernel"


class Slice:
    """A profiled stretch of the window; ``stop`` returns its summary."""

    def __init__(self, path: Path):
        self.path = Path(path)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()

    def stop(self) -> dict | None:
        import torch

        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        del self._prof
        try:
            with open(self.path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(self.path)
        return summarize(events)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class _Spans:
    """Program spans of one thread (nested or disjoint), for "which span was
    the host in at time t"."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent, stack = [], []
        for i, (ts, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < ts:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: float) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return i

    def name_at(self, t: float) -> str:
        i = self.innermost(t)
        return self.spans[i][2] if i >= 0 else "harness"

    def enclosing(self, i: int, prefix: str) -> str | None:
        while i >= 0:
            if self.spans[i][2].startswith(prefix):
                return self.spans[i][2]
            i = self.parent[i]
        return None


def summarize(events: list, top: int = 10) -> dict | None:
    """The slice's device activity (times in seconds); None without a
    slice range in the trace."""
    X = [e for e in events if e.get("ph") == "X" and "ts" in e]
    marks = [e for e in X if e.get("name") == SLICE and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0].get("dur", 0.0))
    spans, runtime, device = [], {}, []
    for e in X:
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"].startswith("cardbench:") and e["name"] != SLICE:
            spans.append((ts, ts + dur, e["name"][len("cardbench:"):]))
        elif cat in RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                runtime[corr] = ts
        elif cat in DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b > a:
                device.append((a, b, e.get("name", cat), (e.get("args") or {}).get("correlation"),
                               ts, dur))
    busy = _union([(a, b) for a, b, *_ in device])
    busy_us = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    tree = _Spans(spans)
    idle: dict[str, float] = {}
    for a, b in gaps:
        name = tree.name_at((a + b) / 2)
        idle[name] = idle.get(name, 0.0) + (b - a)
    ops: dict[str, float] = {}
    wj_n, wj_us = 0, 0.0
    for a, b, name, *_ in device:
        ops[name] = ops.get(name, 0.0) + (b - a)
        if WINDOW_JOIN in name:
            wj_n += 1
            wj_us += b - a
    # per QT1 step: the device time of what its dispatch launched
    dispatch = [i for i, (_, _, name) in enumerate(tree.spans)
                if name.startswith("dispatch:") and name.split(":", 1)[1] in QT1_KINDS]
    starts = [tree.spans[i][0] for i in dispatch]
    step_us = [0.0] * len(dispatch)
    for *_, corr, ts, dur in device:
        t_launch = runtime.get(corr)
        if t_launch is None:
            continue
        j = bisect.bisect_right(starts, t_launch) - 1
        if j >= 0 and t_launch <= tree.spans[dispatch[j]][1]:
            step_us[j] += dur
    steps = []
    for i, us in zip(dispatch, step_us):
        owner = tree.enclosing(i, "batch:qt1:")
        if us > 0 and owner is not None:
            _, _, b_part, l_part = owner.split(":")
            steps.append([int(b_part[1:]), int(l_part[1:]), us * 1e-6])
    by = lambda kv: -kv[1]  # noqa: E731
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "idle_gaps": [[k, v * 1e-6] for k, v in sorted(idle.items(), key=by)[:top]],
        "device_ops": [[k[:160], v * 1e-6] for k, v in sorted(ops.items(), key=by)[:top]],
        "window_join": {"launches": wj_n, "s": wj_us * 1e-6},
        "qt1_steps": steps,
    }
