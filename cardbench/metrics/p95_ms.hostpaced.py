"""p95_ms.hostpaced: the 95th-percentile latency, submit to reply, of the
requests sent before the traced slice began (those of the slice run under
the profiler), where the host alone paces it (the card idle for more than
half of the traced slice); the same arithmetic as p95_ms, reported in the
traced run. A failed request counts as missing every limit."""

import numpy as np


def read(run):
    lat = run.window.untraced_latencies()
    if lat.size == 0:
        return None
    value = float(np.percentile(lat, 95))
    return value * 1e3 if np.isfinite(value) else None
