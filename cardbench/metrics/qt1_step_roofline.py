"""qt1_step_roofline: the QT1 step's share of its roofline, in percent: the
bytes each QT1 step in the traced slice must move (``peaks.qt1_step_bytes``
from its B and L-bucket) at 3.35 TB/s, over the device time of every
operation the step launched. The same count whatever kernel does the
work."""

from harness.peaks import qt1_step_bytes, share


def read(run):
    t = run.trace
    if not t or not t["qt1_steps"]:
        return None
    seconds = sum(s for *_, s in t["qt1_steps"])
    if seconds <= 0:
        return None
    moved = [qt1_step_bytes(B, L, run.top_k) for B, L, _ in t["qt1_steps"]]
    return share(sum(r for r, _ in moved), sum(w for _, w in moved), seconds)
