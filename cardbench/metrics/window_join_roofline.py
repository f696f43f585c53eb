"""window_join_roofline: the window-join kernel's share of its roofline, in
percent: the bytes its launches in the traced slice must move (from their
argument shapes, ``peaks.window_join_bytes``) at 3.35 TB/s, over the
kernel's device time in the trace. Nothing where the slice holds no
launch, or the launches recorded and the kernels traced disagree."""

from harness.peaks import share, window_join_bytes


def read(run):
    t = run.trace
    if not t or not run.launches:
        return None
    wj = t["window_join"]
    if wj["launches"] != len(run.launches) or wj["s"] <= 0:
        return None
    moved = [window_join_bytes(*shape) for shape in run.launches]
    return share(sum(r for r, _ in moved), sum(w for _, w in moved), wj["s"])
