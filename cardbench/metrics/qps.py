"""qps: queries answered in the window over the window's seconds (host clock;
the window runs to the end of its last drain)."""


def read(run):
    w = run.window
    return w.completed / w.window_s if w.window_s > 0 else None
