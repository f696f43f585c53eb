"""device_idle_share: percent of the traced slice in which no kernel, copy
or memset ran on the card (torch.profiler's timeline)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
