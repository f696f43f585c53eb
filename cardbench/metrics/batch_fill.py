"""batch_fill: queries a compiled batch carried over max_batch, in percent
(the executor's batch count and the compiled routes' request counts over
the window)."""

COMPILED = ("route.qt1", "route.qt2", "route.qt34", "route.qt5")


def read(run):
    c = run.counters
    batches = c.get("batches", 0.0)
    if batches <= 0:
        return None
    return 100.0 * sum(c.get(k, 0.0) for k in COMPILED) / (batches * run.max_batch)
