"""step_ms_per_batch: a compiled batch's step, dispatch plus execute (ending
in a synchronise), sum of serve.step.* over its count, in ms."""


def read(run):
    c = run.counters
    n = c.get("serve.step.count", 0.0)
    return c["serve.step.sum_us"] / n / 1e3 if n > 0 else None
