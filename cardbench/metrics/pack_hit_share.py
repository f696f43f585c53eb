"""pack_hit_share: percent of the packed-row cache's lookups in the window
that hit (``cache.pack`` hits over hits plus misses)."""


def read(run):
    c = run.counters
    n = c.get("pack.hits", 0.0) + c.get("pack.misses", 0.0)
    return 100.0 * c.get("pack.hits", 0.0) / n if n > 0 else None
