"""scalar_share: percent of the window's queries planned onto the scalar
(host) route, from the service's route counts."""


def read(run):
    c = run.counters
    n = c.get("requests", 0.0)
    return 100.0 * c.get("route.scalar", 0.0) / n if n > 0 else None
