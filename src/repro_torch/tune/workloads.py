"""First-class workload model for the parameter autotuner (DESIGN.md §19).

Every serving knob in ``ServeConfig`` was historically swept against
*uniform* query sampling — exactly the traffic the paper calls
unrepresentative of high-frequency-word search (the head of the Zipf
curve is where the multi-component indexes earn their keep, and where
they are stressed). This module makes the workload a first-class,
reproducible object:

* :class:`Workload` — a named query stream (lemma-id lists), its
  generator provenance (``meta``), and an optional arrival schedule;
* named generators — :func:`zipfian_workload` (lemma draws weighted by
  the corpus frequency table), :func:`longtail_workload` (ordinary-tail
  draws with an occasional head lemma: a long-tailed posting-length
  L distribution), :func:`stopword_flood` (adversarial all-stop QT1
  floods from the hottest stop lemmas), :func:`mixed_workload`
  (five-type traffic with a configurable type mix over the
  co-occurrence samplers of :mod:`repro_torch.data.corpus`);
* record/replay — :func:`record_workload` / :func:`load_workload`
  round-trip a workload through a JSON trace file bit-identically, so
  a sweep can be replayed against a new build;
* :func:`attach_arrivals` — attach a :mod:`repro_torch.serving.load` arrival
  process (poisson / bursty) to any workload, making it directly
  consumable by ``run_open_loop``.

All generators are deterministic per seed and draw only lemma ids that
exist in the lexicon (id == FL frequency rank), so every query routes
through the real planner. Zipfian/long-tail/flood queries are
frequency-realistic but not co-occurrence-constrained (a query's lemmas
may never share a document); the mixed generator samples real
co-occurrence windows. For latency tuning that is the right trade:
step cost is shape-bound, not hit-bound.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.query import classify
from repro_torch.data.corpus import sample_typed_queries

WORKLOAD_FORMAT = "repro.tune/workload.v1"  # shared with the JAX package

QT_KINDS = ("qt1", "qt2", "qt3", "qt4", "qt5")


@dataclass
class Workload:
    """One reproducible query stream: ``queries`` is a list of lemma-id
    lists (the ``submit()`` shape), ``meta`` records generator + seed +
    declared mix, ``arrivals`` an optional offset schedule (seconds from
    trace start) attached by :func:`attach_arrivals`."""

    name: str
    queries: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)
    arrivals: list | None = None

    def __len__(self) -> int:
        return len(self.queries)

    def type_mix(self, lex) -> dict:
        """Measured QT-class histogram of the stream (fractions)."""
        if not self.queries:
            return {}
        counts: dict[str, int] = {}
        for q in self.queries:
            qt = f"qt{int(classify(q, lex))}"
            counts[qt] = counts.get(qt, 0) + 1
        n = len(self.queries)
        return {k: counts[k] / n for k in sorted(counts)}


def _lengths(rng, n_queries: int, min_len: int, max_len: int) -> np.ndarray:
    if not 1 <= min_len <= max_len:
        raise ValueError(f"need 1 <= min_len <= max_len "
                         f"(got {min_len}, {max_len})")
    return rng.integers(min_len, max_len + 1, size=n_queries)


def _weighted_query(rng, pool: np.ndarray, probs: np.ndarray | None,
                    L: int) -> list[int]:
    """One query: L distinct draws from ``pool`` (weighted by ``probs``
    when given), clamped to the pool size."""
    take = min(L, pool.size)
    q = rng.choice(pool, size=take, replace=False, p=probs)
    return [int(x) for x in q]


def zipfian_workload(table, lex, n_queries: int, *, min_len: int = 3,
                     max_len: int = 5, alpha: float = 1.0,
                     seed: int = 0) -> Workload:
    """Zipfian lemma draws over the *observed* corpus frequency table:
    each lemma is drawn with probability proportional to
    ``lex.counts ** alpha`` — the head-heavy traffic of real query logs
    (``alpha=1`` reproduces the collection's own frequency profile;
    higher alpha concentrates further on stop/frequent lemmas)."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(lex.counts, dtype=np.float64)
    w = np.power(np.maximum(counts, 1.0), alpha)
    probs = w / w.sum()
    pool = np.arange(counts.size)
    queries = [
        _weighted_query(rng, pool, probs, int(L))
        for L in _lengths(rng, n_queries, min_len, max_len)
    ]
    wl = Workload("zipfian", queries,
                  {"generator": "zipfian", "seed": seed, "alpha": alpha,
                   "min_len": min_len, "max_len": max_len})
    wl.meta["type_mix"] = wl.type_mix(lex)
    return wl


def longtail_workload(table, lex, n_queries: int, *, min_len: int = 3,
                      max_len: int = 5, head_frac: float = 0.15,
                      seed: int = 0) -> Workload:
    """Long-tail L skew: queries draw uniformly from the *ordinary*
    lemma tail (tiny posting rows — the bulk of the vocabulary), and a
    ``head_frac`` fraction of queries swaps one lemma for a
    frequency-weighted head (stop/frequent) lemma whose posting row is
    orders of magnitude longer. The resulting posting-length (L)
    distribution is long-tailed: most queries fit the smallest ladder
    bucket, a heavy tail does not — the regime where ladder choice and
    degrade policy actually matter."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(lex.counts, dtype=np.float64)
    head_hi = lex.sw_count + lex.fu_count
    tail = np.arange(head_hi, counts.size)
    if tail.size < max_len:
        raise ValueError(f"lexicon has only {tail.size} ordinary lemmas "
                         f"(< max_len={max_len})")
    head = np.arange(min(head_hi, counts.size))
    head_w = counts[head]
    head_p = head_w / head_w.sum() if head_w.sum() > 0 else None
    queries = []
    for L in _lengths(rng, n_queries, min_len, max_len):
        q = _weighted_query(rng, tail, None, int(L))
        if head.size and rng.random() < head_frac:
            q[0] = int(rng.choice(head, p=head_p))
        queries.append(q)
    wl = Workload("longtail", queries,
                  {"generator": "longtail", "seed": seed,
                   "head_frac": head_frac, "min_len": min_len,
                   "max_len": max_len})
    wl.meta["type_mix"] = wl.type_mix(lex)
    return wl


def stopword_flood(lex, n_queries: int, *, min_len: int = 3,
                   max_len: int = 5, hottest: int = 32,
                   seed: int = 0) -> Workload:
    """Adversarial all-stop-word flood: every query is QT1, drawn
    frequency-weighted from the ``hottest`` most frequent stop lemmas —
    the worst-case traffic the paper's (f,s,t) index exists for (the
    longest posting rows in the collection, hit on every request)."""
    rng = np.random.default_rng(seed)
    sw = int(lex.sw_count)
    if sw < min_len:
        raise ValueError(f"lexicon has only {sw} stop lemmas "
                         f"(< min_len={min_len})")
    pool = np.arange(min(hottest, sw))
    counts = np.asarray(lex.counts, dtype=np.float64)[pool]
    probs = counts / counts.sum() if counts.sum() > 0 else None
    queries = [
        _weighted_query(rng, pool, probs, int(L))
        for L in _lengths(rng, n_queries, min_len, max_len)
    ]
    wl = Workload("stopflood", queries,
                  {"generator": "stopflood", "seed": seed,
                   "hottest": int(pool.size), "min_len": min_len,
                   "max_len": max_len})
    wl.meta["type_mix"] = wl.type_mix(lex)
    return wl


def mixed_workload(table, lex, n_queries: int, *, mix: dict | None = None,
                   min_len: int = 3, max_len: int = 5, window: int = 9,
                   seed: int = 0) -> Workload:
    """Mixed five-type traffic with a configurable type mix: per-class
    counts follow ``mix`` (weights over qt1..qt5, default uniform),
    queries come from the real co-occurrence samplers
    (:func:`repro_torch.data.corpus.sample_typed_queries`) and are interleaved
    round-robin proportionally to the mix."""
    weights = {k: 1.0 for k in QT_KINDS} if mix is None else dict(mix)
    bad = sorted(set(weights) - set(QT_KINDS))
    if bad:
        raise ValueError(f"unknown query types in mix: {bad}")
    total = sum(max(w, 0.0) for w in weights.values())
    if total <= 0:
        raise ValueError(f"mix has no positive weight: {mix}")
    # largest-remainder apportionment: per-type counts sum to n_queries
    # and match the declared mix as closely as integers allow
    kinds = [k for k in QT_KINDS if weights.get(k, 0.0) > 0]
    exact = {k: n_queries * weights[k] / total for k in kinds}
    counts = {k: int(exact[k]) for k in kinds}
    short = n_queries - sum(counts.values())
    for k in sorted(kinds, key=lambda k: exact[k] - counts[k],
                    reverse=True)[:short]:
        counts[k] += 1
    cols = {
        k: sample_typed_queries(table, lex, counts[k], k, min_len,
                                max_len, window, seed + i)
        for i, k in enumerate(kinds)
    }
    declared = {k: counts[k] for k in kinds}
    # proportional round-robin interleave (no sorted type blocks: a
    # block would serialize into one giant batch and misrepresent the
    # steady-state group mix)
    queries: list = []
    idx = {k: 0 for k in kinds}
    while len(queries) < sum(len(c) for c in cols.values()):
        for k in kinds:
            if idx[k] < len(cols[k]):
                queries.append(cols[k][idx[k]])
                idx[k] += 1
    wl = Workload("mixed", queries,
                  {"generator": "mixed", "seed": seed,
                   "mix": {k: weights[k] for k in kinds},
                   "declared_counts": declared, "min_len": min_len,
                   "max_len": max_len, "window": window})
    wl.meta["type_mix"] = wl.type_mix(lex)
    return wl


# name -> generator; stopflood takes no token table
WORKLOAD_GENERATORS = {
    "zipfian": zipfian_workload,
    "longtail": longtail_workload,
    "stopflood": stopword_flood,
    "mixed": mixed_workload,
}


def make_workload(name: str, table, lex, n_queries: int, *, seed: int = 0,
                  **kw) -> Workload:
    """Build one of the named workloads (the registry the sweep harness
    and benches iterate)."""
    gen = WORKLOAD_GENERATORS.get(name)
    if gen is None:
        raise ValueError(f"unknown workload {name!r} "
                         f"(have {sorted(WORKLOAD_GENERATORS)})")
    if name == "stopflood":
        return gen(lex, n_queries, seed=seed, **kw)
    return gen(table, lex, n_queries, seed=seed, **kw)


# -- record / replay --------------------------------------------------------
def record_workload(workload: Workload, path: str) -> dict:
    """Write a workload (queries, meta, arrivals) as a JSON trace file.
    The payload is pure ints/floats/strings, so
    ``load_workload(record_workload(w, p))`` round-trips bit-identically
    — a recorded sweep workload replays exactly."""
    payload = {
        "format": WORKLOAD_FORMAT,
        "name": workload.name,
        "meta": workload.meta,
        "queries": [[int(l) for l in q] for q in workload.queries],
        "arrivals": workload.arrivals,
    }
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
    return payload


def load_workload(path: str) -> Workload:
    """Load a trace file written by :func:`record_workload`."""
    with open(path) as fh:
        payload = json.load(fh)
    fmt = payload.get("format")
    if fmt != WORKLOAD_FORMAT:
        raise ValueError(f"{path}: not a workload trace "
                         f"(format={fmt!r}, want {WORKLOAD_FORMAT!r})")
    return Workload(
        name=payload["name"],
        queries=[list(q) for q in payload["queries"]],
        meta=payload.get("meta", {}),
        arrivals=payload.get("arrivals"),
    )


def attach_arrivals(workload: Workload, process: str = "poisson", *,
                    qps: float, duration_s: float, seed: int = 0,
                    **kw) -> Workload:
    """A copy of ``workload`` with a :mod:`repro_torch.serving.load` arrival
    schedule attached (``process`` is ``"poisson"`` or ``"bursty"``;
    extra kwargs reach the generator, e.g. ``burst_factor``). The
    schedule is recorded in ``meta`` and survives record/replay, so an
    open-loop run over a replayed trace offers the identical load."""
    from repro_torch.serving.load import bursty_arrivals, poisson_arrivals

    gens = {"poisson": poisson_arrivals, "bursty": bursty_arrivals}
    gen = gens.get(process)
    if gen is None:
        raise ValueError(f"unknown arrival process {process!r} "
                         f"(have {sorted(gens)})")
    # plain floats, not an ndarray: the schedule must survive the JSON
    # record/replay round-trip bit-identically
    arrivals = [float(t) for t in gen(qps, duration_s, seed=seed, **kw)]
    meta = dict(workload.meta)
    meta["arrival_process"] = {"process": process, "qps": qps,
                               "duration_s": duration_s, "seed": seed, **kw}
    return dataclasses.replace(workload, meta=meta, arrivals=arrivals)
