"""The one general traffic generator: a mix is a data file of parameters
(``cardbench/traffic/<name>.json``) that this module reads.

Keys of a mix:

* ``generator``: ``stopflood`` (``hottest``: QT1 queries of distinct lemmas
  drawn by frequency from the hottest stop lemmas) or ``mixed``
  (``weights`` over qt1..qt5 and ``window``: queries sampled from real
  co-occurrence windows);
* ``min_len`` / ``max_len``: words per query;
* ``stream``: the queries drawn from the run's seed before the window, in
  the order the clients send them; each is sent once, and a window that
  reaches the end draws the next ``stream`` queries from the same seed
  (no query of a run's stream is sent twice by the harness; repeats are
  the distribution's own);
* ``served_in_setup`` (optional, 0 if absent): how many of the stream's
  first queries the clients send in set-up, untimed, before the window,
  which then goes on with the queries after them; the row cache and the
  plan memo hold what a service that has run that long holds;
* ``loop``: ``closed`` — ``clients`` each wait for their reply before they
  send the next query;
* ``deadline_s``: the budget each query carries (measured by the service;
  enforced only where its configuration turns admission on).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from harness.corpus import Corpus, mixed_queries, stopword_flood

REQUIRED = ("generator", "min_len", "max_len", "stream", "loop", "clients", "deadline_s")


def load(path: Path) -> dict:
    spec = json.loads(Path(path).read_text())
    missing = [k for k in REQUIRED if k not in spec]
    if missing:
        raise ValueError(f"{path}: traffic mix lacks {missing}")
    if spec["loop"] != "closed":
        raise ValueError(f"{path}: loop {spec['loop']!r} is not one this harness runs")
    return spec


def queries(corpus: Corpus, spec: dict, seed: int) -> list[list[int]]:
    """``spec["stream"]`` queries (lemma-id lists) of the mix drawn with ``seed``."""
    g, n = spec["generator"], int(spec["stream"])
    lo, hi = int(spec["min_len"]), int(spec["max_len"])
    if g == "stopflood":
        return stopword_flood(corpus, n, int(spec["hottest"]), lo, hi, seed)
    if g == "mixed":
        return mixed_queries(corpus, n, dict(spec["weights"]), lo, hi,
                             int(spec["window"]), seed)
    raise ValueError(f"unknown traffic generator {g!r}")


class Stream:
    """The queries of one run, in the order they are sent: block ``i`` is
    ``queries(corpus, spec, seed_i)`` with ``seed_i`` the ``i``-th child of
    the run's stream seed. The first block is drawn in set-up."""

    def __init__(self, corpus: Corpus, spec: dict, seed: int):
        self.corpus, self.spec = corpus, spec
        self.seeds = np.random.SeedSequence(int(seed))
        self.blocks = 0
        self.queries = self._draw()
        self.cursor = 0

    def _draw(self) -> list[list[int]]:
        child = self.seeds.spawn(1)[0]
        self.blocks += 1
        return queries(self.corpus, self.spec, int(child.generate_state(1)[0]))

    def next(self) -> list[int]:
        if self.cursor == len(self.queries):
            self.queries, self.cursor = self._draw(), 0
        q = self.queries[self.cursor]
        self.cursor += 1
        return q
