"""What decides ``correct``: the served records of a sample of the window's
answers against the plain reference.

The sample is the window's per-route reservoirs (``harness.window``),
drawn from the seed. Each sampled answer is judged by what it says: its
(doc, start, end, score) columns must equal, element for element, the
records the reference works out from the token table for the route the
response names (``reference.search``). The number compared is the count
of sampled answers that differ in any record; its limit is 0. Every
request of the window must also have been answered: the count of those
that never were has the limit 0 too.
"""

from __future__ import annotations

import numpy as np

COLS = ("doc", "start", "end", "score")
LIMITS = {"mismatched_answers": 0, "unanswered_requests": 0}


def _same(got: dict, want: dict) -> bool:
    return all(np.array_equal(np.asarray(got[c]), want[c]) for c in COLS)


def judge(ref, samples: dict, top_k: int, unanswered: int = 0) -> dict:
    """``samples``: route -> [(query, served results)]; ``unanswered``: the
    window's requests that got no reply. Returns the numbers compared (see
    ``LIMITS``), how many answers were compared by route, and the first
    answer that differs."""
    want_of: dict[tuple, dict] = {}
    mismatched, compared, first = 0, {}, None
    for route, items in sorted(samples.items()):
        for q, got in items:
            key = (tuple(q), route)
            want = want_of.get(key)
            if want is None:
                want = want_of[key] = (
                    ref.answer(q, route, top_k) if route != "empty"
                    else {c: np.zeros(0) for c in COLS})
            compared[route] = compared.get(route, 0) + 1
            if not _same(got, want):
                mismatched += 1
                if first is None:
                    first = {"query": list(q), "route": route,
                             "served": {c: np.asarray(got[c]).tolist()[:4] for c in COLS},
                             "reference": {c: want[c].tolist()[:4] for c in COLS}}
    return {"numbers": {"mismatched_answers": mismatched, "unanswered_requests": unanswered},
            "compared": compared,
            "first_mismatch": first}


def passed(verdict: dict) -> bool:
    return all(verdict["numbers"][k] <= limit for k, limit in LIMITS.items())
