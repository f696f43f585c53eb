"""Plain reference for the served proximity-search records, from the token
table alone.

The semantics (the paper's QT1-QT5 algorithm as DESIGN.md §8-§9 and §13
fix it) are worked out here again from the tokens: no index, posting list,
(f,s,t) or (w,v) key, NSW record or packed row of the program is read.
Documents are laid out at a stride of (longest document + MaxDistance + 2)
positions, ``g = doc * stride + pos``, the layout in which the program
states its windows; a record is ``(doc, start, end, score)`` with
``doc = lo // stride``, ``start = lo % stride``, ``end = hi % stride``.

One *lane* per anchor occurrence (per anchor interval for QT2), in the
anchor's order; a valid lane spans ``[lo, hi]``:

* QT1 (all stop lemmas, 3..MaxDistance of them): anchor = the most frequent
  lemma; the rest is covered by (s, t) pairs (a lemma repeated pairs with
  itself first, then leftovers in FL order, an odd one with an already
  covered lemma). A pair holds at an anchor occurrence when s and t sit at
  two distinct offsets within MaxDistance; its witness is the pair of
  offsets (a < b) least in (|a| + |b|, a, b). The lane spans the anchor and
  every pair's witness.
* QT2 (all frequently used): the query sorted by FL is covered by
  consecutive pairs (an odd leftover with the first lemma); a pair's
  intervals are every two occurrences of its lemmas at most MaxDistance
  apart, ordered by start (then by the first lemma's position and the
  offset). Anchor = the pair with the fewest intervals (first on ties).
  Every other pair must have an interval starting within 2 * MaxDistance
  of the anchor interval's start: the nearest start (the earlier on ties),
  the first interval with it.
* QT3 / QT4 (no stop lemma), and the scalar route of a QT1 query shorter
  than 3: anchor = the most frequent lemma; a lemma of multiplicity r must
  have r distinct occurrences within MaxDistance of the anchor (the anchor
  occurrence itself counts for the anchor lemma); the r nearest extend the
  lane, ties between the i-th nearest before and the j-th nearest at or
  after the anchor going to the one before iff i <= j.
* QT5 (stop and non-stop): anchor = the non-stop lemma with the fewest
  occurrences (least id on ties); non-stop lemmas as in QT3; a stop lemma of
  multiplicity r must occur r times within MaxDistance, and its nearest
  occurrence (the one before on ties) extends the lane.

The score of a lane is ``idf_sum / (1 + max(span - (m - 1), 0))`` with
``idf = ln(1 + n_docs / df)`` summed in query order and m the query's
length. What is served depends on the route the response names:

* a compiled route (``qt1``/``qt2``/``qt34``/``qt5``): scores in float32
  with span = hi - lo; the k best lanes, ties in lane order, no merging of
  equal records;
* the scalar route (``cpu``): scores in float64 with span = end - start;
  equal (doc, start, end) records merged; the k best, ties by (doc, start,
  end). A QT1 query longer than MaxDistance is served as its parts of
  MaxDistance lemmas, each scored on its own.
"""

from __future__ import annotations

import numpy as np

STOP, FREQUENT, ORDINARY = 0, 1, 2
COMPILED_ROUTES = ("qt1", "qt2", "qt34", "qt5")
SCALAR_ROUTE = "cpu"


def fst_key_cover(ids) -> tuple[int, list[tuple[int, int, int]]]:
    """QT1: anchor and the (f, s, t) keys that cover the rest of the query."""
    ids = sorted(ids)
    f = ids[0]
    rest = ids[1:] or [f]
    mult: dict[int, int] = {}
    for lemma in rest:
        mult[lemma] = mult.get(lemma, 0) + 1
    pairs, odd = [], []
    for lemma in sorted(mult):
        pairs += [(lemma, lemma)] * (mult[lemma] // 2)
        if mult[lemma] % 2:
            odd.append(lemma)
    for i in range(0, len(odd) - 1, 2):
        pairs.append((odd[i], odd[i + 1]))
    if len(odd) % 2:
        last = odd[-1]
        covered = [x for p in pairs for x in p if x != last]
        partner = covered[0] if covered else last
        pairs.append((min(partner, last), max(partner, last)))
    keys: list[tuple[int, int, int]] = []
    for s, t in pairs:
        if (f, s, t) not in keys:
            keys.append((f, s, t))
    return f, keys


def wv_key_cover(ids) -> list[tuple[int, int]]:
    """QT2: consecutive pairs of the FL-sorted query, an odd leftover paired
    with the first lemma."""
    ids = sorted(ids)
    keys = [(ids[i], ids[i + 1]) for i in range(0, len(ids) - 1, 2)]
    if len(ids) % 2:
        keys.append((min(ids[0], ids[-1]), max(ids[0], ids[-1])))
    return keys


def _multiplicities(ids) -> dict[int, int]:
    mult: dict[int, int] = {}
    for lemma in ids:
        mult[lemma] = mult.get(lemma, 0) + 1
    return mult


class Reference:
    """The records a query should be served, from one corpus's tokens.

    ``doc_ids``/``positions``/``lemma_ids`` hold one row per token (one
    lemma per position); ``doc_freqs[l]`` is the number of documents
    holding lemma l."""

    def __init__(self, doc_ids, positions, lemma_ids, doc_lengths, doc_freqs, *,
                 max_distance: int, sw_count: int, fu_count: int,
                 window_cache_bytes: int = 1 << 30):
        d = int(max_distance)
        self.d = d
        self.sw = int(sw_count)
        self.fu_hi = int(sw_count) + int(fu_count)
        lengths = np.asarray(doc_lengths, np.int64)
        self.n_docs = int(lengths.size)
        self.stride = int(lengths.max()) + d + 2
        self.pad = 2 * d + 2
        g = (np.asarray(doc_ids, np.int64) * self.stride
             + np.asarray(positions, np.int64))
        lemmas = np.asarray(lemma_ids, np.int32)
        self.tok = np.full(self.pad + self.n_docs * self.stride + self.pad, -1, np.int32)
        self.tok[self.pad + g] = lemmas
        if np.count_nonzero(self.tok >= 0) != lemmas.size:
            raise ValueError("the reference holds one lemma per position")
        order = np.lexsort((g, lemmas))
        self._occ = g[order]
        n_lemmas = int(lemmas.max()) + 1 if lemmas.size else 0
        self._occ_bounds = np.searchsorted(lemmas[order], np.arange(n_lemmas + 1))
        self.df = np.asarray(doc_freqs, np.int64)
        self._nz = np.array([o for o in range(-d, d + 1) if o != 0], np.int64)
        self._all = np.arange(-d, d + 1, dtype=np.int64)
        # witness order of the QT1 pairs of offsets (a < b)
        pairs = [(ia, ib) for ia in range(self._nz.size) for ib in range(ia + 1, self._nz.size)]
        pairs.sort(key=lambda p: (abs(self._nz[p[0]]) + abs(self._nz[p[1]]),
                                  self._nz[p[0]], self._nz[p[1]]))
        self._pairs = pairs
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._cache_bytes = 0
        self._cache_cap = int(window_cache_bytes)

    # -- corpus lookups ----------------------------------------------------
    def occurrences(self, lemma: int) -> np.ndarray:
        """Positions (g, ascending) of one lemma."""
        if lemma < 0 or lemma + 1 >= self._occ_bounds.size:
            return np.zeros(0, np.int64)
        return self._occ[self._occ_bounds[lemma]:self._occ_bounds[lemma + 1]]

    def count(self, lemma: int) -> int:
        return int(self.occurrences(lemma).size)

    def idf(self, lemma: int) -> float:
        if lemma >= self.df.size:
            return float(np.log1p(self.n_docs))
        return float(np.log1p(self.n_docs / max(int(self.df[lemma]), 1)))

    def lemma_type(self, lemma: int) -> int:
        if lemma < self.sw:
            return STOP
        return FREQUENT if lemma < self.fu_hi else ORDINARY

    def qtype(self, ids) -> int:
        types = {self.lemma_type(x) for x in ids}
        if types == {STOP}:
            return 1
        if types == {FREQUENT}:
            return 2
        if types == {ORDINARY}:
            return 3
        return 4 if STOP not in types else 5

    def _window(self, centers: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        return self.tok[self.pad + centers[:, None] + offsets[None, :]]

    def _anchor_window(self, lemma: int) -> tuple[np.ndarray, np.ndarray]:
        """(occurrences, their tokens at the nonzero offsets), kept for hot
        QT1 anchors."""
        hit = self._cache.get(lemma)
        if hit is not None:
            return hit
        A = self.occurrences(lemma)
        W = self._window(A, self._nz)
        if W.nbytes <= self._cache_cap:
            while self._cache and self._cache_bytes + W.nbytes > self._cache_cap:
                old = next(iter(self._cache))
                self._cache_bytes -= self._cache.pop(old)[1].nbytes
            self._cache[lemma] = (A, W)
            self._cache_bytes += W.nbytes
        return A, W

    # -- lanes ---------------------------------------------------------------
    def _qt1_lanes(self, ids):
        f, keys = fst_key_cover(ids)
        A, W = self._anchor_window(f)
        alive = np.ones(A.size, bool)
        for _, s, t in keys:
            S = W == s
            if s == t:
                alive &= S.sum(axis=1) >= 2
            else:
                alive &= S.any(axis=1) & (W == t).any(axis=1)
        rows = np.flatnonzero(alive)
        A, W = A[rows], W[rows]
        lo_off = np.zeros(A.size, np.int64)
        hi_off = np.zeros(A.size, np.int64)
        for _, s, t in keys:
            S, T = W == s, W == t
            found = np.zeros(A.size, bool)
            for ia, ib in self._pairs:
                hit = (S[:, ia] & T[:, ib]) | (T[:, ia] & S[:, ib])
                new = hit & ~found
                if new.any():
                    lo_off[new] = np.minimum(lo_off[new], min(int(self._nz[ia]), 0))
                    hi_off[new] = np.maximum(hi_off[new], max(int(self._nz[ib]), 0))
                    found |= new
                    if found.all():
                        break
        return A + lo_off, A + hi_off

    def _intervals(self, a: int, b: int):
        """(lo, hi) of a (w, v) pair's intervals, ordered by lo, then by the
        position of ``a`` and the offset."""
        d = self.d
        A = self.occurrences(a)
        offs = self._nz if a != b else np.arange(1, d + 1, dtype=np.int64)
        rows, cols = np.nonzero(self._window(A, offs) == b)
        pa = A[rows]
        pb = pa + offs[cols]
        lo, hi = np.minimum(pa, pb), np.maximum(pa, pb)
        order = np.lexsort((offs[cols], pa, lo))
        return lo[order], hi[order]

    def _qt2_lanes(self, ids):
        items = [self._intervals(a, b) for a, b in wv_key_cover(ids)]
        order = np.argsort([it[0].size for it in items], kind="stable")
        a_lo, a_hi = items[order[0]]
        valid = np.ones(a_lo.size, bool)
        lo, hi = a_lo.copy(), a_hi.copy()
        sep = 2 * self.d
        big = np.iinfo(np.int64).max
        for i in order[1:]:
            b_lo, b_hi = items[i]
            if b_lo.size == 0:
                valid[:] = False
                continue
            idx = np.searchsorted(b_lo, a_lo, side="left")
            prev = b_lo[np.clip(idx - 1, 0, b_lo.size - 1)]
            nxt = b_lo[np.clip(idx, 0, b_lo.size - 1)]
            d_prev = np.where(idx >= 1, a_lo - prev, big)
            d_next = np.where(idx < b_lo.size, nxt - a_lo, big)
            d_prev = np.where(d_prev <= sep, d_prev, big)
            d_next = np.where(d_next <= sep, d_next, big)
            take_prev = d_prev <= d_next
            matched = np.minimum(d_prev, d_next) <= sep
            val = np.where(take_prev, prev, nxt)
            partner_hi = b_hi[np.searchsorted(b_lo, val, side="left").clip(0, b_lo.size - 1)]
            valid &= matched
            lo = np.where(matched, np.minimum(lo, val), lo)
            hi = np.where(matched, np.maximum(hi, partner_hi), hi)
        return lo[valid], hi[valid]

    def _nearest(self, A: np.ndarray, lemma: int, r: int, lo, hi):
        """Lanes with r occurrences of ``lemma`` within MaxDistance of the
        anchor; the r nearest extend [lo, hi] in place. Returns the mask."""
        d = self.d
        M = self._window(A, self._all) == lemma  # column d is offset 0
        taken = M[:, d].astype(np.int64).clip(0, r)
        before = np.zeros(A.size, np.int64)
        after = M[:, d].astype(np.int64)
        for k in range(1, d + 1):
            neg, pos = M[:, d - k], M[:, d + k]
            before += neg
            after += pos
            fits = taken + neg + pos <= r
            one_left = neg & pos & (taken == r - 1)
            take_neg = neg & (fits | (one_left & (before <= after)))
            take_pos = pos & (fits | (one_left & (before > after)))
            np.minimum(lo, np.where(take_neg, A - k, lo), out=lo)
            np.maximum(hi, np.where(take_pos, A + k, hi), out=hi)
            taken += take_neg.astype(np.int64) + take_pos.astype(np.int64)
        return taken >= r

    def _stop(self, A: np.ndarray, lemma: int, r: int, lo, hi):
        """Lanes with r occurrences of a stop lemma within MaxDistance; its
        nearest occurrence (the one before on ties) extends [lo, hi]."""
        d = self.d
        M = self._window(A, self._nz) == lemma  # offsets -d..-1, 1..d
        cnt = M.sum(axis=1)
        ext = np.zeros(A.size, np.int64)
        done = np.zeros(A.size, bool)
        for k in range(1, d + 1):
            for o, col in ((-k, d - k), (k, d + k - 1)):
                new = M[:, col] & ~done
                ext[new] = o
                done |= new
        np.minimum(lo, A + np.minimum(ext, 0), out=lo)
        np.maximum(hi, A + np.maximum(ext, 0), out=hi)
        return cnt >= r

    def _window_lanes(self, anchor: int, others, stops=()):
        A = self.occurrences(anchor)
        lo, hi = A.copy(), A.copy()
        valid = np.ones(A.size, bool)
        for lemma, r in others:
            valid &= self._nearest(A, lemma, r, lo, hi)
        for lemma, r in stops:
            valid &= self._stop(A, lemma, r, lo, hi)
        return lo[valid], hi[valid]

    def _qt34_lanes(self, ids):
        mult = _multiplicities(ids)
        anchor = min(mult)
        others = [(x, mult[x]) for x in sorted(mult) if x != anchor or mult[x] > 1]
        return self._window_lanes(anchor, others)

    def _qt5_lanes(self, ids):
        nonstop = _multiplicities([x for x in ids if x >= self.sw])
        stops = _multiplicities([x for x in ids if x < self.sw])
        anchor = min(sorted(nonstop), key=lambda x: (self.count(x), x))
        others = [(x, nonstop[x]) for x in sorted(nonstop) if x != anchor or nonstop[x] > 1]
        return self._window_lanes(anchor, others, sorted(stops.items()))

    def lanes(self, ids):
        """(lo, hi) of the valid lanes of a query, in lane order."""
        qt = self.qtype(ids)
        if qt == 1:
            if len(ids) < 3:
                return self._qt34_lanes(ids)
            if len(ids) > self.d:
                raise ValueError("a QT1 query longer than MaxDistance has parts, not lanes")
            return self._qt1_lanes(ids)
        if qt == 2:
            return self._qt2_lanes(ids)
        if qt == 5:
            return self._qt5_lanes(ids)
        return self._qt34_lanes(ids)

    # -- served records ------------------------------------------------------
    def _parts(self, ids):
        """The sub-queries the scalar route serves separately."""
        if self.qtype(ids) == 1 and len(ids) > self.d:
            return [ids[i:i + self.d] for i in range(0, len(ids), self.d)]
        return [ids]

    def answer(self, ids, route: str, k: int, precision: str = "float32") -> dict:
        """The records ``route`` should serve for ``ids``: the k best, as
        (doc, start, end, score) columns. ``precision`` sets the arithmetic
        of a compiled route's score ("float32" as the program states it;
        "bfloat16" is the control's)."""
        ids = [int(x) for x in ids]
        if not ids:
            return _records([], [], [], np.zeros(0, np.float32))
        if route == SCALAR_ROUTE:
            return self._scalar(ids, k)
        if route not in COMPILED_ROUTES:
            raise ValueError(f"no records are defined for route {route!r}")
        lo, hi = self.lanes(ids)
        idf = sum(self.idf(x) for x in ids)
        score = _score(idf, hi - lo, len(ids), precision)
        order = np.argsort(-score, kind="stable")[:k]
        lo, hi = lo[order], hi[order]
        return _records(lo // self.stride, lo % self.stride, hi % self.stride,
                        score[order])

    def _scalar(self, ids, k: int) -> dict:
        cols = [], [], [], []
        for part in self._parts(ids):
            lo, hi = self.lanes(part)
            start, end = lo % self.stride, hi % self.stride
            idf = sum(self.idf(x) for x in part)
            excess = np.maximum((end - start) - (len(part) - 1), 0)
            for col, v in zip(cols, (lo // self.stride, start, end, idf / (1.0 + excess))):
                col.append(v)
        doc, start, end, score = (np.concatenate(c) for c in cols)
        score = score.astype(np.float64)
        # merge equal records (the best score), then the k best, ties by record
        order = np.lexsort((-score, end, start, doc))
        doc, start, end, score = doc[order], start[order], end[order], score[order]
        first = np.ones(doc.size, bool)
        first[1:] = (doc[1:] != doc[:-1]) | (start[1:] != start[:-1]) | (end[1:] != end[:-1])
        doc, start, end, score = doc[first], start[first], end[first], score[first]
        rank = np.argsort(-score, kind="stable")[:k]
        return _records(doc[rank], start[rank], end[rank], score[rank])


def _score(idf_sum: float, span: np.ndarray, m: int, precision: str) -> np.ndarray:
    if precision == "float32":
        excess = np.maximum(span.astype(np.float32) - np.float32(m - 1), np.float32(0))
        return np.float32(idf_sum) / (np.float32(1.0) + excess)
    if precision == "bfloat16":
        import torch

        bf = torch.bfloat16
        excess = torch.clamp_min(torch.from_numpy(span).to(bf) - torch.tensor(m - 1, dtype=bf), 0)
        score = torch.tensor(idf_sum, dtype=bf) / (torch.tensor(1.0, dtype=bf) + excess)
        return score.float().numpy()
    raise ValueError(f"unknown precision {precision!r}")


def _records(doc, start, end, score) -> dict:
    return {"doc": np.asarray(doc, np.int64), "start": np.asarray(start, np.int64),
            "end": np.asarray(end, np.int64), "score": np.asarray(score)}
