"""The search algorithm (paper §2) for all query types QT1-QT5, plus the
ordinary-inverted-file baseline engine (Idx1).

Result records are (ID, P, E, R) — document, fragment start/end, relevance
— exactly the paper's sub-query result shape (§2.1). Relevance
R = Σ_lemma idf(lemma) / (1 + span_excess) (the paper does not specify R;
ours is monotone in proximity, see DESIGN.md §9).

Match semantics (uniform across engines so they can be cross-validated):
a fragment matches a sub-query if there is an assignment of one position
per query lemma occurrence (distinct positions for repeated lemmas) such
that every assigned position lies within MaxDistance of the *anchor*
lemma's position. The anchor rule is the QT1 key-selection rule (most
frequent lemma = smallest FL-number), applied uniformly.

Engines:
* ``InvertedIndexEngine`` — Idx1: every lemma through its full ordinary
  posting list. In bulk (vectorized) mode, because a 2008-faithful
  per-posting loop would be unfairly slow to the baseline; this makes our
  reported speedups conservative.
* ``ProximitySearchEngine`` — Idx2..4: QT1 via (f,s,t), QT2 via (w,v),
  QT3/QT4 via ordinary (+ (w,v)) skipping NSW, QT5 via NSW records.
  QT1 supports equalize_mode "heap" (paper §2.3), "basic" ([10]) and
  "bulk" (vectorized; mirrors the device engine).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.equalize import EqualizeState, PostingIterator, equalize_basic
from repro_torch.core.index_builder import ProximityIndex
from repro_torch.core.lexicon import Lexicon, UNKNOWN_FL
from repro_torch.core.postings import ByteMeter
from repro_torch.core.query import (
    QueryType,
    SubQuery,
    build_subqueries,
    qt34_plan,
    qt5_plan,
    select_fst_keys,
    select_wv_keys,
)


@dataclass
class QueryStats:
    postings: int = 0
    bytes_read: int = 0
    seconds: float = 0.0
    n_results: int = 0


@dataclass
class Matches:
    """Columnar (ID, P, E, R) result records."""

    doc: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    end: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    score: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))

    @property
    def size(self) -> int:
        return int(self.doc.size)

    @staticmethod
    def concat(parts: list["Matches"]) -> "Matches":
        parts = [p for p in parts if p.size]
        if not parts:
            return Matches()
        return Matches(
            np.concatenate([p.doc for p in parts]),
            np.concatenate([p.start for p in parts]),
            np.concatenate([p.end for p in parts]),
            np.concatenate([p.score for p in parts]),
        )

    def dedup_topk(self, k: int | None = None) -> "Matches":
        if self.size == 0:
            return self
        order = np.lexsort((-self.score, self.end, self.start, self.doc))
        d, s, e, sc = self.doc[order], self.start[order], self.end[order], self.score[order]
        first = np.ones(d.size, bool)
        first[1:] = (d[1:] != d[:-1]) | (s[1:] != s[:-1]) | (e[1:] != e[:-1])
        d, s, e, sc = d[first], s[first], e[first], sc[first]
        rank = np.argsort(-sc, kind="stable")
        if k is not None:
            rank = rank[:k]
        return Matches(d[rank], s[rank], e[rank], sc[rank])


def _span_scores(idf_sum: float, start: np.ndarray, end: np.ndarray, m: int) -> np.ndarray:
    excess = np.maximum((end - start) - (m - 1), 0)
    return idf_sum / (1.0 + excess)


def _nearest_r(
    g_sorted: np.ndarray, centers: np.ndarray, d: int, r: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each center, find the r nearest *distinct* values of g_sorted
    within distance d. Returns (matched, min_chosen, max_chosen).
    Vectorized: examines the 2r candidates adjacent to the insertion point.
    """
    n = centers.size
    if g_sorted.size == 0 or n == 0:
        z = np.zeros(n, np.int64)
        return np.zeros(n, bool), z, z
    idx = np.searchsorted(g_sorted, centers)
    cols = []
    for j in range(1, r + 1):
        cols.append(idx - j)  # predecessors
        cols.append(idx + (j - 1))  # successors
    cand_idx = np.stack(cols, axis=1)
    valid = (cand_idx >= 0) & (cand_idx < g_sorted.size)
    cand = np.where(valid, g_sorted[np.clip(cand_idx, 0, g_sorted.size - 1)], 0)
    dist = np.abs(cand - centers[:, None]).astype(np.float64)
    dist[~valid] = np.inf
    dist[dist > d] = np.inf
    order = np.argsort(dist, axis=1)[:, :r]
    rowi = np.arange(n)[:, None]
    chosen_dist = np.take_along_axis(dist, order, axis=1)
    matched = np.isfinite(chosen_dist[:, r - 1])
    chosen = np.take_along_axis(cand, order, axis=1)
    chosen = np.where(np.isfinite(chosen_dist), chosen, centers[:, None])
    return matched, chosen.min(axis=1), chosen.max(axis=1)


class _BaseEngine:
    def __init__(self, index: ProximityIndex, top_k: int = 100):
        self.index = index
        self.lex: Lexicon = index.lexicon
        self.top_k = top_k
        d = index.max_distance
        max_len = int(index.doc_lengths.max()) if index.doc_lengths is not None and index.doc_lengths.size else 1
        self.stride = np.int64(max_len + d + 2)

    def _g(self, docs: np.ndarray, pos: np.ndarray) -> np.ndarray:
        return docs.astype(np.int64) * self.stride + pos.astype(np.int64)

    def _split_g(self, g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return g // self.stride, g % self.stride

    def _multiplicities(self, lemma_ids: list[int]) -> dict[int, int]:
        mult: dict[int, int] = {}
        for l in lemma_ids:
            mult[l] = mult.get(l, 0) + 1
        return mult

    def _window_match(
        self,
        anchor_g: np.ndarray,
        others: list[tuple[np.ndarray, int]],
        d: int,
        idf_sum: float,
        m: int,
    ) -> Matches:
        """Vectorized matcher: anchor occurrences x (sorted g array, needed
        multiplicity) constraints. Used by Idx1, QT3, QT4 and parts of QT5."""
        if anchor_g.size == 0:
            return Matches()
        ok = np.ones(anchor_g.size, bool)
        lo = anchor_g.copy()
        hi = anchor_g.copy()
        for g_sorted, r in others:
            matched, mn, mx = _nearest_r(g_sorted, anchor_g, d, r)
            ok &= matched
            lo = np.minimum(lo, np.where(matched, mn, lo))
            hi = np.maximum(hi, np.where(matched, mx, hi))
        sel = np.nonzero(ok)[0]
        if sel.size == 0:
            return Matches()
        doc, start = self._split_g(lo[sel])
        doc2, end = self._split_g(hi[sel])
        score = _span_scores(idf_sum, start, end, m)
        return Matches(doc, start, end, score)


class InvertedIndexEngine(_BaseEngine):
    """Idx1 baseline: ordinary inverted file only, no NSW/(w,v)/(f,s,t)."""

    def search_sub(self, sub: SubQuery, meter: ByteMeter) -> Matches:
        ids = sub.lemma_ids
        if any(l == UNKNOWN_FL for l in ids):
            return Matches()
        mult = self._multiplicities(ids)
        uniq = sorted(mult)
        # read full posting lists (the baseline's cost — paper Fig. 6/7)
        lists = {}
        for l in uniq:
            docs, pos = self.index.read_ordinary(l, meter)
            if docs.size == 0:
                return Matches()
            lists[l] = self._g(docs, pos)
        anchor = uniq[0]  # most frequent lemma (smallest FL-number)
        anchor_g = lists[anchor]
        others = []
        a_r = mult[anchor] - 1
        if a_r > 0:
            others.append((anchor_g, a_r + 1))  # r+1 within d incl. itself
        for l in uniq:
            if l != anchor:
                others.append((lists[l], mult[l]))
        idf_sum = sum(self.lex.idf(l) for l in ids)
        m = self._window_match(anchor_g, others, self.index.max_distance, idf_sum, len(ids))
        return m

    def search_ids(self, lemma_ids: list[int]) -> tuple[Matches, QueryStats]:
        meter = ByteMeter()
        t0 = time.perf_counter()
        sub = SubQuery(lemma_ids=list(lemma_ids), qtype=QueryType.QT1)
        res = self.search_sub(sub, meter).dedup_topk(self.top_k)
        dt = time.perf_counter() - t0
        return res, QueryStats(meter.postings_read, meter.bytes_read, dt, res.size)


class ProximitySearchEngine(_BaseEngine):
    """The paper's engine over Idx2..Idx4 (ordinary+NSW, (w,v), (f,s,t))."""

    def __init__(self, index: ProximityIndex, top_k: int = 100, equalize_mode: str = "heap"):
        super().__init__(index, top_k)
        assert equalize_mode in ("heap", "basic", "bulk")
        self.equalize_mode = equalize_mode

    # ---------------- QT1: three-component keys -------------------------
    def _qt1(self, sub: SubQuery, meter: ByteMeter) -> Matches:
        ids = sub.lemma_ids
        if len(ids) < 3:
            # degenerate short queries: fall back to ordinary-index search
            return self._ordinary_window(ids, meter)
        if len(ids) > self.index.max_distance:
            # paper §4: queries longer than MaxDistance are split into parts
            parts = [ids[i : i + self.index.max_distance] for i in range(0, len(ids), self.index.max_distance)]
            return Matches.concat([self._qt1(SubQuery(p, QueryType.QT1), meter) for p in parts if len(p) >= 1])
        _, keys = select_fst_keys(ids)
        key_cols = []
        for key in keys:
            if self.index.fst is None or key not in self.index.fst:
                return Matches()
            docs, pf, o1, o2 = self.index.read_fst(key, meter)
            key_cols.append((docs, pf, o1, o2))
        idf_sum = sum(self.lex.idf(l) for l in ids)
        if self.equalize_mode == "bulk":
            return self._qt1_bulk(key_cols, idf_sum, len(ids))
        return self._qt1_iter(key_cols, idf_sum, len(ids))

    def _qt1_bulk(self, key_cols, idf_sum: float, m: int) -> Matches:
        """Vectorized join on (doc, P_f) across keys — mirrors the device path."""
        g0 = None
        lo = hi = None
        for docs, pf, o1, o2 in key_cols:
            g = self._g(docs, pf)
            klo = pf + np.minimum(np.minimum(o1, o2), 0)
            khi = pf + np.maximum(np.maximum(o1, o2), 0)
            if g0 is None:
                g0, lo, hi = g, klo, khi
            else:
                common, ia, ib = np.intersect1d(g0, g, return_indices=True)
                g0 = common
                lo = np.minimum(lo[ia], klo[ib])
                hi = np.maximum(hi[ia], khi[ib])
            if g0.size == 0:
                return Matches()
        doc = g0 // self.stride
        return Matches(doc, lo, hi, _span_scores(idf_sum, lo, hi, m))

    def _qt1_iter(self, key_cols, idf_sum: float, m: int) -> Matches:
        """Paper §2.2-2.3: iterators + Equalize (heap or basic), then per-
        document intersection on P_f."""
        iters = [
            PostingIterator(docs, pf, payload=(o1, o2))
            for docs, pf, o1, o2 in key_cols
        ]
        state = EqualizeState(iters) if self.equalize_mode == "heap" else None
        out: list[Matches] = []
        while True:
            if state is not None:
                doc = state.equalize()
            else:
                doc = equalize_basic(iters)
            if doc is None:
                break
            # in-document join on P_f
            pf0 = None
            lo = hi = None
            for it in iters:
                _, sl = it.doc_slice()
                pf = it.positions[sl]
                o1, o2 = it.payload[0][sl], it.payload[1][sl]
                klo = pf + np.minimum(np.minimum(o1, o2), 0)
                khi = pf + np.maximum(np.maximum(o1, o2), 0)
                if pf0 is None:
                    pf0, lo, hi = pf, klo, khi
                else:
                    common, ia, ib = np.intersect1d(pf0, pf, return_indices=True)
                    pf0 = common
                    lo = np.minimum(lo[ia], klo[ib])
                    hi = np.maximum(hi[ia], khi[ib])
            if pf0 is not None and pf0.size:
                docs_arr = np.full(pf0.size, doc, np.int64)
                out.append(
                    Matches(docs_arr, lo, hi, _span_scores(idf_sum, lo, hi, m))
                )
            if state is not None:
                state.advance_all_past_doc()
            else:
                for it in iters:
                    if not it.exhausted and it.value_id == doc:
                        it.advance_past_doc()
        return Matches.concat(out)

    # ---------------- QT2: two-component keys ----------------------------
    def _qt2(self, sub: SubQuery, meter: ByteMeter) -> Matches:
        ids = sub.lemma_ids
        keys = select_wv_keys(ids)
        d = self.index.max_distance
        pair_items = []  # (sorted start g, aligned end g)
        for key in keys:
            if self.index.wv is None or key not in self.index.wv:
                return Matches()
            docs, pw, off = self.index.read_wv(key, meter)
            ga = self._g(docs, pw)
            gb = ga + off
            lo = np.minimum(ga, gb)
            hi = np.maximum(ga, gb)
            order = np.argsort(lo, kind="stable")
            pair_items.append((lo[order], hi[order]))
        idf_sum = sum(self.lex.idf(l) for l in ids)
        return self._join_intervals(pair_items, d, idf_sum, len(ids))

    def _join_intervals(self, items, d: int, idf_sum: float, m: int) -> Matches:
        """Anchor on the sparsest interval list; for every anchor interval
        pick the nearest interval of each other list whose start is within
        2*MaxDistance; all chosen intervals merge into the fragment."""
        order = np.argsort([it[0].size for it in items])
        items = [items[i] for i in order]
        a_lo, a_hi = items[0]
        ok = np.ones(a_lo.size, bool)
        lo, hi = a_lo.copy(), a_hi.copy()
        for b_lo, b_hi in items[1:]:
            matched, mn, _ = _nearest_r(b_lo, a_lo, 2 * d, 1)
            # recover the matched interval's end via searchsorted on starts
            j = np.searchsorted(b_lo, mn)
            j = np.clip(j, 0, b_lo.size - 1)
            ok &= matched
            lo = np.minimum(lo, np.where(matched, mn, lo))
            hi = np.maximum(hi, np.where(matched, b_hi[j], hi))
        sel = np.nonzero(ok)[0]
        if sel.size == 0:
            return Matches()
        doc, start = self._split_g(lo[sel])
        _, end = self._split_g(hi[sel])
        return Matches(doc, start, end, _span_scores(idf_sum, start, end, m))

    # ---------------- QT3/QT4: ordinary index, NSW skipped ---------------
    def _ordinary_window(self, ids: list[int], meter: ByteMeter) -> Matches:
        """Ordinary-index window scan (QT3/QT4 and the short-QT1
        fallback): every lemma through its ordinary posting list,
        r-nearest-windowed around the anchor. Consumes the shared
        ``query.qt34_plan`` — the same decomposition the device packer
        (``torch_search.pack_qt34_batch``) and the serving router use — so
        the scalar and compiled paths cannot drift (DESIGN.md §13)."""
        anchor, other_plan, _ = qt34_plan(self.index, ids)
        a_docs, a_pos = self.index.read_ordinary(anchor, meter)
        if a_docs.size == 0:
            return Matches()
        anchor_g = self._g(a_docs, a_pos)
        others = []
        for l, r in other_plan:
            if l == anchor:
                others.append((anchor_g, r))
                continue
            docs, pos = self.index.read_ordinary(l, meter)
            if docs.size == 0:
                return Matches()
            others.append((self._g(docs, pos), r))
        idf_sum = sum(self.lex.idf(l) for l in ids)
        return self._window_match(
            anchor_g, others, self.index.max_distance, idf_sum, len(ids)
        )

    def _qt3(self, sub: SubQuery, meter: ByteMeter) -> Matches:
        return self._ordinary_window(sub.lemma_ids, meter)

    def _qt4(self, sub: SubQuery, meter: ByteMeter) -> Matches:
        return self._ordinary_window(sub.lemma_ids, meter)

    # ---------------- QT5: NSW records ------------------------------------
    def _qt5(self, sub: SubQuery, meter: ByteMeter) -> Matches:
        ids = sub.lemma_ids
        d = self.index.max_distance
        # anchor / constraint selection is shared with the compiled serve
        # path (query.qt5_plan) so the two engines cannot drift: anchor =
        # the rarest non-stop lemma (deterministic tie-break by id)
        plan = qt5_plan(self.index, ids)
        if plan is None:
            return Matches()
        anchor, other_plan, stops, _ = plan
        a_docs, a_pos = self.index.read_ordinary(anchor, meter)
        if a_docs.size == 0:
            return Matches()
        a_g = self._g(a_docs, a_pos)
        # other non-stop lemmas: ordinary window around the anchor
        others = []
        for l, r in other_plan:
            if l == anchor:
                others.append((a_g, r))
                continue
            docs, pos = self.index.read_ordinary(l, meter)
            if docs.size == 0:
                return Matches()
            others.append((self._g(docs, pos), r))
        ok = np.ones(a_g.size, bool)
        lo = a_g.copy()
        hi = a_g.copy()
        for g_sorted, r in others:
            matched, mn, mx = _nearest_r(g_sorted, a_g, d, r)
            ok &= matched
            lo = np.minimum(lo, np.where(matched, mn, lo))
            hi = np.maximum(hi, np.where(matched, mx, hi))
        # stop lemmas: resolved from the anchor's NSW records — the paper's
        # point: no stop-lemma posting list is ever read.
        rows, fls, offs = self.index.nsw.read(anchor, meter)
        keep = np.abs(offs) <= d
        rows, fls, offs = rows[keep], fls[keep], offs[keep]
        for sid, r in stops:
            sel = fls == sid
            r_rows = rows[sel]
            r_offs = offs[sel]
            cnt = np.bincount(r_rows, minlength=a_g.size)
            ok &= cnt >= r
            # fragment extension: nearest offsets per row
            order = np.lexsort((np.abs(r_offs), r_rows))
            rr, ro = r_rows[order], r_offs[order]
            first = np.ones(rr.size, bool)
            first[1:] = rr[1:] != rr[:-1]
            ext = np.zeros(a_g.size, np.int64)
            ext[rr[first]] = ro[first]
            lo = np.minimum(lo, a_g + np.minimum(ext, 0))
            hi = np.maximum(hi, a_g + np.maximum(ext, 0))
        sel = np.nonzero(ok)[0]
        if sel.size == 0:
            return Matches()
        doc, start = self._split_g(lo[sel])
        _, end = self._split_g(hi[sel])
        idf_sum = sum(self.lex.idf(l) for l in ids)
        return Matches(doc, start, end, _span_scores(idf_sum, start, end, len(ids)))

    # ---------------- dispatch -------------------------------------------
    def search_sub(self, sub: SubQuery, meter: ByteMeter) -> Matches:
        if any(l == UNKNOWN_FL for l in sub.lemma_ids):
            return Matches()
        if sub.qtype == QueryType.QT1:
            return self._qt1(sub, meter)
        if sub.qtype == QueryType.QT2:
            return self._qt2(sub, meter)
        if sub.qtype == QueryType.QT3:
            return self._qt3(sub, meter)
        if sub.qtype == QueryType.QT4:
            return self._qt4(sub, meter)
        return self._qt5(sub, meter)

    def search_ids(self, lemma_ids: list[int]) -> tuple[Matches, QueryStats]:
        from repro_torch.core.query import classify

        meter = ByteMeter()
        t0 = time.perf_counter()
        sub = SubQuery(lemma_ids=list(lemma_ids), qtype=classify(list(lemma_ids), self.lex))
        res = self.search_sub(sub, meter).dedup_topk(self.top_k)
        dt = time.perf_counter() - t0
        return res, QueryStats(meter.postings_read, meter.bytes_read, dt, res.size)

    def search(self, text: str) -> tuple[Matches, QueryStats]:
        """Full pipeline of Table 1: lemmatize -> sub-queries -> evaluate ->
        combine, sorted by relevance."""
        meter = ByteMeter()
        t0 = time.perf_counter()
        subs = build_subqueries(text, self.lex)
        parts = [self.search_sub(s, meter) for s in subs]
        res = Matches.concat(parts).dedup_topk(self.top_k)
        dt = time.perf_counter() - t0
        return res, QueryStats(meter.postings_read, meter.bytes_read, dt, res.size)
