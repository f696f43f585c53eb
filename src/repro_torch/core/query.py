"""Query parsing, sub-query expansion and QT1-QT5 typing (paper §1.2, §2.1).

Phase 1-2 of Table 1: lemmatization yields per-word lemma alternatives;
the sub-query list is the cartesian product over alternatives ("who are
you who" -> Q1 [who are you who], Q2 [who be you who]); each sub-query is
typed by the lemma classes it contains.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from enum import IntEnum

import numpy as np

from repro_torch.core.lemmatizer import lemmatize_text
from repro_torch.core.lexicon import Lexicon, LemmaType, UNKNOWN_FL


class QueryType(IntEnum):
    QT1 = 1  # all stop lemmas
    QT2 = 2  # all frequently used
    QT3 = 3  # all ordinary
    QT4 = 4  # frequently used + ordinary, no stop
    QT5 = 5  # stop lemmas plus frequently used and/or ordinary


@dataclass
class SubQuery:
    lemma_ids: list[int]
    qtype: QueryType

    def __len__(self) -> int:
        return len(self.lemma_ids)


def classify(lemma_ids: list[int], lexicon: Lexicon) -> QueryType:
    types = {lexicon.type_of_id(l) for l in lemma_ids}
    if types == {LemmaType.STOP}:
        return QueryType.QT1
    if types == {LemmaType.FREQUENT}:
        return QueryType.QT2
    if types == {LemmaType.ORDINARY}:
        return QueryType.QT3
    if LemmaType.STOP not in types:
        return QueryType.QT4
    return QueryType.QT5


def build_subqueries(
    text: str,
    lexicon: Lexicon,
    max_subqueries: int = 16,
) -> list[SubQuery]:
    """Phases 1-2 of the search algorithm (paper Table 1)."""
    alts_per_word = lemmatize_text(text)
    if not alts_per_word:
        return []
    id_alts: list[list[int]] = []
    for alts in alts_per_word:
        ids = [lexicon.fl(a) for a in alts]
        ids = [i for i in ids if i != UNKNOWN_FL] or [UNKNOWN_FL]
        id_alts.append(ids)
    subs = []
    for combo in itertools.islice(itertools.product(*id_alts), max_subqueries):
        subs.append(SubQuery(lemma_ids=list(combo), qtype=classify(list(combo), lexicon)))
    return subs


def subqueries_from_ids(lemma_ids: list[int], lexicon: Lexicon) -> list[SubQuery]:
    """For synthetic-corpus experiments where queries are lemma-id lists."""
    return [SubQuery(lemma_ids=list(lemma_ids), qtype=classify(list(lemma_ids), lexicon))]


def select_fst_keys(lemma_ids: list[int]) -> tuple[int, list[tuple[int, int, int]]]:
    """QT1 index selection (paper §2.2; rule fixed in DESIGN.md §9).

    Anchor f := the most frequent lemma (smallest FL-number). The remaining
    multiset is covered by (s,t) pairs such that each key's requirement
    matches the query's per-lemma multiplicities:

    * lemmas occurring twice+ are paired with themselves first — an (l,l)
      key demands two *distinct* occurrences of l near the anchor;
    * distinct leftovers are paired with each other (ascending FL);
    * a final odd leftover is paired with an already-covered lemma (which
      adds no spurious multiplicity requirement).

    Reproduces the paper's example: [who,are,you,who] -> anchor=you,
    keys (you,are,who), (you,who,who). Lemma multiplicities >= 3 are
    under-required by one (pair keys can demand at most 2) — same
    approximation level as the paper's index.
    """
    ids = sorted(lemma_ids)
    f = ids[0]
    rest = ids[1:]
    if not rest:
        rest = [f]
    mult: dict[int, int] = {}
    for l in rest:
        mult[l] = mult.get(l, 0) + 1
    pairs: list[tuple[int, int]] = []
    leftovers: list[int] = []
    for l in sorted(mult):
        m = mult[l]
        pairs.extend([(l, l)] * (m // 2))
        if m % 2 == 1:
            leftovers.append(l)
    for i in range(0, len(leftovers) - 1, 2):
        pairs.append((leftovers[i], leftovers[i + 1]))
    if len(leftovers) % 2 == 1:
        last = leftovers[-1]
        covered = [l for p in pairs for l in p if l != last]
        partner = covered[0] if covered else last
        a, b = (partner, last) if partner <= last else (last, partner)
        pairs.append((a, b))
    keys = []
    for s, t in pairs:
        key = (f, s, t)
        if key not in keys:
            keys.append(key)
    return f, keys


def qt1_plan(index, lemma_ids: list[int]) -> tuple[list[tuple[int, int, int]], int]:
    """The QT1 per-query decomposition consumed by the serving planner
    and the device packer (the ``qt5_plan`` precedent, completing the
    per-type plan family qt1/qt2/qt34/qt5). Returns (keys, longest):
    keys = the (f,s,t) cover of :func:`select_fst_keys`; longest = the
    largest live posting count among them (what the planner sizes the
    L-bucket by — absent keys count 0)."""
    _, keys = select_fst_keys(list(lemma_ids))
    fst = index.fst
    longest = 0
    for key in keys:
        if fst is not None and key in fst:
            longest = max(longest, fst.n_postings(key))
    return keys, longest


def qt2_plan(index, lemma_ids) -> tuple[list[tuple[int, int]], int]:
    """The QT2 per-query decomposition: :func:`select_wv_keys` ordered
    sparsest-first by live posting count — the CPU engine anchors its
    interval join on the smallest list, and its np.argsort tie-break is
    reproduced by sorting the same size array the same way (absent keys
    count 0: they sort first, and an all-padding anchor yields the CPU's
    any-key-absent empty result). Returns (ordered keys, longest posting
    count) — the second element is what the serving planner sizes the
    L-bucket by, so planner and packer share one derivation."""
    keys = select_wv_keys(list(lemma_ids))
    wv = index.wv
    sizes = np.array(
        [wv.n_postings(k) if wv is not None and k in wv else 0 for k in keys],
        np.int64,
    )
    order = np.argsort(sizes)
    return [keys[i] for i in order], int(sizes.max(initial=0))


def qt5_plan(index, lemma_ids: list[int]):
    """The QT5 decomposition shared by the CPU engine
    (``search.ProximitySearchEngine._qt5``), the device packer
    (``torch_search.pack_qt5_batch``) and the serving router — one copy so
    the compiled and scalar paths cannot drift. Returns (anchor, others,
    stops, counts): anchor = the rarest non-stop lemma (tie-break by
    id); others = [(lemma, multiplicity), ...] ordinary-window
    constraints — the anchor itself included when its multiplicity > 1 —
    ordered sparsest-first by live posting count (tie-break by id, the
    early-mask join order of DESIGN.md §16); stops = [(stop lemma,
    multiplicity), ...] NSW constraints sorted by id; counts = live
    posting counts of the non-stop lemmas. None for degenerate queries
    (no stop or no non-stop lemma)."""
    sw = index.lexicon.sw_count
    ids = list(lemma_ids)
    stop = [l for l in ids if l < sw]
    nonstop = [l for l in ids if l >= sw]
    if not nonstop or not stop:
        return None
    counts = {l: index.ordinary.n_postings(l) for l in set(nonstop)}
    anchor = min(sorted(set(nonstop)), key=lambda l: (counts[l], l))
    mult_ns: dict[int, int] = {}
    for l in nonstop:
        mult_ns[l] = mult_ns.get(l, 0) + 1
    # Sparsest-first join order (arXiv 2009.02684): rarer constraint rows
    # invalidate more anchor lanes earlier, so the fused join's early-mask
    # skips work for the denser keys. The join's AND/min/max accumulation
    # is order-independent, so CPU/device results are unchanged.
    cons = [l for l in mult_ns if l != anchor or mult_ns[l] > 1]
    others = [(l, mult_ns[l])
              for l in sorted(cons, key=lambda l: (counts[l], l))]
    mult_st: dict[int, int] = {}
    for l in stop:
        mult_st[l] = mult_st.get(l, 0) + 1
    return anchor, others, sorted(mult_st.items()), counts


def qt34_plan(index, lemma_ids: list[int]):
    """The QT3/QT4 ordinary-window decomposition shared by the CPU engine
    (``search.ProximitySearchEngine._ordinary_window``), the device packer
    (``torch_search.pack_qt34_batch``) and the serving router — one copy so
    the compiled and scalar paths cannot drift (the ``qt5_plan``
    precedent). Returns (anchor, others, counts): anchor = the most
    frequent lemma (smallest FL-number, the uniform anchor rule of
    DESIGN.md §9); others = [(lemma, multiplicity), ...] window
    constraints — the anchor itself included when its multiplicity > 1 —
    ordered sparsest-first by live posting count (tie-break by FL, the
    early-mask join order of DESIGN.md §16); counts = live ordinary
    posting counts per distinct lemma (what the serving router sizes the
    L-bucket by)."""
    ids = list(lemma_ids)
    mult: dict[int, int] = {}
    for l in ids:
        mult[l] = mult.get(l, 0) + 1
    uniq = sorted(mult)
    anchor = uniq[0]
    counts = {l: index.ordinary.n_postings(l) for l in uniq}
    # Sparsest-first join order — see qt5_plan; results are unchanged
    # because the join accumulation is order-independent.
    cons = [l for l in uniq if l != anchor or mult[l] > 1]
    others = [(l, mult[l]) for l in sorted(cons, key=lambda l: (counts[l], l))]
    return anchor, others, counts


def select_wv_keys(lemma_ids: list[int]) -> list[tuple[int, int]]:
    """QT2 pair covering: sort ascending by FL, pair consecutive lemmas;
    odd count pairs the leftover with the most frequent lemma."""
    ids = sorted(lemma_ids)
    keys = []
    for i in range(0, len(ids) - 1, 2):
        keys.append((ids[i], ids[i + 1]))
    if len(ids) % 2 == 1:
        a, b = ids[0], ids[-1]
        keys.append((a, b) if a <= b else (b, a))
    return keys
