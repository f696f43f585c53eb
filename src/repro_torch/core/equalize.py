"""Posting iterators and the Equalize procedure (paper §2.2-2.3).

Three interchangeable implementations, all tested for agreement:

* ``equalize_basic`` — the linear-scan variant from [10]: find the min and
  max iterator by scanning, advance the min until all equal; O(n)/step;
* ``EqualizeState`` (two binary heaps) — the *paper's contribution*:
  O(log n)/step inner loop (§2.3.4);
* ``bulk_align_docs`` — the vectorized (numpy) equivalent used by the Idx1
  baseline (which must consume millions of postings per query; a per-
  posting Python loop would be unfair to the baseline) and as the stepping
  stone to the batched device engine in torch_search.py.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.heaps import IteratorHeap

_EXHAUSTED = np.iinfo(np.int64).max


class PostingIterator:
    """Paper §2.2 iterator: IT.next(), IT.value == (ID, P) + payload.

    Reads a decoded posting list (docs/positions [+ payload columns]) from
    start to end; ``value_id`` is the current doc id, exhausted iterators
    report value_id == +inf so heap-based Equalize naturally terminates.
    """

    __slots__ = ("docs", "positions", "payload", "cursor", "min_index", "max_index", "label")

    def __init__(self, docs: np.ndarray, positions: np.ndarray, payload: tuple = (), label=None):
        self.docs = docs
        self.positions = positions
        self.payload = payload
        self.cursor = 0
        self.min_index = 0
        self.max_index = 0
        self.label = label

    @property
    def value_id(self) -> int:
        return int(self.docs[self.cursor]) if self.cursor < self.docs.size else _EXHAUSTED

    @property
    def exhausted(self) -> bool:
        return self.cursor >= self.docs.size

    def next(self) -> bool:
        self.cursor += 1
        return self.cursor < self.docs.size

    def skip_to_doc(self, doc: int) -> None:
        """Galloping skip: advance cursor to the first posting with id>=doc."""
        self.cursor += int(np.searchsorted(self.docs[self.cursor :], doc, side="left"))

    def doc_slice(self) -> tuple[int, slice]:
        """(current doc, slice of postings belonging to it); cursor unmoved."""
        doc = self.value_id
        end = self.cursor + int(
            np.searchsorted(self.docs[self.cursor :], doc, side="right")
        )
        return doc, slice(self.cursor, end)

    def advance_past_doc(self) -> bool:
        doc, sl = self.doc_slice()
        self.cursor = sl.stop
        return self.cursor < self.docs.size


def equalize_basic(iterators: list[PostingIterator]) -> int | None:
    """Linear-scan Equalize from [10]: returns the aligned doc id, or None
    if some iterator is exhausted."""
    while True:
        ids = [it.value_id for it in iterators]
        mx = max(ids)
        if mx == _EXHAUSTED:
            return None
        mn = min(ids)
        if mn == mx:
            return mn
        it = iterators[ids.index(mn)]
        it.skip_to_doc(mx)  # galloping variant of repeated next()
        if it.exhausted:
            return None


class EqualizeState:
    """Paper §2.3.4: Equalize with MinHeap + MaxHeap.

    Usage::
        st = EqualizeState(iterators)
        while (doc := st.equalize()) is not None:
            ... consume doc on all iterators ...
            st.advance_all_past_doc()
    """

    def __init__(self, iterators: list[PostingIterator]):
        self.iterators = iterators
        n = len(iterators)
        self.min_heap = IteratorHeap(n, "min")
        self.max_heap = IteratorHeap(n, "max")
        for it in iterators:
            self.min_heap.insert(it)
            self.max_heap.insert(it)

    def _update(self, it: PostingIterator) -> None:
        self.min_heap.update(it.min_index)
        self.max_heap.update(it.max_index)

    def equalize(self, gallop: bool = True) -> int | None:
        """Steps 1-7 of §2.3.4. With gallop=True the advance uses
        skip_to_doc(max) instead of repeated next() — same result, fewer
        iterations (a beyond-paper micro-optimization, measured in
        benchmarks/equalize_scaling.py)."""
        while True:
            lo_it = self.min_heap.get_min()
            hi_it = self.max_heap.get_min()
            if lo_it.value_id == hi_it.value_id:
                if lo_it.value_id == _EXHAUSTED:
                    return None
                return lo_it.value_id
            if gallop:
                lo_it.skip_to_doc(hi_it.value_id)
            else:
                lo_it.next()
            if lo_it.exhausted:
                return None
            self._update(lo_it)

    def advance_all_past_doc(self) -> None:
        """After a doc has been consumed, move every iterator past it."""
        doc = self.min_heap.get_min().value_id
        for it in self.iterators:
            if not it.exhausted and it.value_id == doc:
                it.advance_past_doc()
                self._update(it)


def bulk_align_docs(doc_arrays: list[np.ndarray]) -> np.ndarray:
    """Vectorized Equalize: doc ids present in *all* sorted arrays.

    Semantically identical to iterating Equalize over every aligned doc;
    runs at numpy speed. Used by the Idx1 baseline engine and mirrored by
    the batched device membership join of torch_search.py."""
    if not doc_arrays:
        return np.zeros(0, np.int64)
    common = np.unique(doc_arrays[0])
    for arr in doc_arrays[1:]:
        if common.size == 0:
            break
        # intersect1d(assume_unique) after unique'ing the incoming side
        common = np.intersect1d(common, np.unique(arr), assume_unique=True)
    return common
