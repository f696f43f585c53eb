"""Binary heaps over posting iterators — paper §2.3.

Faithful to the paper: two heaps (MinHeap ordered by ascending Value.ID,
MaxHeap by descending Value.ID) hold *pointers* to the same iterator
objects; every iterator carries back-pointer fields `min_index` /
`max_index` that the heaps keep up to date inside Insert and Update
(paper §2.3.3), so that after `it.next()` both heaps can reposition the
iterator in O(log n) via `Update(it.min_index)` / `Update(it.max_index)`.

Arrays are 1-indexed as in the paper (H[i] <= H[2i], H[2i+1]).
"""

from __future__ import annotations


class IteratorHeap:
    """Paper §2.3.2-2.3.3. kind='min' orders by ascending doc id,
    kind='max' by descending doc id."""

    def __init__(self, max_count: int, kind: str = "min"):
        assert kind in ("min", "max")
        self.kind = kind
        self.index_attr = "min_index" if kind == "min" else "max_index"
        self.heap: list = [None] * (max_count + 1)  # 1-indexed
        self.count = 0

    # comparison: MinHeap: A < B iff A.ID < B.ID; MaxHeap: A < B iff A.ID > B.ID
    def _less(self, a, b) -> bool:
        if self.kind == "min":
            return a.value_id < b.value_id
        return a.value_id > b.value_id

    def _set(self, i: int, it) -> None:
        self.heap[i] = it
        setattr(it, self.index_attr, i)

    def insert(self, it) -> None:
        """Paper §2.3.3 steps 1-5 (sift-up maintaining the index field)."""
        self.count += 1
        self._set(self.count, it)
        i = self.count
        while i > 1 and self._less(self.heap[i], self.heap[i // 2]):
            t, q = self.heap[i], self.heap[i // 2]
            self._set(i // 2, t)
            self._set(i, q)
            i //= 2

    def get_min(self):
        """Top of the heap: min doc id for MinHeap, max for MaxHeap. O(1)."""
        return self.heap[1]

    def update(self, i: int) -> None:
        """Reposition element i after its iterator advanced. O(log n)."""
        # sift up
        while i > 1 and self._less(self.heap[i], self.heap[i // 2]):
            t, q = self.heap[i], self.heap[i // 2]
            self._set(i // 2, t)
            self._set(i, q)
            i //= 2
        # sift down
        while True:
            l, r = 2 * i, 2 * i + 1
            smallest = i
            if l <= self.count and self._less(self.heap[l], self.heap[smallest]):
                smallest = l
            if r <= self.count and self._less(self.heap[r], self.heap[smallest]):
                smallest = r
            if smallest == i:
                return
            t, q = self.heap[smallest], self.heap[i]
            self._set(i, t)
            self._set(smallest, q)
            i = smallest

    def check_invariant(self) -> bool:
        """Heap property + back-pointer consistency (used by property tests)."""
        for i in range(1, self.count + 1):
            it = self.heap[i]
            if getattr(it, self.index_attr) != i:
                return False
            for c in (2 * i, 2 * i + 1):
                if c <= self.count and self._less(self.heap[c], self.heap[i]):
                    return False
        return True
