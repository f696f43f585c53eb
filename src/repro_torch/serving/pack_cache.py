"""Packed-posting serve cache (DESIGN.md §11-§12).

The paper's premise is that *frequently occurring* words dominate the
query stream — which makes the serve path's host-side packing worst
exactly where traffic is hottest: every drain re-read and re-padded the
postings of the same few hot keys. ``PackedPostingCache`` memoizes the
fully padded, range-partitioned device rows that the per-key packers in
``core.torch_search`` derive for one key at one (L, doc_shards) bucket, so
packing a batch degenerates to B*K row copies.

Row kinds (one cache instance can hold any mix; entries are keyed by
``(kind, key, L, doc_shards)``):

* ``"fst"`` — (g, lo, hi) rows of one (f,s,t) key (QT1);
* ``"wv"``  — (lo, hi) interval rows of one (w,v) key (QT2);
* ``"ord"`` — the g row of one lemma's ordinary postings, shared by the
  QT3/QT4 ordinary-window path and the QT5 anchor/non-stop streams: a
  lemma hot on either path warms both (DESIGN.md §13);
* ``"nsw"`` — (cnt, ext) NSW aggregates of one (anchor, stop) pair (QT5).

The block-delta16-compressed kinds arrive with the compressed-payload
slice of the port.

Invalidation rule: entries are valid only for the snapshot they were
packed against. The cache tracks a single current ``snapshot_token``
(``repro_torch.index.segmented.snapshot_token``); the first lookup against a
*different* snapshot invalidates — but across a **benign** transition,
entries whose key no *fresh* segment touches are *retained* instead of
dropped: the merged rows of an untouched key are bitwise identical
across such snapshots. Benign covers add-only refreshes (fresh = the
newly sealed segments), **pure background compactions** (a merge output
whose ``derived_from`` lineage lies inside the old segment set and whose
doc set is exactly its victims' minus the old tombstones contributes
*no* fresh segments — global doc ids are merge-stable, so rows are
bitwise unchanged; DESIGN.md §18), dead-segment drops, and live memtable
overlays (fresh = the overlay). Any other transition (new deletes,
stride growth, unprovable lineage) clears everything, so a stale row can
never be served.

Bounded by both an entry count and a byte budget (LRU eviction); hits,
misses, evictions, invalidations, retentions and resident bytes are
surfaced via ``.stats`` and re-exported in ``SearchService.stats``.
Given a :class:`repro_torch.obs.MetricsRegistry` (``metrics=``, with a
``scope`` name prefix), the cache additionally streams hit/miss
counters, a resident-bytes gauge and a per-miss derivation-time
histogram into it (DESIGN.md §15) — the same registry the serving
phases land in, so a drain's pack phase can be decomposed into cache
hits vs row derivations.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np

from repro_torch.core.torch_search import (
    pack_fst_key_rows,
    pack_nsw_key_rows,
    pack_ord_key_rows,
    pack_wv_key_rows,
    qt1_stride,
)
from repro_torch.index.merge import isin_sorted
from repro_torch.index.segmented import snapshot_token
from repro_torch.kernels.common import SENTINEL

_DERIVERS = {
    "fst": pack_fst_key_rows,
    "wv": pack_wv_key_rows,
    "ord": pack_ord_key_rows,
    "nsw": pack_nsw_key_rows,
}


def _key_in_segment(kind: str, key, seg_index) -> bool:
    """Whether a segment's index could contribute postings to this entry
    (the add-only retention test). NSW aggregates are keyed by the anchor
    lemma: new anchor postings change both the row length and the
    renumbering, while a segment without the anchor cannot add records."""
    if kind == "fst":
        store = seg_index.fst
    elif kind == "wv":
        store = seg_index.wv
    elif kind == "ord":
        store = seg_index.ordinary
    else:  # "nsw": key = (anchor, sid)
        store = seg_index.ordinary
        key = key[0]
    return store is not None and key in store


class PackedPostingCache:
    """LRU cache of padded per-key device rows for one snapshot."""

    def __init__(self, max_entries: int = 4096, max_bytes: int = 256 << 20,
                 metrics=None, scope: str = "cache"):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._metrics = metrics  # optional repro_torch.obs.MetricsRegistry
        self._scope = scope
        self._entries: OrderedDict = OrderedDict()  # positive: ck -> (rows, nbytes)
        self._absent: OrderedDict = OrderedDict()  # negative: ck -> rows
        self._token = None
        self._token_ref = None  # keeps the token's index alive (id() reuse)
        self._bytes = 0
        self._sentinel_rows: dict = {}  # (kind, L) -> shared padding rows
        self._lock = threading.Lock()
        self._counts = {"hits": 0, "misses": 0, "evictions": 0,
                        "invalidations": 0, "retained": 0}

    # -- lookups ----------------------------------------------------------
    def get_rows(self, index, key, L: int, doc_shards: int = 1, stride: int | None = None):
        """Padded ``(g, lo, hi, present)`` device rows of one (f,s,t) key.

        The original QT1 entry point — shorthand for
        ``get(index, "fst", key, L, doc_shards, stride)``; see
        :meth:`get` for the lookup/invalidation contract. ``key`` is a
        ``(f, s, t)`` lemma-id triple; the three ``(L,)`` int32 rows are
        read-only and shared across batches, and ``present`` is False
        when the key does not exist in the snapshot (the rows are then a
        shared all-SENTINEL padding set)."""
        return self.get(index, "fst", key, L, doc_shards, stride)

    def get(self, index, kind: str, key, L: int, doc_shards: int = 1,
            stride: int | None = None):
        """Rows for `key` at bucket (L, doc_shards), packed against
        `index`'s current snapshot. The returned tuple matches the kind's
        packer contract and ends with a present flag; arrays
        are read-only (shared across batches; absent keys alias one
        padding row set per (kind, L)). `stride` (snapshot-constant)
        avoids an O(n_docs) re-derivation per miss when the caller
        already has it."""
        # pin the immutable snapshot FIRST: given a mutable SegmentedIndex,
        # token and row derivation must see the same view even if a
        # refresh() publishes a new one mid-derivation
        if hasattr(index, "snapshot"):
            index = index.snapshot()
        tok = snapshot_token(index)
        ck = (kind, key, L, doc_shards)
        with self._lock:
            if tok != self._token:
                if self._entries or self._absent:
                    self._counts["invalidations"] += 1
                    self._retain_or_clear(index)
                self._token = tok
                # pin the token's index: for static indexes the token is
                # id(), which must not be freed and reused while entries
                # keyed under it are resident
                self._token_ref = index
            ent = self._entries.get(ck)
            if ent is not None:
                self._entries.move_to_end(ck)
                self._counts["hits"] += 1
                if self._metrics is not None:
                    self._metrics.inc(f"{self._scope}.hits")
                return ent[0]
            neg = self._absent.get(ck)
            if neg is not None:
                self._absent.move_to_end(ck)
                self._counts["hits"] += 1
                if self._metrics is not None:
                    self._metrics.inc(f"{self._scope}.hits")
                return neg
            self._counts["misses"] += 1
        # derive outside the lock: merged segment reads can be slow and
        # must not serialize concurrent serving threads
        t_derive = time.perf_counter()
        rows = self._derive(index, kind, key, L, doc_shards, stride)
        if self._metrics is not None:
            self._metrics.inc(f"{self._scope}.misses")
            self._metrics.observe(f"{self._scope}.derive_us",
                                  (time.perf_counter() - t_derive) * 1e6)
            self._metrics.set(f"{self._scope}.bytes", self._bytes)
        if not rows[-1]:  # not present
            # negative entry: callers never read non-present rows, so they
            # alias one shared per-(kind, L) padding row set (0 bytes) and
            # live in a separate LRU — a stream of distinct absent keys
            # must not evict genuinely hot positive rows
            rows = self._shared_sentinel(kind, L)
            with self._lock:
                if tok != self._token:
                    return rows  # a refresh raced the derivation: don't admit
                self._absent[ck] = rows
                while len(self._absent) > self.max_entries:
                    self._absent.popitem(last=False)
                    self._counts["evictions"] += 1
            return rows
        nbytes = 0
        for a in rows[:-1]:
            if isinstance(a, np.ndarray):
                a.setflags(write=False)
                nbytes += a.nbytes
        with self._lock:
            if tok != self._token:
                return rows  # a refresh raced the derivation: don't admit
            if ck not in self._entries:
                self._entries[ck] = (rows, nbytes)
                self._bytes += nbytes
                while len(self._entries) > self.max_entries or (
                    self._bytes > self.max_bytes and len(self._entries) > 1
                ):
                    _, (_, nb) = self._entries.popitem(last=False)
                    self._bytes -= nb
                    self._counts["evictions"] += 1
        return rows

    def _derive(self, index, kind, key, L, doc_shards, stride):
        return _DERIVERS[kind](index, key, L, doc_shards, stride)

    def _shared_sentinel(self, kind: str, L: int):
        rows = self._sentinel_rows.get((kind, L))
        if rows is None:
            pad = np.full(L, SENTINEL, np.int32)
            zero = np.zeros(L, np.int32)
            if kind == "nsw":
                rows = (zero, zero, False)
            else:
                rows = (pad,) * {"fst": 3, "wv": 2, "ord": 1}[kind] + (False,)
            for a in rows[:-1]:
                a.setflags(write=False)
            self._sentinel_rows[(kind, L)] = rows
        return rows

    # -- invalidation / cross-snapshot retention --------------------------
    def _retain_or_clear(self, new_index) -> None:
        """Called under the lock when the snapshot token changes. When the
        transition is benign (add-only refresh and/or pure background
        compaction, DESIGN.md §18), keep entries whose key no *fresh*
        segment touches; otherwise clear everything."""
        fresh = self._fresh_segments(new_index)
        if fresh is None:
            self._entries.clear()
            self._absent.clear()
            self._bytes = 0
            return
        n_docs_changed = (
            self._token_ref.doc_lengths.size != new_index.doc_lengths.size
        )
        for store in (self._entries, self._absent):
            for ck in list(store.keys()):
                kind, key, L, doc_shards = ck
                # range-partition bounds depend on the total doc count
                stale = doc_shards > 1 and n_docs_changed
                stale = stale or any(
                    _key_in_segment(kind, key, seg.index) for seg in fresh
                )
                if stale:
                    ent = store.pop(ck)
                    if store is self._entries:
                        self._bytes -= ent[1]
                else:
                    self._counts["retained"] += 1

    def _fresh_segments(self, new_index):
        """Classify the snapshot transition: the list of segments that can
        make an entry stale (newly sealed segments + live memtable
        overlays), or None when the transition is not provably benign and
        the cache must clear.

        The merge-aware rules (DESIGN.md §18) rest on two invariants of
        ``repro_torch.index``: global doc ids are stable across compactions, and
        ``merged_key_read`` applies tombstones at read time. A compaction
        output whose immediate lineage (``Segment.derived_from``) lies
        inside the old snapshot's segment set — and whose doc set equals
        exactly its victims' docs minus the *old* tombstones — therefore
        carries bitwise the same merged rows its victims did, so entries
        survive it untouched. Any new tombstone, a stride change, a merge
        that dropped docs the old snapshot still served, or a live old
        segment vanishing un-merged clears the cache."""
        old = self._token_ref
        if old is None or new_index is old:
            return None
        for view in (old, new_index):
            if not (hasattr(view, "segments") and hasattr(view, "tombstones")):
                return None
        old_t, new_t = old.tombstones, new_index.tombstones
        if np.setdiff1d(new_t, old_t).size:
            return None  # new deletes: keys over those docs went stale
        if qt1_stride(old) != qt1_stride(new_index):
            return None  # a longer doc moved every packed g value
        old_overlay = getattr(old, "mem_overlay", None)
        new_overlay = getattr(new_index, "mem_overlay", None)
        old_idents, old_by_id = set(), {}
        for s in old.segments:
            old_idents.add(id(s))
            if s is not old_overlay:
                old_by_id[s.segment_id] = s
        fresh, covered = [], set()
        for s in new_index.segments:
            if id(s) in old_idents:
                continue  # carried over unchanged (identity)
            if s is new_overlay or getattr(s, "is_live", False):
                fresh.append(s)  # overlay stales exactly the keys it holds
                continue
            dfrom = set(getattr(s, "derived_from", ()) or ())
            if dfrom and dfrom <= set(old_by_id):
                victims = [old_by_id[i] for i in dfrom]
                want = np.concatenate([v.doc_map for v in victims])
                want = np.sort(want[~isin_sorted(old_t, want)])
                if np.array_equal(want, s.doc_map):
                    covered |= dfrom  # pure compaction: rows bitwise equal
                    continue
                return None  # merge dropped docs the old snapshot served
            fresh.append(s)  # newly sealed (or unprovable lineage)
        new_idents = {id(s) for s in new_index.segments}
        for s in old.segments:
            if id(s) in new_idents or s.segment_id in covered or s is old_overlay:
                continue
            if not bool(np.all(isin_sorted(old_t, s.doc_map))):
                return None  # a live old segment vanished un-merged
        if old_overlay is not None and id(old_overlay) not in new_idents:
            # entries packed while an overlay was live may embed its
            # postings; they are stale exactly where the overlay had keys
            fresh.append(old_overlay)
        return fresh

    # -- introspection ----------------------------------------------------
    @property
    def stats(self) -> dict:
        with self._lock:
            c = dict(self._counts)
            c["entries"] = len(self._entries)
            c["negative_entries"] = len(self._absent)
            c["bytes"] = self._bytes
        total = c["hits"] + c["misses"]
        c["hit_rate"] = c["hits"] / total if total else 0.0
        return c

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._absent.clear()
            self._bytes = 0
            self._token = None
            self._token_ref = None
