"""Segmented, incrementally-updatable composite index.

``SegmentedIndex`` is the mutable manager: documents stream into a
``MemSegment`` memtable, ``refresh()`` seals it into an immutable
``Segment`` and publishes a new ``SegmentedView`` snapshot; deletes are
tombstones applied at read/merge time; size-tiered compaction keeps the
segment count bounded.

``SegmentedView`` implements the exact read API of
``core.index_builder.ProximityIndex`` (``read_ordinary`` / ``read_wv`` /
``read_fst`` / ``nsw.read`` / ``size_report`` plus the ``ordinary`` /
``wv`` / ``fst`` store attributes, ``lexicon``, ``max_distance``,
``doc_lengths``), so ``InvertedIndexEngine``, ``ProximitySearchEngine``
and the serving path (``serving.SearchService``: the host packers of
``core.torch_search`` and the steps on the card) all run unchanged over a
mutating corpus.

Visibility contract (Lucene-NRT style): reads go through the snapshot
current at engine construction; adds/deletes become visible only after
``refresh()``. Snapshots are immutable, so in-flight batches on an old
snapshot stay consistent while merges run. Doc ids seen by engines are
*global* ids (stable across compactions; deleted ids leave holes).

The FL-list (``Lexicon``) is fixed for the lifetime of the index, as in
the paper: lemma ids are frequency ranks of the reference corpus, and
re-ranking would invalidate every sealed segment.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np

from repro_torch.core.codecs import zigzag_decode
from repro_torch.core.lexicon import Lexicon
from repro_torch.core.postings import ByteMeter
from repro_torch.data.corpus import TokenTable
from repro_torch.index.background import MERGED, NOOP, SUPERSEDED, CompactionExecutor
from repro_torch.index.compaction import leveled_plan, merge_segments, size_tiered_plan
from repro_torch.index.merge import isin_sorted, merged_key_read, merged_nsw_read
from repro_torch.index.segment import MemSegment, Segment

_CACHE_CAP = 4096  # merged-read entries per snapshot

_SNAPSHOT_IDS = itertools.count(1)


def snapshot_token(index) -> int:
    """Stable identity of an immutable searcher view, for external caches
    (e.g. the serving layer's packed-posting cache, DESIGN.md §11).

    ``SegmentedView`` carries a process-unique ``snapshot_id`` minted at
    construction — two distinct snapshots never share a token, even if one
    is garbage-collected and the other reuses its memory. Static
    ``ProximityIndex`` objects are immutable for their lifetime, so their
    ``id()`` is a valid token as long as the caller keeps a reference
    (serving engines do). A mutable ``SegmentedIndex`` delegates to its
    current published snapshot."""
    tok = getattr(index, "snapshot_id", None)
    if tok is not None:
        return tok
    if hasattr(index, "snapshot"):
        return index.snapshot().snapshot_id
    return id(index)


class _MergedStore:
    """PostingStore-shaped facade over the per-segment stores: metered
    ``read``, ``__contains__``, ``n_postings``, ``keys``, backed by the
    snapshot's merged-read cache."""

    def __init__(self, view: "SegmentedView", kind: str):
        self._view = view
        self._kind = kind

    def __contains__(self, key) -> bool:
        return any(
            key in getattr(seg.index, self._kind) for seg in self._view.segments
        )

    def keys(self):
        out = set()
        for seg in self._view.segments:
            out.update(getattr(seg.index, self._kind).keys())
        return out

    def n_postings(self, key) -> int:
        """Exact *live* posting count (tombstones applied) — anchor choice
        and bucket sizing match a fresh rebuild."""
        if key not in self:
            return 0
        cols, _, _, _ = self._view._merged(self._kind, key)
        return int(cols[0].size)

    def read(self, key, meter: ByteMeter | None = None) -> list[np.ndarray]:
        cols, _, _, nbytes = self._view._merged(self._kind, key)
        if meter is not None:
            meter.add(nbytes, cols[0].size)
        return cols

    def total_bytes(self) -> int:
        return sum(
            getattr(seg.index, self._kind).total_bytes() for seg in self._view.segments
        )


class _MergedNSW:
    """NSWStreams-shaped facade: per-lemma record streams renumbered to
    align with the merged ordinary posting list of that lemma."""

    def __init__(self, view: "SegmentedView"):
        self._view = view

    def read(self, lemma: int, meter: ByteMeter | None = None):
        rows, fls, offs, nbytes = self._view._merged_nsw(lemma)
        if meter is not None:
            meter.add(nbytes, 0)
        return rows, fls, offs

    def total_bytes(self) -> int:
        return sum(
            seg.index.nsw.blob(l).__len__()
            for seg in self._view.segments
            if seg.index.nsw is not None
            for l in seg.index.nsw.lemma_row_start
        )


class SegmentedView:
    """Immutable searcher snapshot over a set of sealed segments."""

    def __init__(
        self,
        segments: tuple[Segment, ...],
        tombstones: np.ndarray,
        lexicon: Lexicon,
        max_distance: int,
        n_total_docs: int,
        epoch: int = 0,
        mem_overlay: Segment | None = None,
    ):
        # identity for external caches: `epoch` is the publisher's refresh
        # counter (human-meaningful), `snapshot_id` is process-unique and
        # never reused — cache keys must use snapshot_id (DESIGN.md §11)
        self.epoch = int(epoch)
        self.snapshot_id = next(_SNAPSHOT_IDS)
        # `mem_overlay` (DESIGN.md §18) is a frozen memtable pseudo-segment
        # appended to the read set: live views built by
        # ``SegmentedIndex.live_view`` make unsealed adds searchable before
        # any refresh. It participates in every merged read like a sealed
        # segment but is ephemeral — caches treat overlay views as
        # uncacheable churn and the planner routes overlay-touching queries
        # to the scalar executor.
        self.mem_overlay = mem_overlay
        self.segments = tuple(segments) + (
            (mem_overlay,) if mem_overlay is not None else ()
        )
        self.tombstones = np.sort(np.asarray(tombstones, np.int64))
        self.lexicon = lexicon
        self.max_distance = max_distance
        self.n_total_docs = int(n_total_docs)
        # global doc-length table (holes for deleted/compacted-away docs
        # keep their slot: engines only use it to size the doc stride)
        dl = np.zeros(max(self.n_total_docs, 1), np.int64)
        for seg in self.segments:
            dl[seg.doc_map] = np.asarray(seg.index.doc_lengths, np.int64)
        self.doc_lengths = dl
        has = lambda kind: any(  # noqa: E731
            getattr(s.index, kind) is not None for s in self.segments
        )
        self.ordinary = _MergedStore(self, "ordinary")
        self.wv = _MergedStore(self, "wv") if has("wv") else None
        self.fst = _MergedStore(self, "fst") if has("fst") else None
        self.nsw = _MergedNSW(self) if has("nsw") else None
        self._cache: OrderedDict = OrderedDict()
        self._cache_lock = threading.Lock()  # snapshots are shared across
        # serving threads; merged entries are immutable so only the
        # OrderedDict bookkeeping needs guarding

    # -- merged reads (cached per snapshot) --------------------------------
    def _cache_put(self, ck, value):
        with self._cache_lock:
            if len(self._cache) >= _CACHE_CAP:
                self._cache.popitem(last=False)
            self._cache[ck] = value

    def _merged(self, kind: str, key):
        with self._cache_lock:
            hit = self._cache.get((kind, key))
        if hit is None:
            hit = merged_key_read(self.segments, kind, key, self.tombstones)
            self._cache_put((kind, key), hit)
        return hit

    def _merged_nsw(self, lemma: int):
        with self._cache_lock:
            hit = self._cache.get(("nsw", lemma))
        if hit is None:
            _, seg_ids, old_rows, _ = self._merged("ordinary", lemma)
            hit = merged_nsw_read(self.segments, lemma, seg_ids, old_rows)
            self._cache_put(("nsw", lemma), hit)
        return hit

    # -- ProximityIndex read API -------------------------------------------
    @property
    def has_additional(self) -> bool:
        return self.fst is not None

    def read_ordinary(self, lemma: int, meter: ByteMeter | None = None):
        cols = self.ordinary.read(lemma, meter)
        return cols[0], cols[1]

    def read_wv(self, key, meter: ByteMeter | None = None):
        cols = self.wv.read(key, meter)
        return cols[0], cols[1], zigzag_decode(cols[2].astype(np.uint64))

    def read_fst(self, key, meter: ByteMeter | None = None):
        cols = self.fst.read(key, meter)
        return (
            cols[0],
            cols[1],
            zigzag_decode(cols[2].astype(np.uint64)),
            zigzag_decode(cols[3].astype(np.uint64)),
        )

    def live_doc_ids(self) -> np.ndarray:
        """Sorted global ids of all non-deleted documents."""
        if not self.segments:
            return np.zeros(0, np.int64)
        parts = [
            seg.doc_map[~isin_sorted(self.tombstones, seg.doc_map)]
            for seg in self.segments
        ]
        return np.sort(np.concatenate(parts))

    def size_report(self) -> dict:
        rep = {
            "n_segments": len(self.segments),
            "live_docs": int(self.live_doc_ids().size),
            "tombstones": int(self.tombstones.size),
            "ordinary_bytes": sum(s.index.ordinary.total_bytes() for s in self.segments),
        }
        if self.wv is not None:
            rep["wv_bytes"] = sum(
                s.index.wv.total_bytes() for s in self.segments if s.index.wv is not None
            )
            rep["wv_keys"] = len(self.wv.keys())
        if self.fst is not None:
            rep["fst_bytes"] = sum(
                s.index.fst.total_bytes() for s in self.segments if s.index.fst is not None
            )
            rep["fst_keys"] = len(self.fst.keys())
        return rep


class SegmentedIndex:
    """Mutable LSM-style index manager with an immutable-snapshot read path.

    Typical serving loop::

        idx = SegmentedIndex(lexicon)
        idx.add_document([...]); idx.delete_document(gid)
        idx.refresh()                    # seal + maybe compact + publish
        engine = ProximitySearchEngine(idx.snapshot())
    """

    def __init__(
        self,
        lexicon: Lexicon,
        max_distance: int = 5,
        build_wv: bool = True,
        build_fst: bool = True,
        build_nsw: bool = True,
        memtable_docs: int = 512,
        tier_fanout: int = 4,
        background: bool = False,
        policy: str = "size_tiered",
        executor: CompactionExecutor | None = None,
        min_compact_interval_s: float = 0.0,
    ):
        if tier_fanout < 2:
            raise ValueError("tier_fanout must be >= 2")
        if memtable_docs < 1:
            raise ValueError("memtable_docs must be >= 1")
        if policy not in ("size_tiered", "leveled"):
            raise ValueError(f"unknown compaction policy {policy!r}")
        self.lexicon = lexicon
        self.max_distance = max_distance
        self._flags = dict(build_wv=build_wv, build_fst=build_fst, build_nsw=build_nsw)
        self.memtable_docs = memtable_docs
        self.tier_fanout = tier_fanout
        self.policy = policy
        self._plan_fn = size_tiered_plan if policy == "size_tiered" else leveled_plan
        self._segments: list[Segment] = []
        self._tombstones: set[int] = set()
        self._next_doc = 0
        self._next_seg = 0
        self._mem = self._new_mem()
        self._snapshot: SegmentedView | None = None
        self._epoch = 0
        # one reentrant lock guards all mutable state; immutable snapshots
        # are read lock-free. Background swap-ins take the same lock, so a
        # published view is always a consistent (segments, tombstones) pair
        self._lock = threading.RLock()
        self._live_memo: tuple | None = None
        self.background = bool(background)
        self._owns_executor = background and executor is None
        self._executor = (
            executor
            if executor is not None
            else (
                CompactionExecutor(min_interval_s=min_compact_interval_s)
                if background
                else None
            )
        )
        self.stats = {"seals": 0, "merges": 0, "docs_added": 0, "docs_deleted": 0}

    @property
    def executor(self) -> CompactionExecutor | None:
        return self._executor

    def _new_mem(self) -> MemSegment:
        return MemSegment(self.lexicon, max_distance=self.max_distance, **self._flags)

    # -- mutation ----------------------------------------------------------
    def add_document(self, tokens) -> int:
        """Absorb one document; returns its global doc id. The doc becomes
        searchable after the next refresh() (immediately via live_view())."""
        with self._lock:
            gid = self._next_doc
            self._next_doc += 1
            self._mem.add_document(gid, tokens)
            self.stats["docs_added"] += 1
            if self._mem.n_docs >= self.memtable_docs:
                self._seal()
        return gid

    def add_table(self, table: TokenTable) -> np.ndarray:
        """Bulk-load a TokenTable; returns the assigned global doc ids."""
        with self._lock:
            gids = np.arange(self._next_doc, self._next_doc + table.n_docs, dtype=np.int64)
            self._mem.add_table(table, gids)
            self._next_doc += table.n_docs
            self.stats["docs_added"] += table.n_docs
            if self._mem.n_docs >= self.memtable_docs:
                self._seal()
        return gids

    def delete_document(self, global_id: int) -> None:
        """Tombstone a document (visible after the next refresh()). The id
        is never reused; an update is delete + re-add under a fresh id.
        Idempotent: re-deleting an already-deleted doc (even one whose
        tombstone was purged by compaction) is a no-op — a tombstone no
        segment covers could never be purged again."""
        global_id = int(global_id)
        with self._lock:
            if not 0 <= global_id < self._next_doc:
                raise KeyError(f"unknown doc id {global_id}")
            if global_id in self._tombstones:
                return
            covered = global_id in self._mem._global_ids or any(
                bool(isin_sorted(seg.doc_map, np.array([global_id])))
                for seg in self._segments
            )
            if not covered:  # already deleted and physically compacted away
                return
            self._tombstones.add(global_id)
            self.stats["docs_deleted"] += 1

    # -- seal / compact ----------------------------------------------------
    def _seal_only(self) -> bool:
        """Seal the memtable into a new segment (no compaction). O(memtable)."""
        seg = self._mem.seal(segment_id=self._next_seg)
        if seg is None:
            return False
        self._next_seg += 1
        self._segments.append(seg)
        self.stats["seals"] += 1
        self._mem = self._new_mem()
        return True

    def _seal(self) -> None:
        """Seal + trigger compaction: inline to fixpoint in foreground
        mode, a non-blocking schedule in background mode."""
        if self._seal_only():
            if self.background:
                self._executor.schedule(self)
            else:
                self.maybe_compact()

    def maybe_compact(self) -> int:
        """Run the compaction policy inline until stable; returns merge
        count. (Background mode schedules via the executor instead; this
        entry point stays inline so forced/major compactions and the
        foreground path behave exactly as before.)"""
        merges = 0
        with self._lock:
            while True:
                plan = self._plan_fn(self._segments, self.tier_fanout)
                if not plan:
                    return merges
                # merge one group per pass: indices into self._segments go
                # stale the moment _merge_group mutates the list, so replan
                self._merge_group(plan[0])
                merges += 1

    def compact(self, force: bool = False) -> int:
        """force=True merges *all* segments into one (major compaction);
        otherwise runs the compaction policy inline."""
        with self._lock:
            if not force:
                return self.maybe_compact()
            if len(self._segments) <= 1 and not (
                self._segments and self._covered_tombstones(self._segments)
            ):
                return 0
            self._merge_group(list(range(len(self._segments))))
            return 1

    # -- background protocol (called by CompactionExecutor, DESIGN.md §18) --
    def _compaction_specs(self) -> list[tuple[list[Segment], np.ndarray, int]]:
        """Capture merge jobs for the executor: victim Segment objects and
        the tombstone set *as of now*, plus a pre-allocated output id."""
        with self._lock:
            plan = self._plan_fn(self._segments, self.tier_fanout)
            tomb = np.array(sorted(self._tombstones), np.int64)
            specs = []
            for group in plan:
                victims = [self._segments[i] for i in group]
                specs.append((victims, tomb, self._next_seg))
                self._next_seg += 1
            return specs

    def _apply_merge(self, victims: list[Segment], merged: Segment | None, captured_tomb) -> str:
        """Atomic swap-in of a background merge. Validates every victim is
        still live *by identity* (else the job was superseded by an
        overlapping merge or a dead-segment drop), replaces victims with
        the output, purges only tombstones that were captured at merge
        start AND covered by the victims (later deletes keep masking the
        merged segment at read time — no resurrection), and publishes a
        fresh snapshot in the same critical section."""
        with self._lock:
            live_ids = {id(s) for s in self._segments}
            if any(id(v) not in live_ids for v in victims):
                return SUPERSEDED
            victim_ids = {id(v) for v in victims}
            survivors = [s for s in self._segments if id(s) not in victim_ids]
            if merged is not None:
                survivors.append(merged)
            self._segments = survivors
            captured = {int(t) for t in np.asarray(captured_tomb).ravel()}
            covered = {int(g) for v in victims for g in v.doc_map}
            self._tombstones -= captured & covered
            self.stats["merges"] += 1
            self._publish_locked()
            return MERGED if merged is not None else NOOP

    def _covered_tombstones(self, segs: list[Segment]) -> set[int]:
        covered = set()
        for seg in segs:
            covered.update(int(g) for g in seg.doc_map)
        return covered & self._tombstones

    def _merge_group(self, group: list[int]) -> None:
        group_set = set(group)
        victims = [self._segments[i] for i in group]
        tomb = np.array(sorted(self._tombstones), np.int64)
        merged = merge_segments(
            victims, tomb, self.lexicon, self.max_distance, segment_id=self._next_seg
        )
        self._next_seg += 1
        survivors = [s for i, s in enumerate(self._segments) if i not in group_set]
        if merged is not None:
            survivors.append(merged)
        self._segments = survivors
        # tombstones absorbed by this merge are purged: each global doc
        # lives in exactly one segment, so no other segment can hold them
        self._tombstones -= self._covered_tombstones(victims)
        self.stats["merges"] += 1

    # -- snapshot / refresh -------------------------------------------------
    def _publish_locked(self) -> SegmentedView:
        self._epoch += 1
        self._snapshot = SegmentedView(
            tuple(self._segments),
            np.array(sorted(self._tombstones), np.int64),
            self.lexicon,
            self.max_distance,
            self._next_doc,
            epoch=self._epoch,
        )
        return self._snapshot

    def refresh(self, wait: bool | None = None,
                timeout: float | None = None) -> SegmentedView:
        """Seal the memtable, drop fully-dead segments, and publish a new
        immutable snapshot.

        ``wait`` controls compaction (default: ``not background``):

        * foreground + ``wait=True`` — the original inline behaviour:
          compaction runs to fixpoint before the snapshot is published.
        * ``wait=False`` — seal-only: O(memtable) work, merges are merely
          *scheduled* in background mode (and skipped in foreground mode);
          the snapshot publishes immediately and later background swap-ins
          republish on their own.
        * background + ``wait=True`` — quiesce: schedule and wait for the
          executor to drain (re-scheduling until the plan is stable), then
          return the latest published snapshot. ``timeout`` (seconds)
          bounds the whole quiesce: ``TimeoutError`` if the executor is
          still busy by then (the sealed snapshot stays published).
        """
        if wait is None:
            wait = not self.background
        with self._lock:
            if self._mem.n_docs:
                self._seal_only()
            tomb = np.array(sorted(self._tombstones), np.int64)
            live = [
                seg
                for seg in self._segments
                if not bool(np.all(isin_sorted(tomb, seg.doc_map)))
            ]
            if len(live) != len(self._segments):
                dropped = [s for s in self._segments if s not in live]
                self._segments = live
                for seg in dropped:
                    self._tombstones -= {int(g) for g in seg.doc_map}
            if not self.background and wait:
                self.maybe_compact()
            snap = self._publish_locked()
        if self.background:
            if wait:
                # drain-and-replan until stable: a finished merge can push
                # its output tier over the policy threshold. Guarded by a
                # progress check so a persistently failing merge (fault
                # injection, OOM) degrades to "compaction behind" instead
                # of spinning this loop forever
                deadline = None if timeout is None else time.monotonic() + timeout

                def wait_idle():
                    left = None if deadline is None else max(0.0, deadline - time.monotonic())
                    if not self._executor.wait_idle(left):
                        raise TimeoutError("background compaction still running")

                while True:
                    wait_idle()
                    done0 = self._executor.stats["merged"] + self._executor.stats["noop"]
                    if not self._executor.schedule(self):
                        break
                    wait_idle()
                    if self._executor.stats["merged"] + self._executor.stats["noop"] == done0:
                        break
                with self._lock:
                    snap = self._snapshot  # swap-ins republished under lock
            else:
                self._executor.schedule(self)
        return snap

    def snapshot(self) -> SegmentedView:
        """The last published immutable view (publishing one if none yet)."""
        snap = self._snapshot
        if snap is None:
            return self.refresh()
        return snap

    def live_view(self) -> SegmentedView:
        """A searcher view over sealed segments *plus* the unsealed
        memtable (frozen into an ephemeral overlay segment): adds and
        deletes are visible immediately, before any refresh. Memoized on
        (segments identity, memtable version, tombstones), so repeated
        calls between mutations are O(1); the freeze itself is
        O(memtable) — same build path as sealing, hence bit-identical
        reads (DESIGN.md §18)."""
        with self._lock:
            key = (
                tuple(id(s) for s in self._segments),
                self._mem.version,
                len(self._tombstones),
            )
            if self._live_memo is not None and self._live_memo[0] == key:
                return self._live_memo[1]
            overlay = self._mem.freeze()
            view = SegmentedView(
                tuple(self._segments),
                np.array(sorted(self._tombstones), np.int64),
                self.lexicon,
                self.max_distance,
                self._next_doc,
                epoch=self._epoch,
                mem_overlay=overlay,
            )
            self._live_memo = (key, view)
            return view

    def close(self) -> None:
        """Stop the owned background executor (injected executors are the
        caller's to close). Idempotent."""
        if self._owns_executor and self._executor is not None:
            self._executor.close()

    @property
    def n_segments(self) -> int:
        return len(self._segments)

    # -- ProximityIndex read API (delegates to the current snapshot) -------
    @property
    def doc_lengths(self):
        return self.snapshot().doc_lengths

    @property
    def ordinary(self):
        return self.snapshot().ordinary

    @property
    def wv(self):
        return self.snapshot().wv

    @property
    def fst(self):
        return self.snapshot().fst

    @property
    def nsw(self):
        return self.snapshot().nsw

    @property
    def has_additional(self) -> bool:
        return self.snapshot().has_additional

    def read_ordinary(self, lemma, meter=None):
        return self.snapshot().read_ordinary(lemma, meter)

    def read_wv(self, key, meter=None):
        return self.snapshot().read_wv(key, meter)

    def read_fst(self, key, meter=None):
        return self.snapshot().read_fst(key, meter)

    def live_doc_ids(self) -> np.ndarray:
        return self.snapshot().live_doc_ids()

    def size_report(self) -> dict:
        return self.snapshot().size_report()

    # -- persistence --------------------------------------------------------
    def save(self, path: str | Path) -> None:
        """Crash-safe layout (DESIGN.md §18): every segment directory is
        fully written *before* the manifest is swapped in atomically
        (tmp + ``os.replace``). A crash mid-save leaves either the old
        manifest (new segment dirs are unreferenced orphans, ignored by
        ``load``) or the new one (whose segments are all complete) —
        never a manifest pointing at a partial segment. Holding the lock
        for the whole save keeps background swap-ins from changing the
        segment set under the writer."""
        from repro_torch.index.persist import write_json_atomic

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        with self._lock:
            if self._mem.n_docs:  # durability: everything buffered gets sealed
                self._seal_only()
            self.lexicon.save(path / "lexicon.json")
            manifest = {
                "format_version": 1,
                "max_distance": self.max_distance,
                "flags": self._flags,
                "memtable_docs": self.memtable_docs,
                "tier_fanout": self.tier_fanout,
                "next_doc": self._next_doc,
                "next_seg": self._next_seg,
                "tombstones": sorted(self._tombstones),
                "segments": [f"seg_{seg.segment_id:06d}" for seg in self._segments],
            }
            for seg in self._segments:
                seg.save(path / f"seg_{seg.segment_id:06d}")
            write_json_atomic(path / "manifest.json", manifest)

    @classmethod
    def load(cls, path: str | Path) -> "SegmentedIndex":
        path = Path(path)
        manifest = json.loads((path / "manifest.json").read_text())
        lexicon = Lexicon.load(path / "lexicon.json")
        out = cls(
            lexicon,
            max_distance=manifest["max_distance"],
            memtable_docs=manifest["memtable_docs"],
            tier_fanout=manifest["tier_fanout"],
            **manifest["flags"],
        )
        out._segments = [Segment.load(path / name, lexicon) for name in manifest["segments"]]
        out._tombstones = set(manifest["tombstones"])
        out._next_doc = manifest["next_doc"]
        out._next_seg = manifest["next_seg"]
        return out
