"""LSM-style segments over the paper's index structures.

A ``MemSegment`` is the mutable memtable: it absorbs incoming documents at
O(doc length) cost per add and, when sealed, builds all four paper index
structures (ordinary+NSW, (w,v), (f,s,t)) for its slice of the corpus via
``core.index_builder.build_segment_index`` — the *same* code path as the
single-shot ``build_index`` (which is now literally "one sealed segment").

A sealed ``Segment`` is immutable: a ``ProximityIndex`` whose doc ids are
segment-local, plus ``doc_map`` translating them to global doc ids. Every
global document lives in exactly one segment (updates are delete+re-add
under a fresh global id), which is the invariant the k-way merge reads in
``repro_torch.index.merge`` rely on.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.core.index_builder import ProximityIndex, build_segment_index
from repro_torch.core.lexicon import Lexicon
from repro_torch.data.corpus import TokenTable


@dataclass(frozen=True, eq=False)  # identity equality: fields hold arrays
class Segment:
    """Immutable sealed segment: index over a corpus slice + id mapping.

    ``derived_from`` records the *immediate* lineage of a compaction
    output: the segment_ids of the victims a merge rewrote. Global doc
    ids are stable across merges, so a segment whose lineage lies
    entirely inside a snapshot's segment set carries bitwise the same
    merged reads as its victims did — the invariant the serving pack
    cache's merge-aware retention rests on (DESIGN.md §18).

    ``is_live`` marks a frozen memtable overlay (``MemSegment.freeze``):
    an ephemeral pseudo-segment serving unsealed documents inside a
    ``SegmentedView``; never persisted, never compacted."""

    segment_id: int
    index: ProximityIndex
    doc_map: np.ndarray  # (n_local_docs,) int64, strictly increasing global ids
    derived_from: tuple = ()  # segment_ids of the merge victims, () for seals
    is_live: bool = False  # frozen memtable overlay, not a durable segment

    @property
    def n_docs(self) -> int:
        return int(self.doc_map.size)

    @property
    def n_postings(self) -> int:
        """Ordinary-index posting count — the size proxy used for tiering."""
        return int(sum(self.index.ordinary.counts.values()))

    def min_doc(self) -> int:
        return int(self.doc_map[0]) if self.doc_map.size else -1

    def max_doc(self) -> int:
        return int(self.doc_map[-1]) if self.doc_map.size else -1

    # -- persistence -------------------------------------------------------
    def save(self, path: str | Path) -> None:
        from repro_torch.index.persist import index_to_arrays

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        arrays = index_to_arrays(self.index)
        arrays["doc_map"] = self.doc_map.astype(np.int64)
        meta = {
            "segment_id": self.segment_id,
            "n_docs": self.n_docs,
            "max_distance": self.index.max_distance,
            "has_wv": self.index.wv is not None,
            "has_fst": self.index.fst is not None,
            "has_nsw": self.index.nsw is not None,
            "derived_from": list(self.derived_from),
        }
        # npz before meta: a dir with meta but no npz is recognizably
        # partial (crash mid-write) and ignored by the manifest loader
        np.savez(path / "segment.npz", **arrays)
        (path / "meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str | Path, lexicon: Lexicon) -> "Segment":
        from repro_torch.index.persist import index_from_arrays

        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "segment.npz") as z:
            arrays = {k: z[k] for k in z.files}
        index = index_from_arrays(arrays, lexicon, meta)
        return cls(
            segment_id=int(meta["segment_id"]),
            index=index,
            doc_map=arrays["doc_map"].astype(np.int64),
            derived_from=tuple(meta.get("derived_from", ())),
        )


class MemSegment:
    """Mutable memtable absorbing documents for the next sealed segment.

    ``add_document`` only appends rows (cheap, no index work); the paper
    structures are built for the whole slice at ``seal()`` — the classic
    LSM amortization: per-doc cost stays O(doc), the d^2-heavy (f,s,t)
    construction runs once per segment over vectorized numpy.
    """

    def __init__(
        self,
        lexicon: Lexicon,
        max_distance: int = 5,
        build_wv: bool = True,
        build_fst: bool = True,
        build_nsw: bool = True,
    ):
        self.lexicon = lexicon
        self.max_distance = max_distance
        self.build_wv = build_wv
        self.build_fst = build_fst
        self.build_nsw = build_nsw
        self._doc_rows: list[np.ndarray] = []  # per doc: (n_rows,) local doc col
        self._pos_rows: list[np.ndarray] = []
        self._lem_rows: list[np.ndarray] = []
        self._lengths: list[int] = []
        self._global_ids: list[int] = []
        self._n_tokens = 0

    # -- stats -------------------------------------------------------------
    @property
    def n_docs(self) -> int:
        return len(self._lengths)

    @property
    def n_tokens(self) -> int:
        return self._n_tokens

    # -- absorption --------------------------------------------------------
    def add_document(self, global_id: int, tokens) -> None:
        """Absorb one document. ``tokens`` is a list of lemma ids, or a list
        of per-position lemma-alternative lists (multi-lemma words)."""
        if self._global_ids and global_id <= self._global_ids[-1]:
            raise ValueError("global doc ids must be strictly increasing")
        local = self.n_docs
        if len(tokens) and isinstance(tokens[0], (list, tuple)):
            pos = np.array(
                [pi for pi, alts in enumerate(tokens) for _ in alts], np.int32
            )
            lem = np.array([l for alts in tokens for l in alts], np.int32)
            length = len(tokens)
        else:
            lem = np.asarray(tokens, np.int32)
            pos = np.arange(lem.size, dtype=np.int32)
            length = int(lem.size)
        self._doc_rows.append(np.full(pos.size, local, np.int32))
        self._pos_rows.append(pos)
        self._lem_rows.append(lem)
        self._lengths.append(length)
        self._global_ids.append(int(global_id))
        self._n_tokens += length

    def add_table(self, table: TokenTable, global_ids: np.ndarray | None = None) -> None:
        """Absorb a whole TokenTable (bulk load / the single-shot path).
        Local doc ids continue from the docs already absorbed."""
        if global_ids is None:
            base = self._global_ids[-1] + 1 if self._global_ids else 0
            global_ids = np.arange(base, base + table.n_docs, dtype=np.int64)
        offset = self.n_docs
        self._doc_rows.append(table.doc_ids.astype(np.int32) + offset)
        self._pos_rows.append(table.positions.astype(np.int32))
        self._lem_rows.append(table.lemma_ids.astype(np.int32))
        self._lengths.extend(int(x) for x in table.doc_lengths)
        self._global_ids.extend(int(g) for g in global_ids)
        self._n_tokens += int(table.doc_lengths.sum())
        if len(self._global_ids) > 1:
            gids = np.asarray(self._global_ids)
            if not np.all(np.diff(gids) > 0):
                raise ValueError("global doc ids must be strictly increasing")

    # -- live search -------------------------------------------------------
    @property
    def version(self) -> tuple:
        """Cheap mutation stamp: changes on every absorbed document.
        ``SegmentedIndex.live_view`` memoizes its frozen overlay on it."""
        return (len(self._lengths), self._n_tokens)

    def freeze(self) -> Segment | None:
        """An ephemeral live overlay over the *current* buffer: the same
        build as :meth:`seal` (bit-identical structures, so merged reads
        over it match a fresh rebuild), but marked ``is_live`` and keyed
        by a sentinel segment id — it is never persisted, tiered or
        compacted, and the memtable keeps absorbing afterwards. Cost is
        O(buffered tokens); callers memoize per :attr:`version`."""
        seg = self.seal(segment_id=-1)
        if seg is None:
            return None
        return Segment(
            segment_id=-1, index=seg.index, doc_map=seg.doc_map, is_live=True
        )

    # -- sealing -----------------------------------------------------------
    def seal(self, segment_id: int) -> Segment | None:
        """Build the four index structures for this slice and freeze it.
        Returns None for an empty memtable."""
        if not self._lengths:
            return None
        table = TokenTable(
            np.concatenate(self._doc_rows) if self._doc_rows else np.zeros(0, np.int32),
            np.concatenate(self._pos_rows) if self._pos_rows else np.zeros(0, np.int32),
            np.concatenate(self._lem_rows) if self._lem_rows else np.zeros(0, np.int32),
            np.array(self._lengths, np.int32),
        )
        index = build_segment_index(
            table,
            self.lexicon,
            max_distance=self.max_distance,
            build_wv=self.build_wv,
            build_fst=self.build_fst,
            build_nsw=self.build_nsw,
        )
        return Segment(
            segment_id=segment_id,
            index=index,
            doc_map=np.array(self._global_ids, np.int64),
        )
