"""On-disk (de)serialization of the index, and carrying an index across.

Every ``PostingStore`` flattens to its *encoded* blobs (one concatenated
byte stream + offsets + keys + counts), so a round trip keeps the exact
representation the ByteMeter accounts for and loading does no
re-encoding work. Layout: a flat dict of numpy arrays (npz-friendly) with
a ``kind_`` prefix per structure, plus a small JSON meta carried by the
caller (``Segment.save`` / ``save_index``). The files are those of the
reference package, byte for byte in layout: ``lexicon.json``,
``meta.json`` and ``index.npz`` for a plain index; ``manifest.json`` and
``seg_NNNNNN/{segment.npz,meta.json}`` for a segmented one.

:func:`carry_index` is this system's counterpart of carrying weights
across frameworks: the index is the state both packages compute on, and
it crosses over as these arrays. It reads the source index by attribute
access only, so it takes an index built by the reference package without
importing that package.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from repro_torch.core.index_builder import NSWStreams, ProximityIndex
from repro_torch.core.lexicon import Lexicon
from repro_torch.core.postings import PostingStore, arena_blobs

_KDIM = {"ordinary": 1, "wv": 2, "fst": 3}
_NCOL = {"ordinary": 2, "wv": 3, "fst": 4}


def write_json_atomic(path: str | Path, obj) -> None:
    """Crash-safe JSON swap: write a sibling tmp file, then ``os.replace``
    it over the target. Readers observe either the old or the new file,
    never a truncated one — the manifest-swap primitive the crash-recovery
    contract of ``SegmentedIndex.save`` rests on (DESIGN.md §18)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


def store_to_arrays(store, kind: str) -> dict[str, np.ndarray]:
    """Force-encode a PostingStore and flatten it into arrays. A store
    backed by one bulk arena (a seal's or a merge's output) is encoded in
    a few numpy passes; others key by key."""
    bulk = store.bulk_rows()
    if bulk is not None:
        keys2d, starts, ends, cols = bulk
        blob, offsets = arena_blobs(keys2d, starts, ends, cols)
        return {
            f"{kind}_keys": np.asarray(keys2d, np.int64).reshape(-1, _KDIM[kind]),
            f"{kind}_counts": (ends - starts).astype(np.int64),
            f"{kind}_offsets": offsets,
            f"{kind}_blob": blob,
        }
    keys = sorted(store.counts)
    kdim = _KDIM[kind]
    if kdim == 1:
        keys_arr = np.array([[k] for k in keys], np.int64).reshape(len(keys), 1)
    else:
        keys_arr = np.array([list(k) for k in keys], np.int64).reshape(len(keys), kdim)
    blobs = [store._blob(k) for k in keys]
    lens = np.array([len(b) for b in blobs], np.int64)
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    blob = np.frombuffer(b"".join(blobs), np.uint8)
    counts = np.array([store.counts[k] for k in keys], np.int64)
    return {
        f"{kind}_keys": keys_arr,
        f"{kind}_counts": counts,
        f"{kind}_offsets": offsets,
        f"{kind}_blob": blob,
    }


def store_from_arrays(arrays: dict, kind: str) -> PostingStore:
    keys_arr = arrays[f"{kind}_keys"]
    counts_arr = arrays[f"{kind}_counts"]
    offsets = arrays[f"{kind}_offsets"]
    blob = arrays[f"{kind}_blob"].tobytes()
    kdim = _KDIM[kind]
    store = PostingStore(n_columns=_NCOL[kind])
    for i in range(keys_arr.shape[0]):
        key = int(keys_arr[i, 0]) if kdim == 1 else tuple(int(x) for x in keys_arr[i])
        store.blobs[key] = blob[int(offsets[i]) : int(offsets[i + 1])]
        store.counts[key] = int(counts_arr[i])
    return store


def nsw_to_arrays(nsw) -> dict[str, np.ndarray]:
    lemmas = sorted(nsw.lemma_row_start)
    spans = np.array(
        [[l, *nsw.lemma_row_start[l]] for l in lemmas], np.int64
    ).reshape(len(lemmas), 3)
    return {
        "nsw_rows": nsw.neighbor_rows.astype(np.int64),
        "nsw_fls": nsw.neighbor_fls.astype(np.int64),
        "nsw_offs": nsw.neighbor_offs.astype(np.int64),
        "nsw_spans": spans,
    }


def nsw_from_arrays(arrays: dict) -> NSWStreams:
    spans = arrays["nsw_spans"]
    lemma_row_start = {
        int(spans[i, 0]): (int(spans[i, 1]), int(spans[i, 2]))
        for i in range(spans.shape[0])
    }
    return NSWStreams(
        arrays["nsw_rows"].astype(np.int64),
        arrays["nsw_fls"].astype(np.int64),
        arrays["nsw_offs"].astype(np.int64),
        lemma_row_start,
    )


def index_to_arrays(index) -> dict[str, np.ndarray]:
    arrays = store_to_arrays(index.ordinary, "ordinary")
    if index.wv is not None:
        arrays.update(store_to_arrays(index.wv, "wv"))
    if index.fst is not None:
        arrays.update(store_to_arrays(index.fst, "fst"))
    if index.nsw is not None:
        arrays.update(nsw_to_arrays(index.nsw))
    if index.doc_lengths is not None:
        arrays["doc_lengths"] = np.asarray(index.doc_lengths, np.int64)
    return arrays


def index_from_arrays(arrays: dict, lexicon: Lexicon, meta: dict) -> ProximityIndex:
    return ProximityIndex(
        lexicon=lexicon,
        max_distance=int(meta["max_distance"]),
        ordinary=store_from_arrays(arrays, "ordinary"),
        nsw=nsw_from_arrays(arrays) if meta.get("has_nsw") else None,
        wv=store_from_arrays(arrays, "wv") if meta.get("has_wv") else None,
        fst=store_from_arrays(arrays, "fst") if meta.get("has_fst") else None,
        doc_lengths=arrays.get("doc_lengths"),
    )


def lexicon_to_arrays(lexicon) -> dict[str, np.ndarray]:
    """The lexicon's state as arrays: lemma strings, corpus counts,
    document frequencies and the (n_docs, sw_count, fu_count) header."""
    return {
        "lex_lemmas": np.array(lexicon.lemmas, dtype=np.str_),
        "lex_counts": np.asarray(lexicon.counts, np.int64),
        "lex_doc_freqs": np.asarray(lexicon.doc_freqs, np.int64),
        "lex_header": np.array([lexicon.n_docs, lexicon.sw_count, lexicon.fu_count],
                               np.int64),
    }


def lexicon_from_arrays(arrays: dict) -> Lexicon:
    n_docs, sw_count, fu_count = (int(x) for x in arrays["lex_header"])
    return Lexicon(
        lemmas=[str(w) for w in arrays["lex_lemmas"]],
        counts=arrays["lex_counts"].astype(np.int64),
        doc_freqs=arrays["lex_doc_freqs"].astype(np.int64),
        n_docs=n_docs,
        sw_count=sw_count,
        fu_count=fu_count,
    )


def save_index(index: ProximityIndex, path: str | Path) -> None:
    """Persist a plain (single-shot) ProximityIndex, lexicon included."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    index.lexicon.save(path / "lexicon.json")
    (path / "meta.json").write_text(json.dumps(_index_meta(index)))
    np.savez(path / "index.npz", **index_to_arrays(index))


def load_index(path: str | Path) -> ProximityIndex:
    path = Path(path)
    lexicon = Lexicon.load(path / "lexicon.json")
    meta = json.loads((path / "meta.json").read_text())
    with np.load(path / "index.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return index_from_arrays(arrays, lexicon, meta)


def _index_meta(index) -> dict:
    return {
        "max_distance": index.max_distance,
        "has_wv": index.wv is not None,
        "has_fst": index.fst is not None,
        "has_nsw": index.nsw is not None,
    }


def _carry_static(index, lexicon: Lexicon) -> ProximityIndex:
    return index_from_arrays(index_to_arrays(index), lexicon, _index_meta(index))


def _carry_segment(seg, lexicon: Lexicon):
    from repro_torch.index.segment import Segment

    return Segment(
        segment_id=int(seg.segment_id),
        index=_carry_static(seg.index, lexicon),
        doc_map=np.asarray(seg.doc_map, np.int64).copy(),
        derived_from=tuple(int(i) for i in seg.derived_from),
        is_live=bool(getattr(seg, "is_live", False)),
    )


def carry_index(index):
    """This package's counterpart of ``index``, holding the same state.

    ``index`` is any object with the reference package's attributes:

    * a static ``ProximityIndex`` (built by either package) gives a
      ``ProximityIndex``;
    * a ``SegmentedView`` gives a ``SegmentedView`` over the same segments
      (arrays, ``doc_map``, ``segment_id``, ``derived_from``), tombstones,
      document count and epoch, its live memtable overlay included;
    * a ``SegmentedIndex`` gives a ``SegmentedIndex`` with the same
      segments and tombstones, ``next_doc`` and ``next_seg``, build flags,
      ``memtable_docs``, ``tier_fanout``, ``policy`` and ``background``
      mode (a fresh executor of its own; jobs queued in the source's are
      not carried). Nothing is published yet: the first ``snapshot()``
      publishes. A source whose memtable holds unsealed documents is
      **refused** with ``ValueError``: call its ``refresh()`` first, so
      that every document crosses as part of a sealed segment. The
      source's state is read under its lock, so a background swap-in
      cannot tear it.

    All segments share one carried lexicon."""
    from repro_torch.index.segmented import SegmentedIndex, SegmentedView

    lexicon = lexicon_from_arrays(lexicon_to_arrays(index.lexicon))
    if hasattr(index, "segments") and hasattr(index, "tombstones"):  # a view
        overlay = getattr(index, "mem_overlay", None)
        return SegmentedView(
            tuple(_carry_segment(s, lexicon) for s in index.segments if s is not overlay),
            np.asarray(index.tombstones, np.int64).copy(),
            lexicon,
            index.max_distance,
            index.n_total_docs,
            epoch=index.epoch,
            mem_overlay=None if overlay is None else _carry_segment(overlay, lexicon),
        )
    if hasattr(index, "snapshot"):  # a mutable segmented index
        with index._lock:
            if index._mem.n_docs:
                raise ValueError(
                    f"the source's memtable holds {index._mem.n_docs} unsealed "
                    "documents; call its refresh() before carrying it")
            out = SegmentedIndex(
                lexicon,
                max_distance=index.max_distance,
                memtable_docs=index.memtable_docs,
                tier_fanout=index.tier_fanout,
                background=index.background,
                policy=index.policy,
                **index._flags,
            )
            out._segments = [_carry_segment(s, lexicon) for s in index._segments]
            out._tombstones = {int(t) for t in index._tombstones}
            out._next_doc = int(index._next_doc)
            out._next_seg = int(index._next_seg)
        return out
    return _carry_static(index, lexicon)
