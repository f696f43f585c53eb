"""Array (de)serialization of the index, and carrying an index across.

Every ``PostingStore`` flattens to its *encoded* blobs (one concatenated
byte stream + offsets + keys + counts), so a round trip keeps the exact
representation the ByteMeter accounts for and loading does no
re-encoding work. Layout: a flat dict of numpy arrays with a ``kind_``
prefix per structure, plus a small meta dict.

:func:`carry_index` is this system's counterpart of carrying weights
across frameworks: the index is the state both packages compute on, and
it crosses over as these arrays. It reads the source index by attribute
access only, so it takes an index built by the reference package without
importing that package.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.index_builder import NSWStreams, ProximityIndex
from repro_torch.core.lexicon import Lexicon
from repro_torch.core.postings import PostingStore

_KDIM = {"ordinary": 1, "wv": 2, "fst": 3}
_NCOL = {"ordinary": 2, "wv": 3, "fst": 4}


def store_to_arrays(store, kind: str) -> dict[str, np.ndarray]:
    """Force-encode a PostingStore and flatten it into arrays."""
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


def carry_index(index) -> ProximityIndex:
    """This package's ``ProximityIndex`` holding the same state as
    ``index`` — any object with the reference index's attributes (a
    static index built by either package). Segmented sources arrive with
    a later slice of the port."""
    if hasattr(index, "snapshot") or hasattr(index, "segments"):
        raise NotImplementedError(
            "carrying a segmented index arrives with the SegmentedIndex slice "
            "of the port; carry a static index")
    meta = {
        "max_distance": index.max_distance,
        "has_wv": index.wv is not None,
        "has_fst": index.fst is not None,
        "has_nsw": index.nsw is not None,
    }
    lexicon = lexicon_from_arrays(lexicon_to_arrays(index.lexicon))
    return index_from_arrays(index_to_arrays(index), lexicon, meta)
