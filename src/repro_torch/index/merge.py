"""K-way merge primitives over sealed segments.

Shared by the live read path (``segmented.SegmentedView`` merges postings
on the fly) and physical compaction (``compaction.merge_segments`` writes
the merged postings into a new sealed segment).

Correctness hinges on two invariants:

* every global document lives in exactly one segment, so after mapping
  local -> global doc ids the per-segment posting lists cover disjoint doc
  sets and a stable sort by doc id is a true k-way merge that preserves
  each document's intra-doc posting order (the fresh-build order);
* ``doc_map`` is strictly increasing, so local doc order == global doc
  order within a segment and NSW row provenance stays monotone.
"""

from __future__ import annotations

import numpy as np

_N_COLUMNS = {"ordinary": 2, "wv": 3, "fst": 4}


def isin_sorted(sorted_arr: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Vectorized membership of `values` in sorted `sorted_arr`."""
    if sorted_arr.size == 0:
        return np.zeros(values.shape, bool)
    i = np.searchsorted(sorted_arr, values)
    ic = np.clip(i, 0, sorted_arr.size - 1)
    return (i < sorted_arr.size) & (sorted_arr[ic] == values)


def merged_key_read(
    segments,
    kind: str,
    key,
    tomb_sorted: np.ndarray,
    remap=None,
    count_bytes: bool = True,
):
    """Merge one key's posting list across segments.

    Maps local doc ids to global via each segment's ``doc_map``, drops
    postings of tombstoned docs, optionally remaps global ids through
    ``remap`` (a monotone vectorized callable, used by compaction), and
    k-way merges by doc id.

    Returns ``(cols, seg_ids, old_rows, nbytes)`` where ``cols`` are the
    merged posting columns (doc col first), ``seg_ids``/``old_rows`` give
    each merged row's provenance (segment ordinal, pre-merge row ordinal
    within that segment's list — the alignment NSW merging needs), and
    ``nbytes`` is the total encoded bytes a disk read would have fetched.
    """
    n_columns = _N_COLUMNS[kind]
    cols_parts, seg_parts, row_parts = [], [], []
    nbytes = 0
    for si, seg in enumerate(segments):
        store = getattr(seg.index, kind)
        if store is None or key not in store:
            continue
        if count_bytes:  # the ByteMeter metric; forces lazy encoding, so
            nbytes += len(store._blob(key))  # physical merges skip it
        cols = store.columns(key)
        if cols[0].size == 0:
            continue
        gdoc = seg.doc_map[cols[0]]
        keep = ~isin_sorted(tomb_sorted, gdoc)
        if not keep.any():
            continue
        kept_rows = np.nonzero(keep)[0].astype(np.int64)
        doc_out = gdoc[keep]
        if remap is not None:
            doc_out = remap(doc_out)
        cols_parts.append([doc_out.astype(np.int64)] + [c[keep] for c in cols[1:]])
        seg_parts.append(np.full(kept_rows.size, si, np.int32))
        row_parts.append(kept_rows)
    if not cols_parts:
        empty = np.zeros(0, np.int64)
        return (
            [np.zeros(0, np.int64) for _ in range(n_columns)],
            np.zeros(0, np.int32),
            empty,
            nbytes,
        )
    cols = [np.concatenate([p[ci] for p in cols_parts]) for ci in range(n_columns)]
    seg_ids = np.concatenate(seg_parts)
    old_rows = np.concatenate(row_parts)
    if len(cols_parts) > 1:
        # stable: intra-doc order (== fresh-build order) is preserved, and
        # docs are disjoint across segments, so doc-only keys suffice.
        order = np.argsort(cols[0], kind="stable")
        cols = [c[order] for c in cols]
        seg_ids = seg_ids[order]
        old_rows = old_rows[order]
    return cols, seg_ids, old_rows, nbytes


def merged_nsw_read(
    segments,
    lemma: int,
    seg_ids: np.ndarray,
    old_rows: np.ndarray,
    count_bytes: bool = True,
):
    """Merge one lemma's NSW record stream across segments, renumbering
    record rows to align with a prior ``merged_key_read(..., "ordinary",
    lemma, ...)`` whose provenance is ``(seg_ids, old_rows)``.

    Records attached to tombstone-dropped postings are dropped with them.
    Returns ``(rows, fls, offs, nbytes)`` sorted by merged row.
    """
    rows_l, fls_l, offs_l = [], [], []
    nbytes = 0
    for si, seg in enumerate(segments):
        nsw = seg.index.nsw
        if nsw is None or lemma not in nsw.lemma_row_start:
            continue
        if count_bytes:
            nbytes += len(nsw.blob(lemma))
        r, f, o = nsw.read(lemma) if count_bytes else nsw.records(lemma)
        if r.size == 0:
            continue
        sel = np.nonzero(seg_ids == si)[0]  # merged rows owned by this segment
        if sel.size == 0:
            continue
        old = old_rows[sel]  # ascending (stable doc merge keeps local order)
        pos = np.searchsorted(old, r)
        posc = np.clip(pos, 0, old.size - 1)
        ok = (pos < old.size) & (old[posc] == r)
        if not ok.any():
            continue
        rows_l.append(sel[posc[ok]])
        fls_l.append(f[ok])
        offs_l.append(o[ok])
    if not rows_l:
        return (np.zeros(0, np.int64),) * 3 + (nbytes,)
    rows = np.concatenate(rows_l)
    fls = np.concatenate(fls_l)
    offs = np.concatenate(offs_l)
    order = np.argsort(rows, kind="stable")  # a row maps to one segment, so
    return rows[order], fls[order], offs[order], nbytes  # in-row order survives
