"""Size-tiered compaction: physically merge sealed segments.

Policy (classic LSM size-tiering): segments are bucketed into tiers by
``floor(log_fanout(n_postings))``; whenever a tier accumulates ``fanout``
segments they are merged into one segment of the next tier. Merging is a
key-wise k-way merge of all four index structures with tombstoned docs
dropped and local doc ids remapped; tombstones fully absorbed by a merge
are purged (every global doc lives in exactly one segment, so once the
only segment that could contain a deleted doc is rewritten, its tombstone
is dead weight).

Physical merging is vectorized the same way ``build_segment_index`` is:
all (key, posting) rows of a store are concatenated across segments
(raw columns, no codec round-trip), doc ids are mapped/filtered/remapped
once per segment, and a single stable lexsort + boundary-slice regroups
them per key — no per-key Python loop over posting data.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.index_builder import NSWStreams, ProximityIndex
from repro_torch.core.lexicon import Lexicon
from repro_torch.core.postings import PostingStore
from repro_torch.index.merge import isin_sorted, merged_nsw_read
from repro_torch.index.segment import Segment


def size_tiered_plan(segments: list[Segment], fanout: int = 4) -> list[list[int]]:
    """Group segment *indices* into merge batches: any tier holding >=
    fanout segments is merged (oldest first, whole tier at once)."""
    if fanout < 2:
        raise ValueError("fanout must be >= 2")
    tiers: dict[int, list[int]] = {}
    for i, seg in enumerate(segments):
        size = max(seg.n_postings, 1)
        tier = int(np.log(size) / np.log(fanout))
        tiers.setdefault(tier, []).append(i)
    return [idxs for _, idxs in sorted(tiers.items()) if len(idxs) >= fanout]


def leveled_plan(segments: list[Segment], fanout: int = 4) -> list[list[int]]:
    """Leveled policy: a tier may hold at most one run. Any tier holding
    >= 2 segments merges them all (the output lands in a higher tier), so
    steady state is <= 1 segment per tier — minimal read amplification at
    higher write amplification than size-tiering (DESIGN.md §18). Tier
    assignment reuses the size-tiered bucketing so the two policies are
    directly comparable."""
    if fanout < 2:
        raise ValueError("fanout must be >= 2")
    tiers: dict[int, list[int]] = {}
    for i, seg in enumerate(segments):
        size = max(seg.n_postings, 1)
        tier = int(np.log(size) / np.log(fanout))
        tiers.setdefault(tier, []).append(i)
    return [idxs for _, idxs in sorted(tiers.items()) if len(idxs) >= 2]


def _merge_store(
    segments, kind: str, n_columns: int, tomb: np.ndarray, remap, with_prov: bool
):
    """Vectorized k-way merge of one PostingStore kind across segments.

    Returns (store, prov) where prov maps key -> (seg_ids, old_rows): each
    merged row's source segment ordinal and its pre-merge row ordinal
    within that segment's posting list for the key (pre-tombstone-filter
    numbering — what the NSW record renumbering aligns against).
    """
    key_parts, col_parts = [], [[] for _ in range(n_columns)]
    seg_parts, row_parts = [], []
    kdim = 0
    for si, seg in enumerate(segments):
        store = getattr(seg.index, kind)
        if store is None or store.n_keys() == 0:
            continue
        bulk = store.bulk_rows()
        if bulk is not None:
            # arena-backed store (seal/merge output): all rows are already
            # one contiguous column set — expand keys by count, no per-key
            # loop (the merge-throughput hot path, DESIGN.md §18)
            karr, bstarts, bends, bcols = bulk
            kdim = karr.shape[1]
            cnts = bends - bstarts
            keys = np.repeat(karr, cnts, axis=0)
            cols = [np.asarray(c).astype(np.int64) for c in bcols]
            if with_prov:
                rp_all = np.arange(keys.shape[0], dtype=np.int64) - np.repeat(
                    bstarts, cnts
                )
        else:
            kp, cp, rp = [], [[] for _ in range(n_columns)], []
            for k in store.counts:
                cols = store.columns(k)
                n = cols[0].size
                if n == 0:
                    continue
                krow = np.asarray(k if isinstance(k, tuple) else (k,), np.int64)
                kdim = krow.size
                kp.append(np.broadcast_to(krow, (n, kdim)))
                for ci in range(n_columns):
                    cp[ci].append(cols[ci])
                if with_prov:
                    rp.append(np.arange(n, dtype=np.int64))
            if not kp:
                continue
            keys = np.concatenate(kp)
            cols = [np.concatenate(x) for x in cp]
            if with_prov:
                rp_all = np.concatenate(rp)
        gdoc = seg.doc_map[cols[0]]
        keep = ~isin_sorted(tomb, gdoc)
        if not keep.any():
            continue
        keys = keys[keep]
        cols[0] = remap(gdoc[keep])
        cols[1:] = [c[keep] for c in cols[1:]]
        key_parts.append(keys)
        for ci in range(n_columns):
            col_parts[ci].append(cols[ci])
        if with_prov:
            seg_parts.append(np.full(keys.shape[0], si, np.int32))
            row_parts.append(rp_all[keep])

    out = PostingStore(n_columns=n_columns)
    prov: dict = {}
    if not key_parts:
        return out, prov
    keys = np.concatenate(key_parts)
    cols = [np.concatenate(x) for x in col_parts]
    # stable sort by (key, doc): same-(key,doc) rows come from one segment
    # (docs are disjoint), so fresh-build intra-doc order is preserved
    order = np.lexsort((cols[0], *[keys[:, d] for d in range(kdim - 1, -1, -1)]))
    keys = keys[order]
    cols = [c[order] for c in cols]
    if with_prov:
        seg_ids = np.concatenate(seg_parts)[order]
        old_rows = np.concatenate(row_parts)[order]
    change = np.nonzero(np.any(np.diff(keys, axis=0) != 0, axis=1))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [keys.shape[0]]])
    out_keys = keys[starts, 0] if kdim == 1 else keys[starts]
    out.put_bulk(out_keys, starts, ends, cols)
    if with_prov:  # ordinary only: a few hundred lemma keys
        for key, s, e in zip(out_keys.tolist() if kdim == 1
                             else map(tuple, keys[starts].tolist()),
                             starts.tolist(), ends.tolist()):
            prov[key] = (seg_ids[s:e], old_rows[s:e])
    return out, prov


def merge_segments(
    segments: list[Segment],
    tombstones: np.ndarray,
    lexicon: Lexicon,
    max_distance: int,
    segment_id: int,
) -> Segment | None:
    """Merge sealed segments into one, dropping tombstoned docs and
    compacting local doc ids. Returns None if nothing survives."""
    tomb = np.sort(np.asarray(tombstones, np.int64))
    # ---- surviving docs & the id remap ----------------------------------
    gid_parts, len_parts = [], []
    for seg in segments:
        keep = ~isin_sorted(tomb, seg.doc_map)
        gid_parts.append(seg.doc_map[keep])
        len_parts.append(np.asarray(seg.index.doc_lengths)[keep])
    gids = np.concatenate(gid_parts) if gid_parts else np.zeros(0, np.int64)
    if gids.size == 0:
        return None
    order = np.argsort(gids)
    doc_map_new = gids[order]
    doc_lengths_new = np.concatenate(len_parts)[order].astype(np.int32)
    remap = lambda g: np.searchsorted(doc_map_new, g)  # noqa: E731

    has_wv = all(seg.index.wv is not None for seg in segments)
    has_fst = all(seg.index.fst is not None for seg in segments)
    has_nsw = all(seg.index.nsw is not None for seg in segments)

    ordinary, prov = _merge_store(segments, "ordinary", 2, tomb, remap, with_prov=has_nsw)
    wv = _merge_store(segments, "wv", 3, tomb, remap, with_prov=False)[0] if has_wv else None
    fst = _merge_store(segments, "fst", 4, tomb, remap, with_prov=False)[0] if has_fst else None

    # ---- NSW streams: renumber rows into the merged ordinary order ------
    nsw = None
    if has_nsw:
        sw = lexicon.sw_count
        rows_l, fls_l, offs_l = [], [], []
        lemma_row_start: dict[int, tuple[int, int]] = {}
        off = 0
        for k in sorted(ordinary.counts):  # ascending lemma -> ascending spans
            cnt = ordinary.n_postings(k)
            if cnt and k >= sw:
                lemma_row_start[k] = (off, off + cnt)
                seg_ids, old_rows = prov[k]
                rows, fls, offs, _ = merged_nsw_read(
                    segments, k, seg_ids, old_rows, count_bytes=False
                )
                if rows.size:
                    rows_l.append(rows + off)
                    fls_l.append(fls)
                    offs_l.append(offs)
            off += cnt
        nsw = NSWStreams(
            np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64),
            np.concatenate(fls_l) if fls_l else np.zeros(0, np.int64),
            np.concatenate(offs_l) if offs_l else np.zeros(0, np.int64),
            lemma_row_start,
        )

    index = ProximityIndex(
        lexicon=lexicon,
        max_distance=max_distance,
        ordinary=ordinary,
        nsw=nsw,
        wv=wv,
        fst=fst,
        doc_lengths=doc_lengths_new,
    )
    return Segment(
        segment_id=segment_id,
        index=index,
        doc_map=doc_map_new,
        derived_from=tuple(s.segment_id for s in segments),
    )
