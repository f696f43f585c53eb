"""NSW (near stop words) records — paper §1.2 (QT5 machinery).

For every occurrence of a frequently-used or ordinary lemma at position P,
the ordinary index carries a second stream with an *NSW record*: an encoded
list of all stop lemmas occurring within MaxDistance of P, with their
offsets. QT5 queries resolve their stop lemmas from these records instead
of reading the (huge) stop-lemma posting lists.

Record format (varbyte):  [count, (fl_delta, zigzag(offset)) * count]
with neighbors sorted by (fl, offset); fl delta-encoded within the record.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.codecs import varbyte_decode, varbyte_encode, zigzag_decode, zigzag_encode


def encode_nsw_stream(record_rows: np.ndarray, record_fls: np.ndarray, record_offs: np.ndarray, n_records: int) -> bytes:
    """Encode NSW records for one lemma's posting list.

    record_rows: (E,) posting ordinal each neighbor belongs to (sorted asc);
    record_fls / record_offs: stop-lemma FL numbers and signed offsets.
    """
    order = np.lexsort((record_offs, record_fls, record_rows))
    rows = record_rows[order]
    fls = record_fls[order].astype(np.int64)
    offs = record_offs[order].astype(np.int64)
    counts = np.bincount(rows, minlength=n_records).astype(np.int64)
    # delta-encode fl within each record
    fl_delta = fls.copy()
    if fls.size:
        first_of_record = np.zeros(fls.size, bool)
        starts = np.cumsum(np.concatenate([[0], counts[:-1]]))
        starts = starts[counts > 0]
        first_of_record[starts] = True
        fl_delta[1:] = np.where(first_of_record[1:], fls[1:], fls[1:] - fls[:-1])
    # interleave: counts then per-record payload — emit as single stream:
    # [c_0, payload_0..., c_1, payload_1, ...]
    total = n_records + 2 * fls.size
    out = np.empty(total, np.uint64)
    # compute write offsets
    rec_sizes = 1 + 2 * counts
    rec_starts = np.cumsum(np.concatenate([[0], rec_sizes[:-1]]))
    out[rec_starts] = counts.astype(np.uint64)
    if fls.size:
        payload_base = np.repeat(rec_starts + 1, counts)
        within = np.arange(fls.size) - np.repeat(np.cumsum(np.concatenate([[0], counts[:-1]])), counts)
        out[payload_base + 2 * within] = np.where(fl_delta >= 0, fl_delta, 0).astype(np.uint64)  # fl deltas are >=0 by sort
        out[payload_base + 2 * within + 1] = zigzag_encode(offs)
    return varbyte_encode(out)


def decode_nsw_stream(blob: bytes, n_records: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode -> (record_rows, fls, offsets), neighbors sorted by record."""
    vals = varbyte_decode(blob)
    if vals.size == 0:
        return (np.zeros(0, np.int64),) * 3
    rows_l, fls_l, offs_l = [], [], []
    i = 0
    rec = 0
    vals_i = vals.astype(np.int64)
    while rec < n_records and i < vals.size:
        c = int(vals_i[i])
        i += 1
        if c:
            payload = vals_i[i : i + 2 * c]
            fl = np.cumsum(payload[0::2])
            off = zigzag_decode(payload[1::2].astype(np.uint64))
            rows_l.append(np.full(c, rec, np.int64))
            fls_l.append(fl)
            offs_l.append(off)
            i += 2 * c
        rec += 1
    if not rows_l:
        return (np.zeros(0, np.int64),) * 3
    return np.concatenate(rows_l), np.concatenate(fls_l), np.concatenate(offs_l)


def build_nsw_neighbors(
    gpos_all_stop: np.ndarray,
    stop_lemma_ids: np.ndarray,
    anchor_gpos: np.ndarray,
    max_distance: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized neighbor collection.

    gpos_all_stop: sorted global positions of stop-lemma occurrences;
    stop_lemma_ids: their lemma ids (FL numbers);
    anchor_gpos: global positions of the non-stop postings (any order).

    Returns (anchor_row, fl, offset) triples. Global positions must embed
    document gaps > max_distance so windows never cross documents.
    """
    rows_l, fls_l, offs_l = [], [], []
    lo = np.searchsorted(gpos_all_stop, anchor_gpos - max_distance, side="left")
    hi = np.searchsorted(gpos_all_stop, anchor_gpos + max_distance, side="right")
    counts = hi - lo
    if counts.sum() == 0:
        return (np.zeros(0, np.int64),) * 3
    rows = np.repeat(np.arange(anchor_gpos.size, dtype=np.int64), counts)
    # vectorized segmented arange: take[k] = lo[row(k)] + (k - segment_start(k))
    seg_off = np.repeat(np.cumsum(counts) - counts, counts)
    take = np.repeat(lo, counts) + (np.arange(int(counts.sum()), dtype=np.int64) - seg_off)
    fls = stop_lemma_ids[take].astype(np.int64)
    offs = gpos_all_stop[take].astype(np.int64) - anchor_gpos[rows]
    keep = offs != 0
    return rows[keep], fls[keep], offs[keep]
