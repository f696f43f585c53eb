"""Posting-list storage with byte-metered access.

Layout mirrors the paper:
  * ordinary index: per lemma, stream-1 = (doc,pos) postings; stream-2 =
    NSW records (separate so QT3/QT4 can *skip* them, paper §1.2/QT5);
  * (w,v) index: per two-component key, (doc, p_w, zz(p_v-p_w)) triples;
  * (f,s,t) index: per three-component key, (doc, p_f, zz(off_s), zz(off_t)).

All streams are delta+varbyte encoded. A `ByteMeter` counts every byte
decoded on behalf of a query — the paper's "data read size" metric.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.codecs import (
    delta_decode,
    delta_encode,
    varbyte_decode,
    varbyte_encode,
    zigzag_decode,
    zigzag_encode,
)


@dataclass
class ByteMeter:
    bytes_read: int = 0
    postings_read: int = 0

    def reset(self) -> None:
        self.bytes_read = 0
        self.postings_read = 0

    def add(self, nbytes: int, npostings: int) -> None:
        self.bytes_read += int(nbytes)
        self.postings_read += int(npostings)


def encode_postings(columns: list[np.ndarray], delta_col: int = 0) -> bytes:
    """Encode parallel posting columns. Column `delta_col` (doc ids) is
    delta-encoded; column delta_col+1 (positions) is delta-encoded within
    runs of equal doc id; remaining columns are stored verbatim (they are
    already zigzagged small offsets). Interleaved row-major like a real
    on-disk posting stream."""
    n = columns[0].size
    if n == 0:
        return b""
    docs = columns[delta_col].astype(np.int64)
    doc_gap = delta_encode(docs)
    enc_cols = []
    for ci, col in enumerate(columns):
        if ci == delta_col:
            enc_cols.append(doc_gap)
        elif ci == delta_col + 1:
            pos = col.astype(np.int64)
            pg = np.empty(n, np.int64)
            pg[0] = pos[0]
            same = docs[1:] == docs[:-1]
            pg[1:] = np.where(same, pos[1:] - pos[:-1], pos[1:])
            # position gaps can be negative only if input unsorted; zigzag to be safe
            enc_cols.append(zigzag_encode(pg))
        else:
            enc_cols.append(col.astype(np.uint64))
    inter = np.empty(n * len(columns), np.uint64)
    for ci, col in enumerate(enc_cols):
        inter[ci :: len(columns)] = col
    return varbyte_encode(inter)


def decode_postings(buf: bytes, n_columns: int) -> list[np.ndarray]:
    vals = varbyte_decode(buf)
    if vals.size == 0:
        return [np.zeros(0, np.int64) for _ in range(n_columns)]
    n = vals.size // n_columns
    cols = [vals[ci::n_columns] for ci in range(n_columns)]
    docs = delta_decode(cols[0])
    out = [docs]
    pg = zigzag_decode(cols[1])
    # positions: cumulative within doc runs -> reconstruct via segmented cumsum
    pos = np.empty(n, np.int64)
    pos[0] = pg[0]
    boundaries = np.empty(n, bool)
    boundaries[0] = True
    boundaries[1:] = docs[1:] != docs[:-1]
    # segmented cumsum: cumsum then subtract carry at boundaries
    cs = np.cumsum(pg)
    seg_start = np.nonzero(boundaries)[0]
    carry = np.zeros(n, np.int64)
    carry_vals = cs[seg_start] - pg[seg_start]
    carry[seg_start] = np.diff(np.concatenate([[0], carry_vals]))
    pos = cs - np.cumsum(carry)
    out.append(pos)
    for ci in range(2, n_columns):
        out.append(cols[ci].astype(np.int64))
    return out


class PostingStore:
    """Maps key -> encoded blob (+ posting count); metered decode access.

    Two registration paths:

    * ``put_raw(key, cols)`` — per-key, dict-backed (loads, ad-hoc use);
    * ``put_bulk(keys_arr, starts, ends, cols)`` — the whole store at
      once over one shared column arena (the seal/merge build paths).
      Per-key reads binary-search an integer mixed-radix encoding of the
      key, and the public ``counts`` dict materializes lazily on first
      iteration, so registering 10^5 keys is O(K) numpy work with no
      per-key Python loop — the memtable-seal latency hot path
      (DESIGN.md §18).
    """

    def __init__(self, n_columns: int):
        self.n_columns = n_columns
        self.blobs: dict = {}  # key -> encoded blob (lazy cache)
        self._counts: dict = {}
        self._counts_full = True  # no bulk arena yet -> dict is authoritative
        self._raw: dict = {}  # key -> raw columns (lazily encoded)
        # (keys2d, starts, ends, cols, enc, strides_l, maxes_l, scalar)
        self._bulk = None

    def put_raw(self, key, columns: list[np.ndarray]) -> None:
        """Register raw columns; encoding happens lazily on first access."""
        self._raw[key] = columns
        self._counts[key] = int(columns[0].size)

    def put_bulk(self, keys_arr: np.ndarray, starts: np.ndarray,
                 ends: np.ndarray, columns: list[np.ndarray]) -> None:
        """Register every key of this store at once over one shared arena.

        ``keys_arr`` is ``(K,)`` (scalar keys) or ``(K, kdim)``, lexico-
        graphically sorted and unique; key ``i`` owns rows
        ``starts[i]:ends[i]`` of every column. Requires an empty store."""
        if self._counts or self._raw or self._bulk is not None:
            raise ValueError("put_bulk requires an empty store")
        keys2d = np.asarray(keys_arr, np.int64)
        scalar = keys2d.ndim == 1
        if scalar:
            keys2d = keys2d.reshape(-1, 1)
        starts = np.asarray(starts, np.int64)
        ends = np.asarray(ends, np.int64)
        kdim = keys2d.shape[1]
        maxes = (keys2d.max(axis=0) + 1) if keys2d.size else np.ones(kdim, np.int64)
        maxes_l = [int(m) for m in maxes]
        strides_l = [1] * kdim
        cap = 1
        for j in range(kdim - 2, -1, -1):
            strides_l[j] = strides_l[j + 1] * maxes_l[j + 1]
        for m in maxes_l:
            cap *= m
        if cap >= 2**62:  # encoding would overflow int64: rare, go per-key
            keys_l = (keys2d[:, 0].tolist() if scalar
                      else list(map(tuple, keys2d.tolist())))
            for k, s, e in zip(keys_l, starts.tolist(), ends.tolist()):
                self.put_raw(k, [c[s:e] for c in columns])
            return
        enc = keys2d @ np.asarray(strides_l, np.int64)
        self._bulk = (keys2d, starts, ends, columns, enc, strides_l, maxes_l, scalar)
        self._counts_full = False

    def _bulk_find(self, key) -> int:
        """Index of ``key`` in the bulk arena, or -1."""
        b = self._bulk
        if b is None:
            return -1
        enc, strides_l, maxes_l = b[4], b[5], b[6]
        comps = key if isinstance(key, tuple) else (key,)
        if len(comps) != len(strides_l):
            return -1
        e = 0
        for c, st, m in zip(comps, strides_l, maxes_l):
            c = int(c)
            if c < 0 or c >= m:
                return -1  # out-of-range component can't be stored
            e += c * st
        i = int(np.searchsorted(enc, e))
        if i < enc.size and int(enc[i]) == e:
            return i
        return -1

    @property
    def counts(self) -> dict:
        """key -> posting count. Materialized lazily from the bulk arena on
        first access; per-key lookups should prefer ``n_postings``/``in``,
        which never materialize."""
        if not self._counts_full:
            self._counts_full = True
            b = self._bulk
            keys2d, starts, ends = b[0], b[1], b[2]
            cnts = (ends - starts).tolist()
            ks = (keys2d[:, 0].tolist() if b[7]
                  else map(tuple, keys2d.tolist()))
            merged = dict(zip(ks, cnts))
            merged.update(self._counts)  # per-key overrides win
            self._counts = merged
        return self._counts

    def bulk_rows(self):
        """Zero-copy ``(keys2d, starts, ends, columns)`` over the whole
        store when it is backed by one contiguous bulk arena with no
        per-key overrides; ``None`` otherwise (per-key/decoded stores).
        Lets a segment merge gather all rows without a per-key loop."""
        b = self._bulk
        if b is None or self._raw:
            return None
        keys2d, starts, ends, cols = b[0], b[1], b[2], b[3]
        n = int(cols[0].shape[0])
        if not (starts.size and int(starts[0]) == 0 and int(ends[-1]) == n
                and np.array_equal(starts[1:], ends[:-1])):
            return None  # spans don't tile the arena; fall back to per-key
        return keys2d, starts, ends, cols

    def _raw_cols(self, key) -> list[np.ndarray] | None:
        """Raw (undecoded) columns for a key, cutting arena slices lazily."""
        cols = self._raw.get(key)
        if cols is not None:
            return cols
        i = self._bulk_find(key)
        if i < 0:
            return None
        b = self._bulk
        s, e = int(b[1][i]), int(b[2][i])
        return [c[s:e] for c in b[3]]

    def _blob(self, key) -> bytes:
        b = self.blobs.get(key)
        if b is None:
            cols = self._raw_cols(key)
            if cols is None:
                return b""
            b = encode_postings(cols)
            self.blobs[key] = b
        return b

    def __contains__(self, key) -> bool:
        return key in self._counts or self._bulk_find(key) >= 0

    def keys(self):
        return self.counts.keys()

    def n_keys(self) -> int:
        """Number of keys, without materializing the counts dict."""
        n = len(self._counts)
        if not self._counts_full:
            n += self._bulk[0].shape[0]
        return n

    def n_postings(self, key) -> int:
        c = self._counts.get(key)
        if c is not None:
            return c
        i = self._bulk_find(key)
        if i >= 0:
            b = self._bulk
            return int(b[2][i] - b[1][i])
        return 0

    def read(self, key, meter: ByteMeter | None = None) -> list[np.ndarray]:
        """Metered decode of a full posting list (the paper reads posting
        lists sequentially from disk; Idx1 queries consume them fully)."""
        blob = self._blob(key)
        if meter is not None:
            meter.add(len(blob), self.n_postings(key))
        return decode_postings(blob, self.n_columns)

    def columns(self, key) -> list[np.ndarray]:
        """Unmetered decoded columns, skipping the codec round-trip when the
        raw columns are still in memory (segment merges, not query serving:
        queries go through `read` so the ByteMeter sees every byte)."""
        cols = self._raw_cols(key)
        if cols is not None:
            return [np.asarray(c).astype(np.int64) for c in cols]
        return decode_postings(self._blob(key), self.n_columns)

    def total_bytes(self) -> int:
        # force-encode everything (used by index-size reports, not queries)
        return sum(len(self._blob(k)) for k in self.counts)


@dataclass
class BlobStore:
    """Opaque per-key byte blobs (NSW record streams)."""

    blobs: dict = field(default_factory=dict)

    def put(self, key, blob: bytes) -> None:
        self.blobs[key] = blob

    def read(self, key, meter: ByteMeter | None = None) -> bytes:
        b = self.blobs.get(key, b"")
        if meter is not None:
            meter.add(len(b), 0)
        return b

    def total_bytes(self) -> int:
        return sum(len(b) for b in self.blobs.values())
