"""Index construction (paper §1.2): ordinary index (+NSW streams),
two-component (w,v) index, three-component (f,s,t) index.

Everything is vectorized numpy; per-token Python loops are avoided so the
d=9 build over millions of tokens stays tractable (the paper notes index
creation cost rises with MaxDistance — the (f,s,t) index emits
C(2d,2) candidate pairs per stop-lemma occurrence).

Conventions
-----------
* lemma id == 0-based FL-number (see lexicon.py);
* *global positions* `g = doc_start[doc] + pos` with inter-document gaps
  > MaxDistance so proximity windows never straddle documents;
* (f,s,t) keys: s,t canonically ordered by FL-number (s <= t); a key with
  s == t requires two *distinct* occurrences ("who ... who" semantics);
* (f,s,t) postings: one per (key, doc, P_f), keeping the nearest-offset
  witness pair: (doc, P_f, zz(off_s), zz(off_t));
* (w,v) keys: both lemmas non-stop, at least one frequently-used,
  canonically ordered; postings (doc, P_w, zz(P_v - P_w)).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.lexicon import Lexicon
from repro_torch.core.nsw import build_nsw_neighbors, decode_nsw_stream, encode_nsw_stream
from repro_torch.core.postings import BlobStore, ByteMeter, PostingStore
from repro_torch.data.corpus import TokenTable

_K_SLOTS = 2  # max lemma alternatives tracked per token position


@dataclass
class NSWStreams:
    """Per-lemma NSW record streams, lazily varbyte-encoded."""

    neighbor_rows: np.ndarray  # (E,) global posting ordinal (ordinary order)
    neighbor_fls: np.ndarray
    neighbor_offs: np.ndarray
    lemma_row_start: dict  # lemma -> (start_row, end_row) in ordinary order
    _blobs: dict = field(default_factory=dict, repr=False)

    def blob(self, lemma: int) -> bytes:
        b = self._blobs.get(lemma)
        if b is None:
            se = self.lemma_row_start.get(lemma)
            if se is None:
                return b""
            s, e = se
            lo = np.searchsorted(self.neighbor_rows, s, side="left")
            hi = np.searchsorted(self.neighbor_rows, e, side="left")
            b = encode_nsw_stream(
                self.neighbor_rows[lo:hi] - s,
                self.neighbor_fls[lo:hi],
                self.neighbor_offs[lo:hi],
                e - s,
            )
            self._blobs[lemma] = b
        return b

    def read(self, lemma: int, meter: ByteMeter | None = None):
        se = self.lemma_row_start.get(lemma)
        if se is None:
            return (np.zeros(0, np.int64),) * 3
        blob = self.blob(lemma)
        if meter is not None:
            meter.add(len(blob), 0)
        return decode_nsw_stream(blob, se[1] - se[0])

    def records(self, lemma: int):
        """Unencoded (rows, fls, offs) for one lemma, normalized to the
        decode order (row, fl, off) — the cheap path for segment merges."""
        se = self.lemma_row_start.get(lemma)
        if se is None:
            return (np.zeros(0, np.int64),) * 3
        s, e = se
        lo = np.searchsorted(self.neighbor_rows, s, side="left")
        hi = np.searchsorted(self.neighbor_rows, e, side="left")
        rows = self.neighbor_rows[lo:hi] - s
        fls = self.neighbor_fls[lo:hi]
        offs = self.neighbor_offs[lo:hi]
        order = np.lexsort((offs, fls, rows))
        return rows[order].astype(np.int64), fls[order].astype(np.int64), offs[order].astype(np.int64)


@dataclass
class ProximityIndex:
    """The paper's composite index (Idx2..Idx4); with the additional
    structures disabled it degrades to the ordinary inverted file (Idx1)."""

    lexicon: Lexicon
    max_distance: int
    ordinary: PostingStore  # lemma -> (doc, pos)
    nsw: NSWStreams | None
    wv: PostingStore | None  # (w,v) -> (doc, p_w, zz_off)
    fst: PostingStore | None  # (f,s,t) -> (doc, p_f, zz_off_s, zz_off_t)
    doc_lengths: np.ndarray | None = None

    @property
    def has_additional(self) -> bool:
        return self.fst is not None

    def read_ordinary(self, lemma: int, meter: ByteMeter | None = None):
        cols = self.ordinary.read(lemma, meter)
        return cols[0], cols[1]

    def read_wv(self, key, meter: ByteMeter | None = None):
        from repro_torch.core.codecs import zigzag_decode

        cols = self.wv.read(key, meter)
        return cols[0], cols[1], zigzag_decode(cols[2].astype(np.uint64))

    def read_fst(self, key, meter: ByteMeter | None = None):
        from repro_torch.core.codecs import zigzag_decode

        cols = self.fst.read(key, meter)
        return (
            cols[0],
            cols[1],
            zigzag_decode(cols[2].astype(np.uint64)),
            zigzag_decode(cols[3].astype(np.uint64)),
        )

    def size_report(self) -> dict:
        rep = {"ordinary_bytes": self.ordinary.total_bytes()}
        if self.wv is not None:
            rep["wv_bytes"] = self.wv.total_bytes()
            rep["wv_keys"] = len(self.wv.counts)
        if self.fst is not None:
            rep["fst_bytes"] = self.fst.total_bytes()
            rep["fst_keys"] = len(self.fst.counts)
        return rep


def _group_store(store: PostingStore, keys_sorted: np.ndarray, cols: list[np.ndarray], tuple_keys: bool) -> None:
    """Bulk-register per-key row spans. keys_sorted is (n, kdim) or (n,).

    Registration is O(n keys) dict work via ``PostingStore.put_bulk`` —
    per-key column slices are cut lazily on first read. This is the seal
    hot path: a memtable seal's latency is dominated by grouping the
    (w,v)/(f,s,t) row streams into ~10^5 keys (DESIGN.md §18)."""
    if keys_sorted.size == 0:
        return
    if keys_sorted.ndim == 1:
        change = np.nonzero(np.diff(keys_sorted))[0] + 1
    else:
        change = np.nonzero(np.any(np.diff(keys_sorted, axis=0) != 0, axis=1))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [keys_sorted.shape[0]]])
    store.put_bulk(keys_sorted[starts], starts, ends, cols)


def _global_positions(table: TokenTable, max_distance: int):
    gap = max_distance + 1
    starts = np.zeros(table.n_docs + 1, np.int64)
    np.cumsum(table.doc_lengths.astype(np.int64) + gap, out=starts[1:])
    g = starts[table.doc_ids] + table.positions.astype(np.int64) + gap  # margin at front
    return g, int(starts[-1] + gap)


def build_index(
    table: TokenTable,
    lexicon: Lexicon,
    max_distance: int = 5,
    build_wv: bool = True,
    build_fst: bool = True,
    build_nsw: bool = True,
) -> ProximityIndex:
    """Single-shot build == one sealed segment of the incremental path.

    The numeric construction lives in :func:`build_segment_index`. The
    segmented index is not part of this package yet, so the table is
    normalized here exactly as a memtable seal normalizes it (int32
    columns, doc ids unchanged), which keeps the result array-identical
    to the segment-routed build of the reference package."""
    if table.n_docs:
        table = TokenTable(
            table.doc_ids.astype(np.int32),
            table.positions.astype(np.int32),
            table.lemma_ids.astype(np.int32),
            np.asarray(table.doc_lengths, np.int32),
        )
    return build_segment_index(table, lexicon, max_distance, build_wv, build_fst, build_nsw)


def build_segment_index(
    table: TokenTable,
    lexicon: Lexicon,
    max_distance: int = 5,
    build_wv: bool = True,
    build_fst: bool = True,
    build_nsw: bool = True,
) -> ProximityIndex:
    """Build all four paper index structures for one corpus slice (a
    segment). Doc ids in `table` are segment-local."""
    t = table.sorted_copy()  # (doc, pos, lemma)
    sw = lexicon.sw_count
    fu_hi = lexicon.sw_count + lexicon.fu_count
    d = max_distance
    g, G = _global_positions(t, d)

    # ---- ordinary index: rows sorted by (lemma, doc, pos) ----------------
    ord_order = np.lexsort((t.positions, t.doc_ids, t.lemma_ids))
    o_lem = t.lemma_ids[ord_order]
    o_doc = t.doc_ids[ord_order].astype(np.int64)
    o_pos = t.positions[ord_order].astype(np.int64)
    ordinary = PostingStore(n_columns=2)
    _group_store(ordinary, o_lem, [o_doc, o_pos], tuple_keys=False)

    # ---- position -> lemma slots table ------------------------------------
    # (padded margins already guaranteed by the leading/ trailing gaps)
    pos_lem = np.full((G + d + 1, _K_SLOTS), -1, np.int32)
    # slot index: within-run ordinal of rows sharing (doc,pos); t is sorted
    same_as_prev = np.zeros(t.n_rows, bool)
    if t.n_rows > 1:
        same_as_prev[1:] = (t.doc_ids[1:] == t.doc_ids[:-1]) & (t.positions[1:] == t.positions[:-1])
    slot = np.zeros(t.n_rows, np.int64)
    run = 0
    # vectorized run ordinal: cumsum resetting at run starts
    cs = np.cumsum(same_as_prev.astype(np.int64))
    run_start_cs = np.where(~same_as_prev, cs, 0)
    np.maximum.accumulate(run_start_cs, out=run_start_cs)
    slot = cs - run_start_cs
    keep = slot < _K_SLOTS
    pos_lem[g[keep], slot[keep]] = t.lemma_ids[keep]

    stop_mask = t.lemma_ids < sw
    nsw_streams = None
    wv_store = None
    fst_store = None

    # ---- (f,s,t) three-component index ------------------------------------
    if build_fst:
        f_rows = np.nonzero(stop_mask)[0]
        gF = g[f_rows]
        f_lem = t.lemma_ids[f_rows].astype(np.int32)
        f_doc = t.doc_ids[f_rows].astype(np.int32)
        f_pos = t.positions[f_rows].astype(np.int32)
        offsets = [o for o in range(-d, d + 1) if o != 0]
        acc = {k: [] for k in ("f", "s", "t", "doc", "pos", "o1", "o2")}
        for i1 in range(len(offsets)):
            o1 = offsets[i1]
            s_slots = pos_lem[gF + o1]
            for i2 in range(i1 + 1, len(offsets)):
                o2 = offsets[i2]
                t_slots = pos_lem[gF + o2]
                for ks in range(_K_SLOTS):
                    s_c = s_slots[:, ks]
                    vs = (s_c >= 0) & (s_c < sw)
                    if not vs.any():
                        continue
                    for kt in range(_K_SLOTS):
                        t_c = t_slots[:, kt]
                        sel = np.nonzero(vs & (t_c >= 0) & (t_c < sw))[0]
                        if sel.size == 0:
                            continue
                        s_v, t_v = s_c[sel], t_c[sel]
                        swapmask = s_v > t_v
                        s_fin = np.where(swapmask, t_v, s_v)
                        t_fin = np.where(swapmask, s_v, t_v)
                        acc["f"].append(f_lem[sel])
                        acc["s"].append(s_fin)
                        acc["t"].append(t_fin)
                        acc["doc"].append(f_doc[sel])
                        acc["pos"].append(f_pos[sel])
                        acc["o1"].append(np.where(swapmask, np.int32(o2), np.int32(o1)))
                        acc["o2"].append(np.where(swapmask, np.int32(o1), np.int32(o2)))
        fst_store = PostingStore(n_columns=4)
        if acc["f"]:
            fa = np.concatenate(acc["f"])
            sa = np.concatenate(acc["s"])
            ta = np.concatenate(acc["t"])
            da = np.concatenate(acc["doc"])
            pa = np.concatenate(acc["pos"])
            o1a = np.concatenate(acc["o1"])
            o2a = np.concatenate(acc["o2"])
            cost = np.abs(o1a).astype(np.int32) + np.abs(o2a).astype(np.int32)
            order = np.lexsort((cost, pa, da, ta, sa, fa))
            fa, sa, ta, da, pa, o1a, o2a = (
                x[order] for x in (fa, sa, ta, da, pa, o1a, o2a)
            )
            # dedupe per (f,s,t,doc,pos): keep first (min cost)
            first = np.ones(fa.size, bool)
            first[1:] = (
                (fa[1:] != fa[:-1])
                | (sa[1:] != sa[:-1])
                | (ta[1:] != ta[:-1])
                | (da[1:] != da[:-1])
                | (pa[1:] != pa[:-1])
            )
            sel = np.nonzero(first)[0]
            from repro_torch.core.codecs import zigzag_encode

            keys = np.stack([fa[sel], sa[sel], ta[sel]], axis=1)
            _group_store(
                fst_store,
                keys,
                [
                    da[sel].astype(np.int64),
                    pa[sel].astype(np.int64),
                    zigzag_encode(o1a[sel]),
                    zigzag_encode(o2a[sel]),
                ],
                tuple_keys=True,
            )

    # ---- (w,v) two-component index -----------------------------------------
    if build_wv:
        n_rows_idx = np.nonzero(~stop_mask)[0]
        gN = g[n_rows_idx]
        w_lem = t.lemma_ids[n_rows_idx].astype(np.int32)
        w_doc = t.doc_ids[n_rows_idx].astype(np.int32)
        w_pos = t.positions[n_rows_idx].astype(np.int32)
        acc2 = {k: [] for k in ("a", "b", "doc", "pos", "off")}
        for o in range(1, d + 1):
            v_slots = pos_lem[gN + o]
            for kv in range(_K_SLOTS):
                v_c = v_slots[:, kv]
                fu_ok = (w_lem < fu_hi) | (v_c < fu_hi)
                sel = np.nonzero((v_c >= sw) & fu_ok)[0]
                if sel.size == 0:
                    continue
                wv_, vv_ = w_lem[sel], v_c[sel]
                swapmask = wv_ > vv_
                a = np.where(swapmask, vv_, wv_)
                b = np.where(swapmask, wv_, vv_)
                p_a = np.where(swapmask, w_pos[sel] + o, w_pos[sel])
                off = np.where(swapmask, -o, o).astype(np.int32)
                acc2["a"].append(a)
                acc2["b"].append(b)
                acc2["doc"].append(w_doc[sel])
                acc2["pos"].append(p_a)
                acc2["off"].append(off)
        wv_store = PostingStore(n_columns=3)
        if acc2["a"]:
            aa = np.concatenate(acc2["a"])
            ba = np.concatenate(acc2["b"])
            da = np.concatenate(acc2["doc"])
            pa = np.concatenate(acc2["pos"])
            fa_off = np.concatenate(acc2["off"])
            order = np.lexsort((fa_off, pa, da, ba, aa))
            aa, ba, da, pa, fa_off = (x[order] for x in (aa, ba, da, pa, fa_off))
            first = np.ones(aa.size, bool)
            first[1:] = (
                (aa[1:] != aa[:-1])
                | (ba[1:] != ba[:-1])
                | (da[1:] != da[:-1])
                | (pa[1:] != pa[:-1])
                | (fa_off[1:] != fa_off[:-1])
            )
            sel = np.nonzero(first)[0]
            from repro_torch.core.codecs import zigzag_encode

            keys = np.stack([aa[sel], ba[sel]], axis=1)
            _group_store(
                wv_store,
                keys,
                [da[sel].astype(np.int64), pa[sel].astype(np.int64), zigzag_encode(fa_off[sel])],
                tuple_keys=True,
            )

    # ---- NSW streams --------------------------------------------------------
    if build_nsw:
        stop_rows = np.nonzero(stop_mask)[0]
        g_stop = g[stop_rows]
        stop_order = np.argsort(g_stop, kind="stable")
        g_stop_sorted = g_stop[stop_order]
        stop_lem_sorted = t.lemma_ids[stop_rows][stop_order].astype(np.int64)
        nonstop_in_ord = np.nonzero(o_lem >= sw)[0]
        anchor_g = np.zeros(o_lem.size, np.int64)
        anchor_g = g[ord_order]
        rows, fls, offs = build_nsw_neighbors(
            g_stop_sorted, stop_lem_sorted, anchor_g[nonstop_in_ord], d
        )
        # map back to global ordinary row numbers
        rows = nonstop_in_ord[rows]
        order2 = np.argsort(rows, kind="stable")
        rows, fls, offs = rows[order2], fls[order2], offs[order2]
        # lemma -> row span in ordinary order
        lemma_row_start = {}
        if o_lem.size:
            change = np.nonzero(np.diff(o_lem))[0] + 1
            starts = np.concatenate([[0], change])
            ends = np.concatenate([change, [o_lem.size]])
            for s, e in zip(starts.tolist(), ends.tolist()):
                lem = int(o_lem[s])
                if lem >= sw:
                    lemma_row_start[lem] = (s, e)
        nsw_streams = NSWStreams(rows, fls, offs, lemma_row_start)

    return ProximityIndex(
        lexicon=lexicon,
        max_distance=d,
        ordinary=ordinary,
        nsw=nsw_streams,
        wv=wv_store,
        fst=fst_store,
        doc_lengths=t.doc_lengths,
    )
