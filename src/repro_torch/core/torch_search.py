"""Batched proximity search on a device: the paper's engine as fixed-shape
serve steps in PyTorch, plus the host packers that feed them.

Key re-design vs the CPU engine (DESIGN.md §3):
* postings live in dense, padded int32 device tensors; (doc, pos) pairs
  are packed as g = doc * stride + pos (documents are strided so windows
  can't cross them);
* a batch of B queries is evaluated at once; each query carries K posting
  rows of bucketed length L (padding = SENTINEL). K and L are fixed per
  step shape — the bounded shape is the response-time guarantee;
* Equalize == sorted intersection: key list 0 is the anchor stream; lists
  1..K-1 are joined via batched ``torch.searchsorted`` membership;
* the QT3/QT4/QT5 window join runs the hand-written CUDA kernel on a card
  (``kernels.nearest_r.window_join``).

This module serves one document shard: the reference package's per-shard
top-k all-gather over the model axis is the identity here, and the second
top-k over the gathered candidates is too (a stable sort of an already
sorted row keeps it as it is). Only the raw int32 payload is served; the
block-delta16 and offsets payloads arrive with the compressed slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.index_builder import ProximityIndex
from repro_torch.core.query import qt2_plan, qt34_plan, qt5_plan, select_fst_keys
from repro_torch.kernels.common import SENTINEL
from repro_torch.kernels.nearest_r import window_join

NEG_INF = -1e30  # float32 score of an invalid lane


# --------------------------------------------------------------------------
# batched single-device primitives
# --------------------------------------------------------------------------
def _membership(g0: torch.Tensor, gk: torch.Tensor):
    """Batched membership of g0 rows in gk rows: (B, L) int32 each.
    Returns (found, idx) with idx the clipped insertion point."""
    idx = torch.searchsorted(gk.contiguous(), g0.contiguous())
    idx_c = idx.clamp(0, gk.shape[1] - 1)
    found = (torch.gather(gk, 1, idx_c) == g0) & (g0 != SENTINEL)
    return found, idx_c


def qt1_join(key_g, key_lo, key_hi):
    """Join K key posting lists on the anchor stream (list 0).

    key_g/lo/hi: (B, K, L) int32. Returns (valid, lo, hi) each (B, L),
    aligned with the anchor list."""
    K = key_g.shape[1]
    g0 = key_g[:, 0]
    valid = g0 != SENTINEL
    lo = key_lo[:, 0]
    hi = key_hi[:, 0]
    for k in range(1, K):
        found, idx = _membership(g0, key_g[:, k])
        valid = valid & found
        lo_k = torch.gather(key_lo[:, k], 1, idx)
        hi_k = torch.gather(key_hi[:, k], 1, idx)
        lo = torch.where(found, torch.minimum(lo, lo_k), lo)
        hi = torch.where(found, torch.maximum(hi, hi_k), hi)
    return valid, lo, hi


def qt1_score(valid, lo, hi, idf_sum, span_adjust):
    """idf_sum / (1 + span_excess) in float32, in the reference's order
    of operations (int32 span minus float32 adjust, clamped at 0)."""
    span_excess = torch.clamp_min((hi - lo) - span_adjust[:, None], 0)
    return torch.where(valid, idf_sum[:, None] / (1.0 + span_excess), NEG_INF)


def qt1_topk(score, g_anchor, lo, hi, k: int):
    """Top-k lanes by score; among equal scores the lower lane index
    comes first (a stable descending sort — ``torch.topk`` promises no
    tie order on a card)."""
    order = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    take = lambda x: torch.gather(x, 1, order)  # noqa: E731
    return take(score), take(g_anchor), take(lo), take(hi)


# --------------------------------------------------------------------------
# (w,v)-key / NSW joins (QT2 and QT5)
# --------------------------------------------------------------------------
QT2_BIG_DIST = 2**31 - 1  # "no candidate" distance (> any max_sep)


def _nearest1(b_rows, centers, max_sep: int):
    """Batched nearest-value lookup: for each center, the closest value of
    the sorted row b within max_sep. (B, L) int32 each, SENTINEL-padded.
    Ties prefer the predecessor (the CPU engine's candidate column order
    [idx-1, idx] under a stable sort). Returns (matched, value, first_idx)
    where first_idx is the value's *first* occurrence in b — the CPU
    engine recovers the partner interval's end via searchsorted on starts,
    which lands on the first duplicate."""
    Lb = b_rows.shape[-1]
    b_rows = b_rows.contiguous()
    idx = torch.searchsorted(b_rows, centers)
    prev = torch.gather(b_rows, 1, (idx - 1).clamp(0, Lb - 1))
    nxt = torch.gather(b_rows, 1, idx.clamp(0, Lb - 1))
    d_prev = torch.where((idx >= 1) & (prev != SENTINEL), centers - prev, QT2_BIG_DIST)
    d_next = torch.where((idx < Lb) & (nxt != SENTINEL), nxt - centers, QT2_BIG_DIST)
    d_prev = torch.where(d_prev <= max_sep, d_prev, QT2_BIG_DIST)
    d_next = torch.where(d_next <= max_sep, d_next, QT2_BIG_DIST)
    take_prev = d_prev <= d_next
    matched = torch.where(take_prev, d_prev, d_next) <= max_sep
    val = torch.where(matched, torch.where(take_prev, prev, nxt), centers)
    first = torch.searchsorted(b_rows, val).clamp(0, Lb - 1)
    return matched, val, first


def qt2_join(wv_lo, wv_hi, n_keys, max_sep: int):
    """Join K (w,v)-interval lists on the anchor list (list 0 — the host
    packers order lists sparsest-first, mirroring the CPU engine's anchor
    choice). wv_lo/wv_hi: (B, K, L) int32 sorted by lo, SENTINEL-padded;
    n_keys: (B,) int32 — lists k >= n_keys[b] are padding and do not
    constrain. For every anchor interval each other list must contribute
    an interval starting within max_sep (= 2*MaxDistance); the nearest
    such interval extends the fragment. Returns (valid, lo, hi) aligned
    with the anchor list."""
    K = wv_lo.shape[1]
    a_lo = wv_lo[:, 0].contiguous()
    valid = a_lo != SENTINEL
    lo = a_lo
    hi = wv_hi[:, 0]
    for k in range(1, K):
        m, val, j = _nearest1(wv_lo[:, k], a_lo, max_sep)
        b_hi = torch.gather(wv_hi[:, k], 1, j)
        active = (k < n_keys)[:, None]
        valid = valid & (m | ~active)
        upd = active & m
        lo = torch.where(upd, torch.minimum(lo, val), lo)
        hi = torch.where(upd, torch.maximum(hi, b_hi), hi)
    return valid, lo, hi


def qt34_join(a_g, ns_g, ns_r, max_sep: int, r_max: int):
    """Ordinary-window join (QT3/QT4, DESIGN.md §13): the anchor lemma's
    ordinary posting row against the other lemmas' ordinary rows — for
    each anchor posting, every other row must hold r distinct positions
    within MaxDistance (r = the lemma's query multiplicity, per key,
    r <= r_max); the r nearest extend the fragment. Keys with r == 0 are
    padding and do not constrain. a_g: (B, L); ns_g: (B, Kn, L); ns_r:
    (B, Kn). Returns (valid, lo, hi) aligned with the anchor row.

    Delegates to ``kernels.nearest_r.window_join`` (DESIGN.md §16): the
    CUDA kernel on a card, the sort-free counting join on the CPU."""
    return window_join(a_g, ns_g, ns_r, max_sep=max_sep, r_max=r_max)


def qt5_join(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, max_sep: int, r_max: int):
    """Join the QT5 anchor (rarest non-stop lemma) posting row against
    the other non-stop rows (the ordinary-window join of
    :func:`qt34_join`) and the per-(anchor, stop-lemma) NSW aggregate
    rows (neighbor count >= r plus nearest-offset fragment extension —
    no stop-lemma posting list is ever materialized, the paper's point).
    Keys with r == 0 are padding. The stop constraints fold into the same
    fused ``window_join`` pass, preserving the qt34/qt5 step sharing."""
    return window_join(a_g, ns_g, ns_r, st_cnt, st_ext, st_r,
                       max_sep=max_sep, r_max=r_max)


# --------------------------------------------------------------------------
# serve steps
# --------------------------------------------------------------------------
def _raw_only(payload: str) -> None:
    if payload != "raw":
        raise NotImplementedError(
            f"the {payload!r} payload arrives with the compressed-payload slice "
            "of the port; this slice serves the raw int32 payload")


def make_qt1_serve_step(top_k: int = 16):
    """The QT1 serve step on one document shard:
    ``step(key_g, key_lo, key_hi, idf_sum, span_adjust) -> (s, g, lo, hi)``,
    each (B, top_k)."""

    def step(key_g, key_lo, key_hi, idf_sum, span_adjust):
        valid, lo, hi = qt1_join(key_g, key_lo, key_hi)
        score = qt1_score(valid, lo, hi, idf_sum, span_adjust)
        return qt1_topk(score, key_g[:, 0], lo, hi, top_k)

    return step


def make_wv_serve_step(qtype: str, top_k: int = 16, payload: str = "raw",
                       max_distance: int = 5, r_max: int = 4):
    """The QT2/QT3/QT4/QT5 serve step on one document shard — the
    (w,v)-key / ordinary-window / NSW analogue of
    :func:`make_qt1_serve_step` (DESIGN.md §12-§13). ``"qt34"`` serves
    both QT3 and QT4: their evaluation is identical, only the lemma
    classes differ. Arguments are the ``device_args`` of the matching
    batch: qt2 ``(wv_lo, wv_hi, n_keys, idf_sum, span_adjust)``, qt34
    ``(a_g, ns_g, ns_r, idf_sum, span_adjust)``, qt5 ``(a_g, ns_g, ns_r,
    st_cnt, st_ext, st_r, idf_sum, span_adjust)``."""
    assert qtype in ("qt2", "qt34", "qt5")
    _raw_only(payload)

    def finish(score, lo, hi):
        # the CPU engine derives the doc from lo, so lo doubles as g
        return qt1_topk(score, lo, lo, hi, top_k)

    if qtype == "qt2":
        sep = 2 * max_distance

        def step(wv_lo, wv_hi, n_keys, idf_sum, span_adjust):
            valid, lo, hi = qt2_join(wv_lo, wv_hi, n_keys, sep)
            return finish(qt1_score(valid, lo, hi, idf_sum, span_adjust), lo, hi)
    elif qtype == "qt34":
        def step(a_g, ns_g, ns_r, idf_sum, span_adjust):
            valid, lo, hi = qt34_join(a_g, ns_g, ns_r, max_distance, r_max)
            return finish(qt1_score(valid, lo, hi, idf_sum, span_adjust), lo, hi)
    else:
        def step(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, idf_sum, span_adjust):
            valid, lo, hi = qt5_join(a_g, ns_g, ns_r, st_cnt, st_ext, st_r,
                                     max_distance, r_max)
            return finish(qt1_score(valid, lo, hi, idf_sum, span_adjust), lo, hi)
    return step


# --------------------------------------------------------------------------
# host-side batch packing from a ProximityIndex
# --------------------------------------------------------------------------
def _to_device(arrays, device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


@dataclass
class QT1Batch:
    key_g: np.ndarray  # (B, K, L) int32
    key_lo: np.ndarray
    key_hi: np.ndarray
    idf_sum: np.ndarray  # (B,) f32
    span_adjust: np.ndarray  # (B,) f32 == len(query) - 1
    stride: int

    def device_args(self, device):
        return _to_device((self.key_g, self.key_lo, self.key_hi,
                           self.idf_sum, self.span_adjust), device)


def qt1_stride(index) -> int:
    """Document stride of the g = doc * stride + pos packing. Derived only
    from the (immutable) index, so every batch packed against one snapshot
    agrees on it."""
    max_len = int(index.doc_lengths.max()) if index.doc_lengths is not None else 1
    return max_len + index.max_distance + 2


def batch_size_bucket(n: int, cap: int) -> int:
    """Round a batch size up to the next power of two, capped at `cap`.

    One step shape exists per (B, K, L); padding B to this small ladder
    means at most log2(cap)+1 shapes per L-bucket instead of one for
    every batch size the queue happens to produce."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


def pack_fst_key_rows(
    index,
    key,
    L: int,
    doc_shards: int = 1,
    stride: int | None = None,
    out=None,
):
    """Derive the padded, range-partitioned device rows for one (f,s,t) key.

    Returns ``(g, lo, hi, present)``: three (L,) int32 rows plus whether
    the key exists in the index. Postings are range-partitioned into
    doc_shards contiguous doc ranges, each padded to L // doc_shards.
    Rows depend only on (snapshot, key, L, doc_shards): this is the unit
    the serving layer's PackedPostingCache memoizes (DESIGN.md §11).

    With ``out`` (three caller-provided (L,) views, already
    SENTINEL-filled — e.g. slices of the batch arrays) postings are
    written in place and no rows are allocated, keeping the uncached
    packing path copy-free."""
    if stride is None:
        stride = qt1_stride(index)
    assert L % doc_shards == 0
    Ls = L // doc_shards
    if out is None:
        g_row = np.full(L, SENTINEL, np.int32)
        lo_row = np.full(L, SENTINEL, np.int32)
        hi_row = np.full(L, SENTINEL, np.int32)
    else:
        g_row, lo_row, hi_row = out
    if index.fst is None or key not in index.fst:
        return g_row, lo_row, hi_row, False
    docs, pf, o1, o2 = index.read_fst(key)
    g = (docs * stride + pf).astype(np.int64)
    lo = pf + np.minimum(np.minimum(o1, o2), 0) + docs * stride
    hi = pf + np.maximum(np.maximum(o1, o2), 0) + docs * stride
    _fill_partitioned(docs, (g, lo, hi), index.doc_lengths.size, doc_shards,
                      Ls, (g_row, lo_row, hi_row))
    return g_row, lo_row, hi_row, True


def _fill_partitioned(docs, cols, n_docs, doc_shards, Ls, out_rows):
    """Scatter per-posting columns into range-partitioned row segments:
    shard s holds docs in [s*n/S, (s+1)*n/S), each segment padded to Ls
    entries (out_rows come pre-filled with the pad value). Shared by all
    per-key row packers so every payload kind obeys the same alignment
    invariant."""
    lo_bound = 0
    for s in range(doc_shards):
        hi_bound = ((s + 1) * n_docs) // doc_shards
        m = (docs >= lo_bound) & (docs < hi_bound)
        seg = min(int(m.sum()), Ls)
        sl = slice(s * Ls, s * Ls + seg)
        for col, row in zip(cols, out_rows):
            row[sl] = col[m][:seg]
        lo_bound = hi_bound


def pack_wv_key_rows(
    index,
    key,
    L: int,
    doc_shards: int = 1,
    stride: int | None = None,
    out=None,
):
    """Padded, range-partitioned interval rows for one (w,v) key.

    Returns ``(lo, hi, present)``: two (L,) int32 rows sorted by lo (the
    CPU engine's QT2 item order) plus whether the key exists. The unit
    the serving row cache memoizes under kind "wv"."""
    if stride is None:
        stride = qt1_stride(index)
    assert L % doc_shards == 0
    Ls = L // doc_shards
    if out is None:
        lo_row = np.full(L, SENTINEL, np.int32)
        hi_row = np.full(L, SENTINEL, np.int32)
    else:
        lo_row, hi_row = out
    if index.wv is None or key not in index.wv:
        return lo_row, hi_row, False
    docs, pw, off = index.read_wv(key)
    ga = docs.astype(np.int64) * stride + pw
    gb = ga + off
    lo = np.minimum(ga, gb)
    hi = np.maximum(ga, gb)
    order = np.argsort(lo, kind="stable")
    _fill_partitioned(docs[order], (lo[order], hi[order]),
                      index.doc_lengths.size, doc_shards, Ls, (lo_row, hi_row))
    return lo_row, hi_row, True


def pack_ord_key_rows(
    index,
    lemma: int,
    L: int,
    doc_shards: int = 1,
    stride: int | None = None,
    out=None,
):
    """Padded, range-partitioned g row for one lemma's *ordinary* posting
    list (the QT5 anchor / other-non-stop streams). Returns
    ``(g, present)``; present is False when the lemma has no postings
    (the CPU engine's empty-read early-out)."""
    if stride is None:
        stride = qt1_stride(index)
    assert L % doc_shards == 0
    Ls = L // doc_shards
    g_row = np.full(L, SENTINEL, np.int32) if out is None else out[0]
    docs, pos = index.read_ordinary(lemma)
    if docs.size == 0:
        return g_row, False
    g = docs.astype(np.int64) * stride + pos
    _fill_partitioned(docs, (g,), index.doc_lengths.size, doc_shards, Ls, (g_row,))
    return g_row, True


def pack_nsw_key_rows(
    index,
    key,
    L: int,
    doc_shards: int = 1,
    stride: int | None = None,
    out=None,
):
    """NSW aggregate rows for one (anchor lemma, stop lemma) pair,
    aligned with the anchor's ordinary posting row (same order, padding
    and range partition — zeros at pads). key = (anchor, sid). Returns
    ``(cnt, ext, present)``: per-anchor-posting neighbor count within
    MaxDistance and the nearest neighbor offset (ties prefer the
    negative offset, mirroring the CPU engine's stable lexsort over the
    (row, fl, off)-ordered record stream)."""
    if stride is None:
        stride = qt1_stride(index)
    assert L % doc_shards == 0
    Ls = L // doc_shards
    anchor, sid = key
    if out is None:
        cnt_row = np.zeros(L, np.int32)
        ext_row = np.zeros(L, np.int32)
    else:
        cnt_row, ext_row = out
    a_docs, _ = index.read_ordinary(anchor)
    n = int(a_docs.size)
    if n == 0:
        return cnt_row, ext_row, False
    rows, fls, offs = index.nsw.read(anchor)
    keep = np.abs(offs) <= index.max_distance
    sel = keep & (fls == sid)
    r_rows = rows[sel]
    r_offs = offs[sel]
    cnt = np.bincount(r_rows, minlength=n).astype(np.int64)
    order = np.lexsort((np.abs(r_offs), r_rows))
    rr, ro = r_rows[order], r_offs[order]
    first = np.ones(rr.size, bool)
    first[1:] = rr[1:] != rr[:-1]
    ext = np.zeros(n, np.int64)
    ext[rr[first]] = ro[first]
    _fill_partitioned(a_docs, (cnt, ext), index.doc_lengths.size, doc_shards,
                      Ls, (cnt_row, ext_row))
    return cnt_row, ext_row, True


def pack_qt1_batch(
    index: ProximityIndex,
    queries: list[list[int]],
    L: int,
    K: int = 2,
    doc_shards: int = 1,
    cache=None,
    plans: list | None = None,
) -> QT1Batch:
    """Pack QT1 queries into fixed-shape host arrays.

    Per-key row derivation lives in :func:`pack_fst_key_rows`; with
    `cache` (a ``repro_torch.serving.pack_cache.PackedPostingCache``) the
    rows of hot keys are served from memory instead of being re-derived
    from segment reads — packing becomes B*K row copies.

    An empty query is a batch-shape padding slot: its rows stay
    all-SENTINEL and its idf_sum is 0, so it scores NEG_INF everywhere
    and decodes to zero results."""
    B = len(queries)
    lex = index.lexicon
    stride = qt1_stride(index)
    assert L % doc_shards == 0

    key_g = np.full((B, K, L), SENTINEL, np.int32)
    key_lo = np.full((B, K, L), SENTINEL, np.int32)
    key_hi = np.full((B, K, L), SENTINEL, np.int32)
    idf_sum = np.zeros(B, np.float32)
    span_adj = np.zeros(B, np.float32)

    for qi, q in enumerate(queries):
        if not q:
            continue  # padding slot
        keys = plans[qi] if plans is not None and plans[qi] is not None \
            else select_fst_keys(q)[1]
        keys = (keys + [keys[-1]] * K)[:K]  # pad by repeating (idempotent join)
        span_adj[qi] = len(q) - 1
        any_present = False
        for ki, key in enumerate(keys):
            if cache is not None:
                g_row, lo_row, hi_row, present = cache.get_rows(
                    index, key, L, doc_shards, stride
                )
                if present:
                    key_g[qi, ki] = g_row
                    key_lo[qi, ki] = lo_row
                    key_hi[qi, ki] = hi_row
            else:  # write postings straight into the batch arrays
                _, _, _, present = pack_fst_key_rows(
                    index, key, L, doc_shards, stride,
                    out=(key_g[qi, ki], key_lo[qi, ki], key_hi[qi, ki]),
                )
            any_present = any_present or present
        if any_present:
            idf_sum[qi] = sum(lex.idf(l) for l in q)
    return QT1Batch(key_g, key_lo, key_hi, idf_sum, span_adj, stride)


# --------------------------------------------------------------------------
# QT2/QT5 host-side batch packing
# --------------------------------------------------------------------------
@dataclass
class QT2Batch:
    wv_lo: np.ndarray  # (B, K, L) int32, sorted by lo, SENTINEL-padded
    wv_hi: np.ndarray
    n_keys: np.ndarray  # (B,) int32; lists k >= n_keys[b] are padding
    idf_sum: np.ndarray
    span_adjust: np.ndarray
    stride: int

    def device_args(self, device):
        return _to_device((self.wv_lo, self.wv_hi, self.n_keys, self.idf_sum,
                           self.span_adjust), device)


@dataclass
class QT5Batch:
    a_g: np.ndarray  # (B, L) anchor ordinary posting row
    ns_g: np.ndarray  # (B, Kn, L) other non-stop rows
    ns_r: np.ndarray  # (B, Kn) multiplicities (0 = padding)
    st_cnt: np.ndarray  # (B, Ks, L) NSW neighbor counts (anchor-aligned)
    st_ext: np.ndarray  # (B, Ks, L) nearest NSW offsets
    st_r: np.ndarray  # (B, Ks) stop multiplicities (0 = padding)
    idf_sum: np.ndarray
    span_adjust: np.ndarray
    stride: int

    def device_args(self, device):
        return _to_device((self.a_g, self.ns_g, self.ns_r, self.st_cnt,
                           self.st_ext, self.st_r, self.idf_sum,
                           self.span_adjust), device)


@dataclass
class QT34Batch:
    a_g: np.ndarray  # (B, L) anchor ordinary posting row
    ns_g: np.ndarray  # (B, Kn, L) other ordinary rows
    ns_r: np.ndarray  # (B, Kn) multiplicities (0 = padding)
    idf_sum: np.ndarray
    span_adjust: np.ndarray
    stride: int

    def device_args(self, device):
        return _to_device((self.a_g, self.ns_g, self.ns_r, self.idf_sum,
                           self.span_adjust), device)


def pack_qt2_batch(
    index,
    queries: list[list[int]],
    L: int,
    K: int = 3,
    doc_shards: int = 1,
    cache=None,
    plans: list | None = None,
) -> QT2Batch:
    """Pack QT2 queries into fixed-shape (w,v)-interval host arrays.

    Per-key row derivation lives in :func:`pack_wv_key_rows`; with
    ``cache`` hot-key rows come from the serving row cache (kind "wv").
    Empty queries are batch-padding slots."""
    B = len(queries)
    lex = index.lexicon
    stride = qt1_stride(index)
    assert L % doc_shards == 0
    wv_lo = np.full((B, K, L), SENTINEL, np.int32)
    wv_hi = np.full((B, K, L), SENTINEL, np.int32)
    n_keys = np.zeros(B, np.int32)
    idf_sum = np.zeros(B, np.float32)
    span_adj = np.zeros(B, np.float32)
    for qi, q in enumerate(queries):
        if not q:
            continue  # padding slot
        keys = (plans[qi] if plans is not None and plans[qi] is not None
                else qt2_plan(index, q)[0])[:K]
        n_keys[qi] = len(keys)
        span_adj[qi] = len(q) - 1
        any_present = False
        for ki, key in enumerate(keys):
            if cache is not None:
                lo_row, hi_row, present = cache.get(index, "wv", key, L,
                                                    doc_shards, stride)
                if present:
                    wv_lo[qi, ki] = lo_row
                    wv_hi[qi, ki] = hi_row
            else:
                _, _, present = pack_wv_key_rows(
                    index, key, L, doc_shards, stride,
                    out=(wv_lo[qi, ki], wv_hi[qi, ki]),
                )
            any_present = any_present or present
        if any_present:
            idf_sum[qi] = sum(lex.idf(l) for l in q)
    return QT2Batch(wv_lo, wv_hi, n_keys, idf_sum, span_adj, stride)


def pack_qt5_batch(
    index,
    queries: list[list[int]],
    L: int,
    Kn: int = 3,
    Ks: int = 3,
    doc_shards: int = 1,
    cache=None,
    plans: list | None = None,
) -> QT5Batch:
    """Pack QT5 queries: anchor + other non-stop ordinary rows (kind
    "ord") and per-(anchor, stop-lemma) NSW aggregate rows (kind "nsw").
    The serving router guarantees the per-query constraint counts fit
    (Kn, Ks) and multiplicities fit the step's r_max; longer queries take
    the scalar fallback."""
    B = len(queries)
    lex = index.lexicon
    stride = qt1_stride(index)
    assert L % doc_shards == 0
    a_g = np.full((B, L), SENTINEL, np.int32)
    ns_g = np.full((B, Kn, L), SENTINEL, np.int32)
    ns_r = np.zeros((B, Kn), np.int32)
    st_cnt = np.zeros((B, Ks, L), np.int32)
    st_ext = np.zeros((B, Ks, L), np.int32)
    st_r = np.zeros((B, Ks), np.int32)
    idf_sum = np.zeros(B, np.float32)
    span_adj = np.zeros(B, np.float32)
    for qi, q in enumerate(queries):
        if not q:
            continue  # padding slot
        plan = (plans[qi] if plans is not None and plans[qi] is not None
                else qt5_plan(index, q))
        if plan is None:
            continue  # degenerate; the router sends these to the scalar engine
        anchor, others, stops, _ = plan
        span_adj[qi] = len(q) - 1
        if cache is not None:
            g_row, present = cache.get(index, "ord", anchor, L, doc_shards, stride)
            if present:
                a_g[qi] = g_row
        else:
            pack_ord_key_rows(index, anchor, L, doc_shards, stride, out=(a_g[qi],))
        for ki, (lemma, r) in enumerate(others[:Kn]):
            ns_r[qi, ki] = r
            if cache is not None:
                g_row, pres = cache.get(index, "ord", lemma, L, doc_shards, stride)
                if pres:
                    ns_g[qi, ki] = g_row
            else:
                pack_ord_key_rows(index, lemma, L, doc_shards, stride,
                                  out=(ns_g[qi, ki],))
        for ki, (sid, r) in enumerate(stops[:Ks]):
            st_r[qi, ki] = r
            if cache is not None:
                cnt_row, ext_row, pres = cache.get(index, "nsw", (anchor, sid),
                                                   L, doc_shards, stride)
                if pres:
                    st_cnt[qi, ki] = cnt_row
                    st_ext[qi, ki] = ext_row
            else:
                pack_nsw_key_rows(index, (anchor, sid), L, doc_shards, stride,
                                  out=(st_cnt[qi, ki], st_ext[qi, ki]))
        idf_sum[qi] = sum(lex.idf(l) for l in q)
    return QT5Batch(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, idf_sum, span_adj, stride)


def pack_qt34_batch(
    index,
    queries: list[list[int]],
    L: int,
    Kn: int = 4,
    doc_shards: int = 1,
    cache=None,
    plans: list | None = None,
) -> QT34Batch:
    """Pack QT3/QT4 queries: anchor (most frequent lemma) + other
    ordinary rows, all kind "ord" — the same per-key rows the QT5
    packer's non-stop streams use, so a warm row cache is shared across
    both paths. The serving router guarantees the per-query constraint
    count fits Kn and multiplicities fit the step's r_max; anything else
    takes the scalar fallback."""
    B = len(queries)
    lex = index.lexicon
    stride = qt1_stride(index)
    assert L % doc_shards == 0
    a_g = np.full((B, L), SENTINEL, np.int32)
    ns_g = np.full((B, Kn, L), SENTINEL, np.int32)
    ns_r = np.zeros((B, Kn), np.int32)
    idf_sum = np.zeros(B, np.float32)
    span_adj = np.zeros(B, np.float32)
    for qi, q in enumerate(queries):
        if not q:
            continue  # padding slot
        plan = (plans[qi] if plans is not None and plans[qi] is not None
                else qt34_plan(index, q))
        anchor, others, _ = plan
        span_adj[qi] = len(q) - 1
        if cache is not None:
            g_row, present = cache.get(index, "ord", anchor, L, doc_shards, stride)
            if present:
                a_g[qi] = g_row
        else:
            pack_ord_key_rows(index, anchor, L, doc_shards, stride, out=(a_g[qi],))
        for ki, (lemma, r) in enumerate(others[:Kn]):
            ns_r[qi, ki] = r
            if lemma == anchor:
                # the anchor's own multiplicity constraint re-windows its row
                ns_g[qi, ki] = a_g[qi]
                continue
            if cache is not None:
                g_row, pres = cache.get(index, "ord", lemma, L, doc_shards, stride)
                if pres:
                    ns_g[qi, ki] = g_row
            else:
                pack_ord_key_rows(index, lemma, L, doc_shards, stride,
                                  out=(ns_g[qi, ki],))
        idf_sum[qi] = sum(lex.idf(l) for l in q)
    return QT34Batch(a_g, ns_g, ns_r, idf_sum, span_adj, stride)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def decode_results(batch, top_s, top_g, top_lo, top_hi):
    """Device top-k -> per-query (doc, start, end, score) numpy records.

    The four (B, k) result matrices are tiny (k = top_k), so they move
    to the host wholesale in four copies and every filter/divmod runs
    in numpy."""
    s = _host(top_s)
    valid = s > -1e29
    B = s.shape[0]
    z = np.zeros(0, np.int64)
    out = [
        {"doc": z, "start": z, "end": z, "score": np.zeros(0, s.dtype)}
        for _ in range(B)
    ]
    rows = np.flatnonzero(valid.any(axis=1))
    if rows.size == 0:
        return out
    g = _host(top_g).astype(np.int64)[rows]
    lo = _host(top_lo).astype(np.int64)[rows]
    hi = _host(top_hi).astype(np.int64)[rows]
    vm = valid[rows]
    doc = g[vm] // batch.stride
    start = lo[vm] % batch.stride
    end = hi[vm] % batch.stride
    score = s[rows][vm]
    splits = np.cumsum(vm.sum(axis=1))[:-1]
    for qi, d, st, en, sc in zip(
        rows.tolist(),
        np.split(doc, splits),
        np.split(start, splits),
        np.split(end, splits),
        np.split(score, splits),
    ):
        out[qi] = {"doc": d, "start": st, "end": en, "score": sc}
    return out
