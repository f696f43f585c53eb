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
  (``kernels.nearest_r.window_join``);
* three payload formats: raw int32 rows, block-delta16 anchor streams
  (one int32 base per 64 postings + uint16 in-block deltas, uint8 side
  channels) and offsets (int32 streams + uint8 side channels, the
  fallback when a block's span overflows uint16). Compressed payloads are
  encoded on the host (``compress_*``, ``assemble_*_compressed``, numpy
  arrays) and decoded elementwise in torch ops before the same joins.

The index is range-partitioned by document over a mesh's ``model`` axis
(each of S shards holds a contiguous doc range of every posting row, in a
segment of L/S slots), and queries are split over its ``pod``/``data``
axes. Each serve-step factory takes ``mesh=None``: with no mesh or a
(1, 1) mesh it returns the single-shard step, which runs on the device
its arguments lie on. With a (D, S) mesh it returns a
:class:`ShardedStep`: each shard joins its own segment on its own device
(the QT3-QT5 window join is launched once per shard), takes its local
top-k, and the S top-k lists of a data row are copied onto the row's
lead device in model-axis order — what ``all_gather(..., tiled=True)``
concatenates — and reduced by a second top-k. One process drives every
device of the mesh; there is no process group.
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
    if k > score.shape[1]:
        # lax.top_k refuses k larger than the row; a sort would quietly
        # return fewer columns
        raise ValueError(f"top_k={k} is larger than the {score.shape[1]} "
                         "lanes of a shard's row")
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
BLK = 64  # delta-coding block: one int32 base per BLK postings


def _widen_u16(x: torch.Tensor) -> torch.Tensor:
    """uint16 deltas, or their int16 bits, as int32 values in [0, 65535].
    The bits are read as int16 first: torch has no arithmetic on uint16,
    and which of its conversions support uint16 differs between versions
    and devices."""
    if x.dtype == torch.uint16:
        x = x.view(torch.int16)
    return x.to(torch.int32) & 0xFFFF


def _delta_decode(base: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """(…, L/BLK) int32 bases + (…, L) uint16 deltas -> (…, L) int32 keys,
    each base repeated over its block as ``jnp.repeat`` does."""
    rep = base.unsqueeze(-1).expand(*base.shape, BLK).reshape(delta.shape)
    return rep + _widen_u16(delta)


# argument specs of the sharded steps, as the reference's PartitionSpecs:
# every argument's batch axis is split over the mesh's pod/data axes, and
# the posting-length (last) axis of ROW and AROW arguments over model
ROW = "row"    # (B, K, L) posting rows, (B, K, L/64) delta bases
AROW = "arow"  # (B, L) anchor rows, (B, L/64) anchor bases
KVEC = "kvec"  # (B, K) per-key scalars, replicated over model
VEC = "vec"    # (B,) per-query scalars
REP = "rep"    # qt1's offsets-only dummy (B, K, 1) base, replicated
_SPLIT_L = (ROW, AROW)


def _shard(a, spec: str, d: int, m: int, Bd: int, S: int) -> torch.Tensor:
    """Shard (d, m)'s block of one host argument (numpy array or tensor):
    rows ``[d*Bd, (d+1)*Bd)``, and for split specs the m-th of S equal
    slices of the last axis."""
    piece = a[d * Bd:(d + 1) * Bd]
    if spec in _SPLIT_L:
        n = a.shape[-1]
        if n % S:
            raise ValueError(f"the last axis ({n}) of a {spec} argument does "
                             f"not split over {S} model shards")
        w = n // S
        piece = piece[..., m * w:(m + 1) * w]
    if isinstance(piece, torch.Tensor):
        return piece.contiguous()
    return torch.from_numpy(np.ascontiguousarray(piece))


class ShardedStep:
    """A serve step over a (D, S) device mesh, the port of the
    reference's ``shard_map`` step: ``local`` is the single-shard step
    (join, score, local top-k), ``specs`` its arguments' split specs.

    :meth:`place` copies each shard's block of the host arguments
    straight to that shard's device; :meth:`run` runs ``local`` on every
    shard, copies the S ``(B/D, top_k)`` results of each data row onto
    the row's lead device in model-axis order, reduces them with a
    second :func:`qt1_topk`, and returns the four ``(B, top_k)`` outputs
    on the mesh's first device. Calling the step does both."""

    def __init__(self, local, specs: tuple, mesh, top_k: int):
        self.local = local
        self.specs = tuple(specs)
        self.grid = mesh.grid()
        self.top_k = top_k

    @property
    def lead(self) -> torch.device:
        return self.grid[0, 0]

    def place(self, args) -> list:
        """Host arguments -> ``[d][m]`` tuples of tensors on device
        ``grid[d, m]``. Raises ValueError when D does not divide the
        batch or S a split axis, as ``shard_map`` refuses them."""
        if len(args) != len(self.specs):
            raise TypeError(f"the step takes {len(self.specs)} arguments, "
                            f"got {len(args)}")
        D, S = self.grid.shape
        B = args[0].shape[0]
        if B % D:
            raise ValueError(f"a batch of {B} does not split over {D} data shards")
        Bd = B // D
        return [[tuple(_shard(a, spec, d, m, Bd, S).to(self.grid[d, m])
                       for a, spec in zip(args, self.specs))
                 for m in range(S)]
                for d in range(D)]

    def run(self, placed) -> tuple:
        rows = []
        for d, shards in enumerate(placed):
            lead = self.grid[d, 0]
            parts = [self.local(*args) for args in shards]
            gathered = [torch.cat([p[i].to(lead) for p in parts], dim=1)
                        for i in range(4)]
            rows.append(qt1_topk(*gathered, self.top_k))
        if len(rows) == 1:
            return rows[0]
        return tuple(torch.cat([r[i].to(self.lead) for r in rows], dim=0)
                     for i in range(4))

    def __call__(self, *args) -> tuple:
        return self.run(self.place(args))


class LocalStep:
    """The single-shard step on a one-device mesh, with the
    :class:`ShardedStep` interface: :meth:`place` copies the host
    arguments whole to the device, :meth:`run` calls the step on them.
    Calling it calls the step."""

    def __init__(self, step, device):
        self.step = step
        self.device = device

    def place(self, args) -> tuple:
        return to_device(args, self.device)

    def run(self, placed) -> tuple:
        return self.step(*placed)

    def __call__(self, *args) -> tuple:
        return self.step(*args)


def _over(mesh, step, specs: tuple, top_k: int):
    """``step`` itself without a mesh (the single-shard path), its
    :class:`LocalStep` on a one-device mesh, else its
    :class:`ShardedStep`."""
    if mesh is None:
        return step
    if mesh.size == 1:
        return LocalStep(step, mesh.devices.flat[0])
    return ShardedStep(step, specs, mesh, top_k)


def make_qt1_serve_step(top_k: int = 16, mesh=None):
    """The QT1 serve step:
    ``step(key_g, key_lo, key_hi, idf_sum, span_adjust) -> (s, g, lo, hi)``,
    each (B, top_k); sharded over ``mesh`` when it has more than one
    device (module docstring)."""

    def step(key_g, key_lo, key_hi, idf_sum, span_adjust):
        valid, lo, hi = qt1_join(key_g, key_lo, key_hi)
        score = qt1_score(valid, lo, hi, idf_sum, span_adjust)
        return qt1_topk(score, key_g[:, 0], lo, hi, top_k)

    return _over(mesh, step, (ROW, ROW, ROW, VEC, VEC), top_k)


def make_qt1_serve_step_compressed(top_k: int = 16, delta_g: bool = True,
                                   mesh=None):
    """The QT1 serve step over a compressed payload:
    ``step(key_base, key_delta, key_lo_off, key_hi_off, idf_sum,
    span_adjust) -> (s, g, lo, hi)``.

    * fragment bounds ride as uint8 offsets from the anchor (|off| <=
      MaxDistance <= 254; ``lo_off == 255`` marks padding);
    * with ``delta_g`` the keys are block-delta16 coded ((B, K, L/64)
      int32 bases, (B, K, L) uint16 deltas); without it ``key_delta`` is
      the raw int32 g row and ``key_base`` a dummy (B, K, 1), which a
      mesh replicates rather than splits.

    Bytes per posting: 12 (raw) -> 6 (offsets) -> 4 (offsets + delta16).
    The bounds are taken before the pads are set to SENTINEL, so a pad
    lane keeps ``lo = key_g - 255`` and ``hi = key_g``, as in the
    reference (top-k sees those lanes)."""

    def step(key_base, key_delta, key_lo_off, key_hi_off, idf_sum, span_adjust):
        key_g = _delta_decode(key_base, key_delta) if delta_g else key_delta
        lo = key_g - key_lo_off.to(torch.int32)
        hi = key_g + key_hi_off.to(torch.int32)
        key_g = torch.where(key_lo_off == 255, SENTINEL, key_g)
        valid, lo, hi = qt1_join(key_g, lo, hi)
        score = qt1_score(valid, lo, hi, idf_sum, span_adjust)
        return qt1_topk(score, key_g[:, 0], lo, hi, top_k)

    specs = (ROW if delta_g else REP, ROW, ROW, ROW, VEC, VEC)
    return _over(mesh, step, specs, top_k)


def make_wv_serve_step(qtype: str, top_k: int = 16, payload: str = "raw",
                       max_distance: int = 5, r_max: int = 4, mesh=None):
    """The QT2/QT3/QT4/QT5 serve step — the (w,v)-key / ordinary-window
    / NSW analogue of :func:`make_qt1_serve_step` (DESIGN.md §12-§13),
    sharded over ``mesh`` when it has more than one device. ``"qt34"``
    serves both QT3 and QT4: their evaluation is identical, only the
    lemma classes differ. Arguments, by ``payload``:

    * ``"raw"`` — the ``device_args`` of the matching batch: qt2
      ``(wv_lo, wv_hi, n_keys, idf_sum, span_adjust)``, qt34 ``(a_g,
      ns_g, ns_r, idf_sum, span_adjust)``, qt5 ``(a_g, ns_g, ns_r,
      st_cnt, st_ext, st_r, idf_sum, span_adjust)``;
    * ``"delta"`` — block-delta16 anchor streams (4 B/posting class):
      qt2 ``(base, delta, width, n_keys, …)``, qt34 ``(a_base, a_delta,
      a_pad, ns_base, ns_delta, ns_pad, ns_r, …)``, qt5 the same plus
      ``(st_cnt, st_eneg, st_epos, st_r)`` after ``ns_r``;
    * ``"offsets"`` — int32 streams with uint8 side channels, the
      fallback when a 64-posting block's span overflows uint16: qt2
      ``(lo, width, n_keys, …)``, qt5 ``(a_g, ns_g, ns_r, st_cnt,
      st_eneg, st_epos, st_r, …)``; qt34's payload is g rows only, so it
      equals ``"raw"``.

    These are the tuples of ``compress_*_batch`` and
    ``assemble_*_compressed``. The decode is elementwise; the joins do
    not depend on the payload."""
    assert qtype in ("qt2", "qt34", "qt5")
    assert payload in ("raw", "delta", "offsets")
    step, specs = _wv_step(qtype, top_k, payload, max_distance, r_max)
    return _over(mesh, step, specs, top_k)


def _wv_step(qtype, top_k, payload, max_distance, r_max):
    """(single-shard step, argument specs) of :func:`make_wv_serve_step`."""

    def finish(score, lo, hi):
        # the CPU engine derives the doc from lo, so lo doubles as g
        return qt1_topk(score, lo, lo, hi, top_k)

    if qtype == "qt2":
        sep = 2 * max_distance

        def join_finish(wv_lo, wv_hi, n_keys, idf_sum, span_adjust):
            valid, lo, hi = qt2_join(wv_lo, wv_hi, n_keys, sep)
            return finish(qt1_score(valid, lo, hi, idf_sum, span_adjust), lo, hi)

        def widths(lo, width):
            # a pad lane's lo + 255 wraps in int32 before where() drops it
            pad = width == 255
            hi = torch.where(pad, SENTINEL, lo + width.to(torch.int32))
            return torch.where(pad, SENTINEL, lo), hi

        if payload == "raw":
            return join_finish, (ROW, ROW, VEC, VEC, VEC)
        if payload == "delta":
            def step(base, delta, width, n_keys, idf_sum, span_adjust):
                lo, hi = widths(_delta_decode(base, delta), width)
                return join_finish(lo, hi, n_keys, idf_sum, span_adjust)
            return step, (ROW, ROW, ROW, VEC, VEC, VEC)

        def step(lo, width, n_keys, idf_sum, span_adjust):
            lo, hi = widths(lo, width)
            return join_finish(lo, hi, n_keys, idf_sum, span_adjust)
        return step, (ROW, ROW, VEC, VEC, VEC)

    def ord_rows(a_base, a_delta, a_pad, ns_base, ns_delta, ns_pad):
        a_g = torch.where(a_pad == 1, SENTINEL, _delta_decode(a_base, a_delta))
        ns_g = torch.where(ns_pad == 1, SENTINEL, _delta_decode(ns_base, ns_delta))
        return a_g, ns_g

    ord_delta = (AROW, AROW, AROW, ROW, ROW, ROW, KVEC)
    if qtype == "qt34":
        def join_finish(a_g, ns_g, ns_r, idf_sum, span_adjust):
            valid, lo, hi = qt34_join(a_g, ns_g, ns_r, max_distance, r_max)
            return finish(qt1_score(valid, lo, hi, idf_sum, span_adjust), lo, hi)

        if payload in ("raw", "offsets"):
            return join_finish, (AROW, ROW, KVEC, VEC, VEC)

        def step(a_base, a_delta, a_pad, ns_base, ns_delta, ns_pad, ns_r,
                 idf_sum, span_adjust):
            a_g, ns_g = ord_rows(a_base, a_delta, a_pad, ns_base, ns_delta, ns_pad)
            return join_finish(a_g, ns_g, ns_r, idf_sum, span_adjust)
        return step, ord_delta + (VEC, VEC)

    def join_finish(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, idf_sum, span_adjust):
        valid, lo, hi = qt5_join(a_g, ns_g, ns_r, st_cnt, st_ext, st_r,
                                 max_distance, r_max)
        return finish(qt1_score(valid, lo, hi, idf_sum, span_adjust), lo, hi)

    def nsw(st_cnt, st_eneg, st_epos):
        # uint8 count and split-sign nearest offset -> int32 (cnt, ext)
        return st_cnt.to(torch.int32), st_epos.to(torch.int32) - st_eneg.to(torch.int32)

    if payload == "raw":
        return join_finish, (AROW, ROW, KVEC, ROW, ROW, KVEC, VEC, VEC)
    if payload == "delta":
        def step(a_base, a_delta, a_pad, ns_base, ns_delta, ns_pad, ns_r,
                 st_cnt, st_eneg, st_epos, st_r, idf_sum, span_adjust):
            a_g, ns_g = ord_rows(a_base, a_delta, a_pad, ns_base, ns_delta, ns_pad)
            return join_finish(a_g, ns_g, ns_r, *nsw(st_cnt, st_eneg, st_epos),
                               st_r, idf_sum, span_adjust)
        return step, ord_delta + (ROW, ROW, ROW, KVEC, VEC, VEC)

    def step(a_g, ns_g, ns_r, st_cnt, st_eneg, st_epos, st_r, idf_sum,
             span_adjust):
        return join_finish(a_g, ns_g, ns_r, *nsw(st_cnt, st_eneg, st_epos),
                           st_r, idf_sum, span_adjust)
    return step, (AROW, ROW, KVEC, ROW, ROW, ROW, KVEC, VEC, VEC)


# --------------------------------------------------------------------------
# host-side batch packing from a ProximityIndex
# --------------------------------------------------------------------------
def to_device(arrays, device) -> tuple:
    """Host arrays (a batch's raw or compressed step args) as tensors on
    ``device``: the batch's host-to-device copy."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


@dataclass
class QT1Batch:
    key_g: np.ndarray  # (B, K, L) int32
    key_lo: np.ndarray
    key_hi: np.ndarray
    idf_sum: np.ndarray  # (B,) f32
    span_adjust: np.ndarray  # (B,) f32 == len(query) - 1
    stride: int

    def host_args(self) -> tuple:
        return (self.key_g, self.key_lo, self.key_hi, self.idf_sum,
                self.span_adjust)

    def device_args(self, device):
        return to_device(self.host_args(), device)


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

    def host_args(self) -> tuple:
        return (self.wv_lo, self.wv_hi, self.n_keys, self.idf_sum,
                self.span_adjust)

    def device_args(self, device):
        return to_device(self.host_args(), device)


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

    def host_args(self) -> tuple:
        return (self.a_g, self.ns_g, self.ns_r, self.st_cnt, self.st_ext,
                self.st_r, self.idf_sum, self.span_adjust)

    def device_args(self, device):
        return to_device(self.host_args(), device)


@dataclass
class QT34Batch:
    a_g: np.ndarray  # (B, L) anchor ordinary posting row
    ns_g: np.ndarray  # (B, Kn, L) other ordinary rows
    ns_r: np.ndarray  # (B, Kn) multiplicities (0 = padding)
    idf_sum: np.ndarray
    span_adjust: np.ndarray
    stride: int

    def host_args(self) -> tuple:
        return (self.a_g, self.ns_g, self.ns_r, self.idf_sum, self.span_adjust)

    def device_args(self, device):
        return to_device(self.host_args(), device)


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


# --------------------------------------------------------------------------
# compressed payload encoding (host side; numpy arrays, moved to the
# device by the caller)
# --------------------------------------------------------------------------
def _delta16_blocks(g):
    """Block-delta16 code an int64 key stream (…, L) with SENTINEL pads:
    one int32 base per 64-posting block + uint16 in-block deltas. The
    base is the min over *live* postings, not element 0: with doc_shards
    > 1 a block can straddle a shard-segment boundary and start with
    padding while holding live keys later — anchoring on the min keeps
    every delta non-negative (and minimal). Returns (base, delta, ok);
    ok False when any in-block span overflows uint16."""
    L = g.shape[-1]
    nb = L // BLK
    gb = g.reshape(g.shape[:-1] + (nb, BLK))
    is_pad = gb == np.int64(SENTINEL)
    live_min = np.where(is_pad, np.int64(SENTINEL), gb).min(axis=-1)
    base = np.where(live_min == np.int64(SENTINEL), 0, live_min)
    delta = np.where(is_pad, 0, gb - base[..., None])
    if delta.max(initial=0) >= 2**16:
        return None, None, False
    return (
        base.astype(np.int32),
        delta.reshape(g.shape[:-1] + (L,)).astype(np.uint16),
        True,
    )


def compress_qt1_batch(batch: "QT1Batch", delta_g: bool = True):
    """Pack a QT1Batch into the compressed format (the args of
    make_qt1_serve_step_compressed, as numpy arrays). Raises if a 64-posting block's key
    span exceeds uint16 (the serving packer then falls back to the
    offsets-only format for that bucket)."""
    g = batch.key_g.astype(np.int64)
    B, K, L = g.shape
    # pads are marked by lo_off == 255 in the compressed format
    lo_off = np.where(batch.key_lo == SENTINEL, 255,
                      np.clip(g - batch.key_lo, 0, 254))
    hi_off = np.where(batch.key_hi == SENTINEL, 0,
                      np.clip(batch.key_hi - g, 0, 254))
    if not delta_g:
        return (np.zeros((B, K, 1), np.int32), batch.key_g,
                lo_off.astype(np.uint8), hi_off.astype(np.uint8),
                batch.idf_sum, batch.span_adjust)
    assert L % BLK == 0
    base, delta, ok = _delta16_blocks(g)
    if not ok:
        raise ValueError("in-block key span exceeds uint16; use offsets format")
    return (base, delta, lo_off.astype(np.uint8), hi_off.astype(np.uint8),
            batch.idf_sum, batch.span_adjust)


def compress_qt2_batch(batch: QT2Batch, delta_g: bool = True):
    """QT2Batch -> compressed step args. Interval widths (hi - lo <=
    MaxDistance <= 254) ride as uint8 (255 marks padding); with delta_g
    the lo stream is block-delta16 coded. Raises on uint16 overflow (the
    engine then falls back to the offsets format)."""
    lo = batch.wv_lo.astype(np.int64)
    pad = lo == np.int64(SENTINEL)
    width = np.where(pad, 255,
                     np.clip(batch.wv_hi.astype(np.int64) - lo, 0, 254)).astype(np.uint8)
    tail = (width, batch.n_keys, batch.idf_sum, batch.span_adjust)
    if not delta_g:
        return (batch.wv_lo,) + tail
    assert lo.shape[-1] % BLK == 0
    base, delta, ok = _delta16_blocks(lo)
    if not ok:
        raise ValueError("in-block key span exceeds uint16; use offsets format")
    return (base, delta) + tail


def compress_qt34_batch(batch: QT34Batch, delta_g: bool = True):
    """QT34Batch -> compressed step args: with delta_g the anchor and
    other ordinary streams are block-delta16 coded behind uint8 pad
    masks (4 B/posting class); without it the int32 rows ship as-is
    (the "offsets" format — QT3/QT4 has no uint8 side channels, so the
    fallback is simply uncompressed). Raises on uint16 overflow (the
    engine then falls back to the offsets format)."""
    tail = (batch.ns_r, batch.idf_sum, batch.span_adjust)
    if not delta_g:
        return (batch.a_g, batch.ns_g) + tail
    a = batch.a_g.astype(np.int64)
    ns = batch.ns_g.astype(np.int64)
    assert a.shape[-1] % BLK == 0
    a_base, a_delta, ok_a = _delta16_blocks(a)
    ns_base, ns_delta, ok_n = _delta16_blocks(ns)
    if not (ok_a and ok_n):
        raise ValueError("in-block key span exceeds uint16; use offsets format")
    a_pad = (a == np.int64(SENTINEL)).astype(np.uint8)
    ns_pad = (ns == np.int64(SENTINEL)).astype(np.uint8)
    return (a_base, a_delta, a_pad, ns_base, ns_delta, ns_pad) + tail


def compress_qt5_batch(batch: QT5Batch, delta_g: bool = True):
    """QT5Batch -> compressed step args: uint8 NSW counts (clipped at
    255 — multiplicities are far smaller) and split-sign uint8 nearest
    offsets (|ext| <= MaxDistance <= 254); with delta_g the anchor and
    non-stop streams are block-delta16 coded behind uint8 pad masks."""
    cnt8 = np.clip(batch.st_cnt, 0, 255).astype(np.uint8)
    eneg = np.clip(-np.minimum(batch.st_ext, 0), 0, 255).astype(np.uint8)
    epos = np.clip(np.maximum(batch.st_ext, 0), 0, 255).astype(np.uint8)
    tail = (batch.ns_r, cnt8, eneg, epos, batch.st_r, batch.idf_sum,
            batch.span_adjust)
    if not delta_g:
        return (batch.a_g, batch.ns_g) + tail
    a = batch.a_g.astype(np.int64)
    ns = batch.ns_g.astype(np.int64)
    assert a.shape[-1] % BLK == 0
    a_base, a_delta, ok_a = _delta16_blocks(a)
    ns_base, ns_delta, ok_n = _delta16_blocks(ns)
    if not (ok_a and ok_n):
        raise ValueError("in-block key span exceeds uint16; use offsets format")
    a_pad = (a == np.int64(SENTINEL)).astype(np.uint8)
    ns_pad = (ns == np.int64(SENTINEL)).astype(np.uint8)
    return (a_base, a_delta, a_pad, ns_base, ns_delta, ns_pad) + tail


# --------------------------------------------------------------------------
# per-key compressed rows (the compressed-row cache's unit, DESIGN.md §12)
# --------------------------------------------------------------------------
def compress_fst_rows(rows):
    """(g, lo, hi, present) -> (base, delta16, lo_off, hi_off, delta_ok,
    present). base/delta are None when the key's in-block span overflows
    uint16 — the batch assembler then falls back to the offsets format,
    which reuses lo_off/hi_off with the raw g row."""
    g, lo, hi, present = rows
    g64 = g.astype(np.int64)
    lo_off = np.where(lo == SENTINEL, 255, np.clip(g64 - lo, 0, 254)).astype(np.uint8)
    hi_off = np.where(hi == SENTINEL, 0, np.clip(hi - g64, 0, 254)).astype(np.uint8)
    if g64.shape[-1] % BLK:
        return (None, None, lo_off, hi_off, False, present)
    base, delta, ok = _delta16_blocks(g64)
    return (base, delta, lo_off, hi_off, ok, present)


def compress_wv_rows(rows):
    """(lo, hi, present) -> (base, delta16, width, delta_ok, present)."""
    lo, hi, present = rows
    lo64 = lo.astype(np.int64)
    pad = lo64 == np.int64(SENTINEL)
    width = np.where(pad, 255, np.clip(hi.astype(np.int64) - lo64, 0, 254)).astype(np.uint8)
    if lo64.shape[-1] % BLK:
        return (None, None, width, False, present)
    base, delta, ok = _delta16_blocks(lo64)
    return (base, delta, width, ok, present)


def compress_ord_rows(rows):
    """(g, present) -> (base, delta16, pad, delta_ok, present)."""
    g, present = rows
    g64 = g.astype(np.int64)
    pad = (g64 == np.int64(SENTINEL)).astype(np.uint8)
    if g64.shape[-1] % BLK:
        return (None, None, pad, False, present)
    base, delta, ok = _delta16_blocks(g64)
    return (base, delta, pad, ok, present)


def compress_nsw_rows(rows):
    """(cnt, ext, present) -> (cnt8, ext_neg, ext_pos, True, present)."""
    cnt, ext, present = rows
    cnt8 = np.clip(cnt, 0, 255).astype(np.uint8)
    eneg = np.clip(-np.minimum(ext, 0), 0, 255).astype(np.uint8)
    epos = np.clip(np.maximum(ext, 0), 0, 255).astype(np.uint8)
    return (cnt8, eneg, epos, True, present)


# --------------------------------------------------------------------------
# compressed batch assembly from per-key cached rows
# --------------------------------------------------------------------------
def assemble_qt1_compressed(index, queries, L, K=2, doc_shards=1,
                            ccache=None, cache=None, plans=None):
    """Build compressed QT1 step args (numpy) from per-key *cached* compressed
    rows: warm drains become B*K row copies instead of an O(B·K·L) host
    re-encode. Returns (kind, args, batch_stub) with kind "delta" or
    "offsets" (chosen per batch: offsets when any key's in-block span
    overflows uint16 or the bucket is block/shard-misaligned)."""
    B = len(queries)
    stride = qt1_stride(index)
    lex = index.lexicon
    delta_fmt = L % (BLK * doc_shards) == 0
    lo_off = np.full((B, K, L), 255, np.uint8)
    hi_off = np.zeros((B, K, L), np.uint8)
    idf_sum = np.zeros(B, np.float32)
    span_adj = np.zeros(B, np.float32)
    ents: list = [None] * B
    for qi, q in enumerate(queries):
        if not q:
            continue
        keys = plans[qi] if plans is not None and plans[qi] is not None \
            else select_fst_keys(list(q))[1]
        keys = (keys + [keys[-1]] * K)[:K]
        span_adj[qi] = len(q) - 1
        row_ents = []
        any_present = False
        for ki, key in enumerate(keys):
            base, delta, lo_o, hi_o, ok, present = ccache.get(
                index, "fst_c", key, L, doc_shards, stride)
            delta_fmt &= ok
            if present:
                lo_off[qi, ki] = lo_o
                hi_off[qi, ki] = hi_o
                any_present = True
            row_ents.append((key, base, delta, present))
        if any_present:
            idf_sum[qi] = sum(lex.idf(l) for l in q)
        ents[qi] = row_ents
    stub = QT1Batch(None, None, None, idf_sum, span_adj, stride)
    tail = (lo_off, hi_off, idf_sum, span_adj)
    if delta_fmt:
        key_base = np.zeros((B, K, L // BLK), np.int32)
        key_delta = np.zeros((B, K, L), np.uint16)
        for qi, row_ents in enumerate(ents):
            if row_ents is None:
                continue
            for ki, (_, base, delta, present) in enumerate(row_ents):
                if present:
                    key_base[qi, ki] = base
                    key_delta[qi, ki] = delta
        return "delta", (key_base, key_delta) + tail, stub
    key_g = np.full((B, K, L), SENTINEL, np.int32)
    for qi, row_ents in enumerate(ents):
        if row_ents is None:
            continue
        for ki, (key, _, _, present) in enumerate(row_ents):
            if not present:
                continue
            if cache is not None:
                g_row, _, _, pres = cache.get_rows(index, key, L, doc_shards, stride)
            else:
                g_row, _, _, pres = pack_fst_key_rows(index, key, L, doc_shards, stride)
            if pres:
                key_g[qi, ki] = g_row
    args = (np.zeros((B, K, 1), np.int32), key_g) + tail
    return "offsets", args, stub


def assemble_qt2_compressed(index, queries, L, K=3, doc_shards=1,
                            ccache=None, cache=None, plans=None):
    """Compressed QT2 step args from per-key cached rows (kind "wv_c").
    Returns (kind, args, batch_stub), kind "qt2_delta" / "qt2_offsets"."""
    B = len(queries)
    stride = qt1_stride(index)
    lex = index.lexicon
    delta_fmt = L % (BLK * doc_shards) == 0
    width = np.full((B, K, L), 255, np.uint8)
    n_keys = np.zeros(B, np.int32)
    idf_sum = np.zeros(B, np.float32)
    span_adj = np.zeros(B, np.float32)
    ents: list = [None] * B
    for qi, q in enumerate(queries):
        if not q:
            continue
        keys = (plans[qi] if plans is not None and plans[qi] is not None
                else qt2_plan(index, q)[0])[:K]
        n_keys[qi] = len(keys)
        span_adj[qi] = len(q) - 1
        row_ents = []
        any_present = False
        for ki, key in enumerate(keys):
            base, delta, w, ok, present = ccache.get(
                index, "wv_c", key, L, doc_shards, stride)
            delta_fmt &= ok
            if present:
                width[qi, ki] = w
                any_present = True
            row_ents.append((key, base, delta, present))
        if any_present:
            idf_sum[qi] = sum(lex.idf(l) for l in q)
        ents[qi] = row_ents
    stub = QT2Batch(None, None, n_keys, idf_sum, span_adj, stride)
    tail = (width, n_keys, idf_sum, span_adj)
    if delta_fmt:
        lo_base = np.zeros((B, K, L // BLK), np.int32)
        lo_delta = np.zeros((B, K, L), np.uint16)
        for qi, row_ents in enumerate(ents):
            if row_ents is None:
                continue
            for ki, (_, base, delta, present) in enumerate(row_ents):
                if present:
                    lo_base[qi, ki] = base
                    lo_delta[qi, ki] = delta
        return "qt2_delta", (lo_base, lo_delta) + tail, stub
    wv_lo = np.full((B, K, L), SENTINEL, np.int32)
    for qi, row_ents in enumerate(ents):
        if row_ents is None:
            continue
        for ki, (key, _, _, present) in enumerate(row_ents):
            if not present:
                continue
            if cache is not None:
                lo_row, _, pres = cache.get(index, "wv", key, L, doc_shards, stride)
            else:
                lo_row, _, pres = pack_wv_key_rows(index, key, L, doc_shards, stride)
            if pres:
                wv_lo[qi, ki] = lo_row
    return "qt2_offsets", (wv_lo,) + tail, stub


def assemble_qt34_compressed(index, queries, L, Kn=4, doc_shards=1,
                             ccache=None, cache=None, plans=None):
    """Compressed QT3/QT4 step args from per-key cached rows (kind
    "ord_c" — shared with the QT5 anchor/non-stop streams, so a key hot
    on either path warms both). Returns (kind, args, batch_stub), kind
    "qt34_delta" / "qt34_offsets"."""
    B = len(queries)
    stride = qt1_stride(index)
    lex = index.lexicon
    delta_fmt = L % (BLK * doc_shards) == 0
    a_pad = np.ones((B, L), np.uint8)
    ns_pad = np.ones((B, Kn, L), np.uint8)
    ns_r = np.zeros((B, Kn), np.int32)
    idf_sum = np.zeros(B, np.float32)
    span_adj = np.zeros(B, np.float32)
    a_ents: list = [None] * B
    ns_ents: list = [None] * B
    for qi, q in enumerate(queries):
        if not q:
            continue
        plan = (plans[qi] if plans is not None and plans[qi] is not None
                else qt34_plan(index, q))
        anchor, others, _ = plan
        span_adj[qi] = len(q) - 1
        base, delta, pad, ok, present = ccache.get(
            index, "ord_c", anchor, L, doc_shards, stride)
        delta_fmt &= ok
        if present:
            a_pad[qi] = pad
        a_ents[qi] = (anchor, base, delta, present)
        row_ents = []
        for ki, (lemma, r) in enumerate(others[:Kn]):
            b2, d2, p2, ok2, pr2 = ccache.get(
                index, "ord_c", lemma, L, doc_shards, stride)
            delta_fmt &= ok2
            ns_r[qi, ki] = r
            if pr2:
                ns_pad[qi, ki] = p2
            row_ents.append((lemma, b2, d2, pr2))
        ns_ents[qi] = row_ents
        idf_sum[qi] = sum(lex.idf(l) for l in q)
    stub = QT34Batch(None, None, ns_r, idf_sum, span_adj, stride)
    tail = (ns_r, idf_sum, span_adj)
    if delta_fmt:
        nb = L // BLK
        a_base = np.zeros((B, nb), np.int32)
        a_delta = np.zeros((B, L), np.uint16)
        ns_base = np.zeros((B, Kn, nb), np.int32)
        ns_delta = np.zeros((B, Kn, L), np.uint16)
        for qi in range(B):
            if a_ents[qi] is not None and a_ents[qi][3]:
                a_base[qi] = a_ents[qi][1]
                a_delta[qi] = a_ents[qi][2]
            for ki, (_, b2, d2, pr2) in enumerate(ns_ents[qi] or ()):
                if pr2:
                    ns_base[qi, ki] = b2
                    ns_delta[qi, ki] = d2
        args = (a_base, a_delta, a_pad, ns_base, ns_delta, ns_pad) + tail
        return "qt34_delta", args, stub

    def raw_row(lemma):
        if cache is not None:
            return cache.get(index, "ord", lemma, L, doc_shards, stride)
        return pack_ord_key_rows(index, lemma, L, doc_shards, stride)

    a_g = np.full((B, L), SENTINEL, np.int32)
    ns_g = np.full((B, Kn, L), SENTINEL, np.int32)
    for qi in range(B):
        if a_ents[qi] is not None and a_ents[qi][3]:
            g_row, pres = raw_row(a_ents[qi][0])
            if pres:
                a_g[qi] = g_row
        for ki, (lemma, _, _, pr2) in enumerate(ns_ents[qi] or ()):
            if pr2:
                g_row, pres = raw_row(lemma)
                if pres:
                    ns_g[qi, ki] = g_row
    return "qt34_offsets", (a_g, ns_g) + tail, stub


def assemble_qt5_compressed(index, queries, L, Kn=3, Ks=3, doc_shards=1,
                            ccache=None, cache=None, plans=None):
    """Compressed QT5 step args from per-key cached rows (kinds "ord_c"
    for anchor/non-stop streams, "nsw_c" for the uint8 NSW aggregates).
    Returns (kind, args, batch_stub), kind "qt5_delta" / "qt5_offsets"."""
    B = len(queries)
    stride = qt1_stride(index)
    lex = index.lexicon
    delta_fmt = L % (BLK * doc_shards) == 0
    a_pad = np.ones((B, L), np.uint8)
    ns_pad = np.ones((B, Kn, L), np.uint8)
    ns_r = np.zeros((B, Kn), np.int32)
    st_r = np.zeros((B, Ks), np.int32)
    cnt8 = np.zeros((B, Ks, L), np.uint8)
    eneg = np.zeros((B, Ks, L), np.uint8)
    epos = np.zeros((B, Ks, L), np.uint8)
    idf_sum = np.zeros(B, np.float32)
    span_adj = np.zeros(B, np.float32)
    a_ents: list = [None] * B
    ns_ents: list = [None] * B
    for qi, q in enumerate(queries):
        if not q:
            continue
        plan = (plans[qi] if plans is not None and plans[qi] is not None
                else qt5_plan(index, q))
        if plan is None:
            continue  # degenerate; routed to the CPU by the engine
        anchor, others, stops, _ = plan
        span_adj[qi] = len(q) - 1
        base, delta, pad, ok, present = ccache.get(
            index, "ord_c", anchor, L, doc_shards, stride)
        delta_fmt &= ok
        if present:
            a_pad[qi] = pad
        a_ents[qi] = (anchor, base, delta, present)
        row_ents = []
        for ki, (lemma, r) in enumerate(others[:Kn]):
            b2, d2, p2, ok2, pr2 = ccache.get(
                index, "ord_c", lemma, L, doc_shards, stride)
            delta_fmt &= ok2
            ns_r[qi, ki] = r
            if pr2:
                ns_pad[qi, ki] = p2
            row_ents.append((lemma, b2, d2, pr2))
        ns_ents[qi] = row_ents
        for ki, (sid, r) in enumerate(stops[:Ks]):
            c8, en, ep, _, pr = ccache.get(
                index, "nsw_c", (anchor, sid), L, doc_shards, stride)
            st_r[qi, ki] = r
            if pr:
                cnt8[qi, ki] = c8
                eneg[qi, ki] = en
                epos[qi, ki] = ep
        idf_sum[qi] = sum(lex.idf(l) for l in q)
    stub = QT5Batch(None, None, ns_r, None, None, st_r, idf_sum, span_adj, stride)
    tail = (ns_r, cnt8, eneg, epos, st_r, idf_sum, span_adj)
    if delta_fmt:
        nb = L // BLK
        a_base = np.zeros((B, nb), np.int32)
        a_delta = np.zeros((B, L), np.uint16)
        ns_base = np.zeros((B, Kn, nb), np.int32)
        ns_delta = np.zeros((B, Kn, L), np.uint16)
        for qi in range(B):
            if a_ents[qi] is not None and a_ents[qi][3]:
                a_base[qi] = a_ents[qi][1]
                a_delta[qi] = a_ents[qi][2]
            for ki, (_, b2, d2, pr2) in enumerate(ns_ents[qi] or ()):
                if pr2:
                    ns_base[qi, ki] = b2
                    ns_delta[qi, ki] = d2
        args = (a_base, a_delta, a_pad, ns_base, ns_delta, ns_pad) + tail
        return "qt5_delta", args, stub

    def raw_row(lemma):
        if cache is not None:
            return cache.get(index, "ord", lemma, L, doc_shards, stride)
        return pack_ord_key_rows(index, lemma, L, doc_shards, stride)

    a_g = np.full((B, L), SENTINEL, np.int32)
    ns_g = np.full((B, Kn, L), SENTINEL, np.int32)
    for qi in range(B):
        if a_ents[qi] is not None and a_ents[qi][3]:
            g_row, pres = raw_row(a_ents[qi][0])
            if pres:
                a_g[qi] = g_row
        for ki, (lemma, _, _, pr2) in enumerate(ns_ents[qi] or ()):
            if pr2:
                g_row, pres = raw_row(lemma)
                if pres:
                    ns_g[qi, ki] = g_row
    return "qt5_offsets", (a_g, ns_g) + tail, stub


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
