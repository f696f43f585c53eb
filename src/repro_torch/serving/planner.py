"""Query planner: the pure routing layer of the serving tier
(DESIGN.md §14).

``plan(request, snapshot, config)`` turns one request (a lemma-id list)
into a :class:`QueryPlan` — the machine-readable answer to "which
executable will this query hit, and why": query type, route, L-bucket,
payload format, estimated compiled-step cost, and a ``fallback_reason``
for every scalar-route shape of the DESIGN.md §13 dispatch matrix. The
function is pure (no engine state, no device work, no caches), so
``SearchService.explain()`` can answer routing questions without
executing, and the executed path can be asserted against the
pre-computed plan (tests/test_planner.py does exactly that, row by
row).

The paper's companion work (arXiv:1811.07361, arXiv:2101.03327) frames
index/parameter selection as an explicit per-query planning decision;
this module is that decision as a first-class object.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.lexicon import UNKNOWN_FL
from repro_torch.core.query import (
    QueryType,
    classify,
    qt1_plan,
    qt2_plan,
    qt34_plan,
    qt5_plan,
    select_wv_keys,
)

# -- routes ----------------------------------------------------------------
ROUTE_QT1 = "qt1"
ROUTE_QT2 = "qt2"
ROUTE_QT34 = "qt34"
ROUTE_QT5 = "qt5"
ROUTE_SCALAR = "scalar"  # the ProximitySearchEngine correctness backstop
ROUTE_EMPTY = "empty"    # answered inline with zero results

COMPILED_ROUTES = (ROUTE_QT1, ROUTE_QT2, ROUTE_QT34, ROUTE_QT5)

# -- payloads --------------------------------------------------------------
PAYLOAD_RAW = "raw"
PAYLOAD_DELTA16 = "delta16"
PAYLOAD_OFFSETS = "offsets"

# -- machine-readable fallback reasons, one per scalar-route shape of the
# DESIGN.md §13 dispatch matrix (column "CPU-fallback conditions")
FB_UNKNOWN_LEMMA = "unknown_lemma"            # any type: contains UNKNOWN_FL
FB_NO_FST_INDEX = "no_fst_index"              # QT1: no (f,s,t) store
FB_QUERY_TOO_SHORT = "query_too_short"        # QT1: len < 3 (CPU degenerate)
FB_QUERY_TOO_LONG = "query_too_long"          # QT1: len > MaxDistance (split)
FB_TOO_MANY_FST_KEYS = "too_many_fst_keys"    # QT1: > k_fst keys
FB_NO_WV_INDEX = "no_wv_index"                # QT2: no (w,v) store
FB_SHARDED_QT2 = "sharded_qt2_window"         # QT2: doc_shards > 1
FB_TOO_MANY_WV_KEYS = "too_many_wv_keys"      # QT2: > k_wv keys
FB_NO_ORDINARY_INDEX = "no_ordinary_index"    # QT3/QT4/QT5: no ordinary store
FB_TOO_MANY_ORD_CONSTRAINTS = "too_many_ord_constraints"  # QT3/QT4: > k_ord
FB_MULTIPLICITY_OVER_R_MAX = "multiplicity_exceeds_r_max"  # QT3/4/5: r > r_max
FB_NO_NSW_INDEX = "no_nsw_index"              # QT5: no NSW store
FB_DEGENERATE_QT5 = "degenerate_qt5_plan"     # QT5: no stop or no non-stop
FB_TOO_MANY_NS_CONSTRAINTS = "too_many_nonstop_constraints"  # QT5: > k_ns
FB_TOO_MANY_STOP_CONSTRAINTS = "too_many_stop_constraints"   # QT5: > k_st
FB_STOP_MULTIPLICITY_OVERFLOW = "stop_multiplicity_overflow"  # QT5: r > 254
FB_ROW_EXCEEDS_LADDER = "row_exceeds_ladder"  # any type: row > largest bucket
FB_LIVE_MEMTABLE = "live_memtable_key"        # any type: a query lemma lives in
# the snapshot's unsealed memtable overlay (DESIGN.md §18) — served scalar so
# the compiled ladder never packs against an ephemeral pre-refresh view


@dataclass(frozen=True)
class QueryPlan:
    """The per-query routing decision, inspectable before execution.

    * ``qtype`` — QT1-QT5 (None for empty / unknown-lemma requests);
    * ``route`` — ``qt1``/``qt2``/``qt34``/``qt5``/``scalar``/``empty``:
      the dispatch-matrix row (DESIGN.md §13) the request falls on;
    * ``step_family`` — the compiled-step family that will execute it;
      differs from ``route`` exactly when dispatch-aware batching rides
      a ``qt34`` request on the ``qt5`` executable (DESIGN.md §14); None
      off-device;
    * ``bucket`` — the L-bucket the padded posting rows hit (None
      off-device);
    * ``payload`` — ``raw``/``delta16``/``offsets``; the *predicted*
      device format (a delta16 prediction can still downgrade to
      offsets at pack time when a key's in-block span overflows uint16
      — ``SearchResponse.plan`` carries the executed format);
    * ``est_step_cost`` — padded posting slots the compiled step scans
      (streams x bucket x doc_shards): the shape-bound work behind the
      response-time guarantee. None for scalar/empty routes — the
      scalar engine has no compiled-shape bound, which is the point;
    * ``fallback_reason`` — machine-readable, set iff route is
      ``scalar``;
    * ``selection`` — the memoized key selection the packers consume
      ((f,s,t) keys / ordered (w,v) keys / the qt34/qt5 plan tuple);
    * ``measured`` — never set by ``plan()`` (the function stays pure);
      ``SearchService.explain(q, costs=True)`` attaches the §15
      measured-cost record here (per-B run-time percentiles, compile
      time, est-vs-measured ratio) on a *copy* of the
      memoized plan;
    * ``degraded`` — set by :func:`degrade` when admission control
      reroutes an over-budget plan to a smaller bucket (DESIGN.md §17):
      the packers truncate each key's posting rows to the smaller
      padded length, so the response searches a bounded posting prefix
      (results ⊆ the full route's candidate set) within the budget."""

    qtype: QueryType | None
    route: str
    step_family: str | None = None
    bucket: int | None = None
    payload: str | None = None
    est_step_cost: int | None = None
    fallback_reason: str | None = None
    selection: object = None
    measured: dict | None = None
    degraded: bool = False

    @property
    def is_compiled(self) -> bool:
        return self.route in COMPILED_ROUTES


def ladder_bucket(longest: int, config) -> int | None:
    """Smallest L-bucket holding a posting row of ``longest`` entries —
    sized for worst-case doc skew under ``doc_shards`` range
    partitioning (each shard segment holds only L / doc_shards slots,
    and a doc-skewed key can land all its postings in one segment).
    None when even the largest bucket cannot hold the row: the packers
    would silently truncate it, so the planner must route to the scalar
    engine instead."""
    longest *= config.doc_shards
    for cand in config.buckets:
        if longest <= cand:
            return cand
    return None


def delta16_aligned(bucket: int, config) -> bool:
    """Whether an L-bucket can take the block-delta16 format at all:
    every 64-posting block must align with the bucket/shard layout.
    The single source of the alignment rule — the planner's payload
    prediction and the executor's cache-less compress path both call
    it, so they cannot drift."""
    return bucket % (64 * config.doc_shards) == 0


def _payload(bucket: int, config, step_family: str | None = None,
             costs=None) -> str:
    """Predicted device payload for one compiled group: raw when the
    engine is uncompressed; delta16 when the bucket is block-aligned
    (the headline 4 B/posting format); offsets otherwise. Per-key
    uint16 span overflow can still downgrade a delta16 prediction at
    pack time.

    With a :class:`repro_torch.serving.costs.PayloadCostModel` (and the step
    family it is keyed by), the static rule only names the compressed
    *candidate* — the model arbitrates it against raw per
    (step_family, bucket) from measured warm batch time (DESIGN.md
    §16), so a route where compression loses (QT3's measured
    regression) serves raw while QT4 keeps its compressed win."""
    if not config.compressed:
        return PAYLOAD_RAW
    static = (PAYLOAD_DELTA16 if delta16_aligned(bucket, config)
              else PAYLOAD_OFFSETS)
    if costs is not None and step_family is not None:
        return costs.choose(step_family, bucket, static)
    return static


def _streams(step_family: str, config) -> int:
    """Static posting streams the compiled step scans per query."""
    if step_family == ROUTE_QT1:
        return config.k_fst
    if step_family == ROUTE_QT2:
        return config.k_wv
    if step_family == ROUTE_QT34:
        return 1 + config.k_ord
    return 1 + config.k_ns + config.k_st  # qt5: anchor + non-stop + NSW


def _compiled(qtype, route, bucket, config, selection, step_family=None,
              costs=None) -> QueryPlan:
    step_family = step_family or route
    return QueryPlan(
        qtype=qtype, route=route, step_family=step_family, bucket=bucket,
        payload=_payload(bucket, config, step_family, costs),
        est_step_cost=_streams(step_family, config) * bucket * config.doc_shards,
        selection=selection,
    )


def _scalar(qtype, reason: str) -> QueryPlan:
    return QueryPlan(qtype=qtype, route=ROUTE_SCALAR, fallback_reason=reason)


def degrade(plan: QueryPlan, bucket: int, config, costs=None) -> QueryPlan:
    """An over-budget compiled plan rerouted to a cheaper bucket — the
    admission controller's degraded-mode path (DESIGN.md §17).

    The key selection is unchanged; only the L-bucket shrinks. The row
    packers truncate each key's postings to the smaller padded length
    (``_fill_partitioned`` keeps the first ``L/doc_shards`` per shard
    segment, i.e. the lowest doc ranges), so the degraded step scans a
    *bounded posting prefix*: its candidate matches are a subset of the
    full route's, at ``bucket / plan.bucket`` of the step cost. The
    response is marked ``status="degraded"`` so clients know the
    guarantee was bought with completeness."""
    if not plan.is_compiled or bucket >= plan.bucket:
        raise ValueError(f"cannot degrade {plan.route}@{plan.bucket} "
                         f"to bucket {bucket}")
    return dataclasses.replace(
        plan,
        bucket=bucket,
        payload=_payload(bucket, config, plan.step_family, costs),
        est_step_cost=(_streams(plan.step_family, config) * bucket
                       * config.doc_shards),
        degraded=True,
    )


def plan(request, snapshot, config, costs=None) -> QueryPlan:
    """Pure routing: one request -> :class:`QueryPlan`, reproducing the
    DESIGN.md §13 dispatch matrix row by row (conditions checked in
    matrix order, so ``fallback_reason`` names the *first* failing
    one). ``request`` is a lemma-id list (or anything with a
    ``lemma_ids`` attribute); ``snapshot`` an immutable index view;
    ``config`` a :class:`repro_torch.serving.service.ServeConfig`; ``costs``
    an optional :class:`repro_torch.serving.costs.PayloadCostModel` — the
    one measured input: given the same (request, snapshot, config) and
    the same cost-model state (its ``generation`` is the service's
    memo key), the decision is still deterministic."""
    ids = list(getattr(request, "lemma_ids", request))
    if not ids:
        return QueryPlan(qtype=None, route=ROUTE_EMPTY)
    if any(l == UNKNOWN_FL for l in ids):
        return _scalar(None, FB_UNKNOWN_LEMMA)
    qtype = classify(ids, snapshot.lexicon)

    # live-memtable route (DESIGN.md §18): when the snapshot carries an
    # unsealed-memtable overlay and any query lemma has postings in it,
    # results depend on pre-refresh documents — the scalar engine reads
    # the overlay through the same merged-view API bit-identically, while
    # the compiled ladder would burn pack/compile work on a view that
    # dies at the next add. A query whose lemmas the overlay cannot
    # contribute postings to reads the same merged rows with or without
    # the overlay, so it keeps its compiled route (the same touch
    # predicate the pack cache uses for staleness).
    overlay = getattr(snapshot, "mem_overlay", None)
    if overlay is not None and getattr(config, "scalar_memtable", True):
        if any(l in overlay.index.ordinary for l in ids):
            return _scalar(qtype, FB_LIVE_MEMTABLE)

    if qtype == QueryType.QT1:
        if snapshot.fst is None:
            return _scalar(qtype, FB_NO_FST_INDEX)
        if len(ids) < 3:
            return _scalar(qtype, FB_QUERY_TOO_SHORT)
        if len(ids) > snapshot.max_distance:
            return _scalar(qtype, FB_QUERY_TOO_LONG)
        keys, longest = qt1_plan(snapshot, ids)
        if len(keys) > config.k_fst:
            return _scalar(qtype, FB_TOO_MANY_FST_KEYS)
        bucket = ladder_bucket(longest, config)
        if bucket is None:
            return _scalar(qtype, FB_ROW_EXCEEDS_LADDER)
        return _compiled(qtype, ROUTE_QT1, bucket, config, keys, costs=costs)

    if qtype == QueryType.QT2:
        if snapshot.wv is None:
            return _scalar(qtype, FB_NO_WV_INDEX)
        if config.doc_shards > 1:
            # the interval join's 2*MaxDistance window can reach across
            # a doc (and therefore shard-segment) boundary, which the
            # per-shard device join cannot see (pack_qt2_batch's caveat)
            return _scalar(qtype, FB_SHARDED_QT2)
        # cheap key-count early-out before qt2_plan's posting-count
        # scans + sort (the cover size never changes with ordering)
        if len(select_wv_keys(ids)) > config.k_wv:
            return _scalar(qtype, FB_TOO_MANY_WV_KEYS)
        ordered, longest = qt2_plan(snapshot, ids)
        bucket = ladder_bucket(longest, config)
        if bucket is None:
            return _scalar(qtype, FB_ROW_EXCEEDS_LADDER)
        return _compiled(qtype, ROUTE_QT2, bucket, config, ordered,
                         costs=costs)

    if qtype == QueryType.QT5:
        if snapshot.ordinary is None:
            return _scalar(qtype, FB_NO_ORDINARY_INDEX)
        if snapshot.nsw is None:
            return _scalar(qtype, FB_NO_NSW_INDEX)
        p5 = qt5_plan(snapshot, ids)
        if p5 is None:
            return _scalar(qtype, FB_DEGENERATE_QT5)
        anchor, others, stops, counts = p5
        if len(others) > config.k_ns:
            return _scalar(qtype, FB_TOO_MANY_NS_CONSTRAINTS)
        if len(stops) > config.k_st:
            return _scalar(qtype, FB_TOO_MANY_STOP_CONSTRAINTS)
        if any(r > config.r_max for _, r in others):
            return _scalar(qtype, FB_MULTIPLICITY_OVER_R_MAX)
        if any(r > 254 for _, r in stops):
            return _scalar(qtype, FB_STOP_MULTIPLICITY_OVERFLOW)
        longest = max(counts[anchor],
                      max((counts[l] for l, _ in others), default=0))
        bucket = ladder_bucket(longest, config)
        if bucket is None:
            return _scalar(qtype, FB_ROW_EXCEEDS_LADDER)
        return _compiled(qtype, ROUTE_QT5, bucket, config, p5, costs=costs)

    # QT3/QT4: ordinary-index window scans through the shared qt34_join
    # — computationally identical, so one route serves both
    if snapshot.ordinary is None:
        return _scalar(qtype, FB_NO_ORDINARY_INDEX)
    p34 = qt34_plan(snapshot, ids)
    _, others, counts = p34
    if len(others) > config.k_ord:
        return _scalar(qtype, FB_TOO_MANY_ORD_CONSTRAINTS)
    if any(r > config.r_max for _, r in others):
        return _scalar(qtype, FB_MULTIPLICITY_OVER_R_MAX)
    bucket = ladder_bucket(max(counts.values()), config)
    if bucket is None:
        return _scalar(qtype, FB_ROW_EXCEEDS_LADDER)
    # dispatch-aware batching (the ROADMAP item, DESIGN.md §14): a QT34
    # group whose constraint count fits the QT5 step's non-stop slots
    # rides the qt5 executable at the same (B, L) — qt5_join with zero
    # stop constraints *is* qt34_join — so mixed traffic compiles one
    # executable ladder for both paths
    family = (ROUTE_QT5 if config.share_buckets and len(others) <= config.k_ns
              else ROUTE_QT34)
    return _compiled(qtype, ROUTE_QT34, bucket, config, p34,
                     step_family=family, costs=costs)
