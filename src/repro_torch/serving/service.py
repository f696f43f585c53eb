"""SearchService: the deadline-aware serving facade (DESIGN.md §14).

The serving tier is three explicit layers — this module is the top one:

* :mod:`repro_torch.serving.planner` — pure per-query routing
  (``plan(request, snapshot, config) -> QueryPlan``);
* :mod:`repro_torch.serving.executors` — ``CompiledExecutor`` (serve-step
  factories + the shared per-(kind, B, L) executable table) and
  ``ScalarExecutor`` behind one protocol;
* :class:`SearchService` — submit/drain/refresh/explain over one
  :class:`ServeConfig`, on one device (the card unless the caller passes
  ``device="cpu"``) or over a device mesh whose ``model`` axis shards the
  documents (``mesh=``, ``repro_torch.launch.mesh``).

``submit(lemma_ids, deadline_s=...)`` returns a :class:`SearchTicket`
resolved by the next :meth:`SearchService.drain`; every
:class:`SearchResponse` carries the :class:`QueryPlan` that routed it,
whether its deadline was met, and how long it waited in the queue —
the paper's response-time guarantee as an observable, per-request
contract instead of an implicit property of a compiled step.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.torch_search import batch_size_bucket
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_mesh, tp_size
from repro_torch.obs import MetricsRegistry, Tracer, chrome_trace, write_chrome_trace
from repro_torch.serving import planner as _planner
from repro_torch.serving.admission import (
    ADMIT,
    BLAME_INFEASIBLE,
    BLAME_SHED,
    DEGRADE,
    REASON_OPTIMISTIC,
    REJECT_INFEASIBLE,
    STATUS_DEGRADED,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHED,
    AdmissionController,
    AdmissionVerdict,
)
from repro_torch.serving.executors import (
    CompiledExecutor,
    ExecResult,
    ScalarExecutor,
    empty_results,
    zero_phases,
)
from repro_torch.serving.costs import (
    PayloadCostModel,
    RecallCostModel,
    StepCostPredictor,
)
from repro_torch.serving.pack_cache import PackedPostingCache
from repro_torch.serving.planner import QueryPlan


@dataclass(frozen=True)
class ServeConfig:
    """Every serving knob in one (frozen, reusable) place.

    * ``buckets`` — the L-bucket ladder posting rows are padded to; one
      compiled executable exists per (step kind, B-bucket, L-bucket);
    * ``max_batch`` / ``top_k`` / ``doc_shards`` — batch cap, results
      per query, model-axis doc shards (must equal the serving mesh's
      model-axis size);
    * ``compressed`` — serve the block-delta16 device payload
      (DESIGN.md §11-§12) with per-batch offsets fallback;
    * ``use_pack_cache`` / ``use_compressed_cache`` / ``cache_entries``
      / ``cache_bytes`` — the packed-posting row caches;
    * ``k_fst``/``k_wv``/``k_ns``/``k_st``/``k_ord``/``r_max`` — static
      key/constraint capacities of the compiled steps (the dispatch
      matrix's fallback thresholds, DESIGN.md §13);
    * ``share_buckets`` — dispatch-aware batching: qt34 groups whose
      plans fit the QT5 step's non-stop slots ride the qt5 executable
      of the same (B, L), and are batched together with qt5 traffic
      (DESIGN.md §14);
    * ``payload_cost_driven`` — arbitrate each compressed group's
      payload (raw vs the static delta16/offsets rule) per
      (step_family, L-bucket) from measured warm batch time
      (DESIGN.md §16); no effect on an uncompressed engine;
    * ``default_deadline_s`` — deadline attached to submits that don't
      pass one (None = no deadline);
    * ``admission`` — the §17 deadline control loop: ``submit()``
      consults an :class:`repro_torch.serving.admission.AdmissionController`
      per deadline-carrying request, fast-rejecting infeasible budgets,
      degrading over-budget plans to a truncated-prefix route and
      shedding predicted-miss traffic while overloaded (default off:
      without it deadlines are measured, never enforced);
    * ``max_queue`` — bounded submit queue (admission engines only):
      past the bound the deadline-aware drop policy sheds the queued
      request that is already predicted infeasible, or the newcomer
      when every queued request is still feasible — never the FIFO
      head;
    * ``degrade`` — allow the admission controller to reroute an
      over-budget compiled plan to a smaller bucket
      (``planner.degrade``) instead of rejecting it outright;
    * ``split_budget`` / ``split_max_urgent`` — EDF group splitting
      (§17): max split dispatches per drain (0 disables) and max size
      of one urgent sub-batch;
    * ``shed_enter_s`` / ``shed_exit_s`` — overload hysteresis
      thresholds on the (EWMA-smoothed) predicted backlog (enter >
      exit, so transient bursts cannot flap the shed decision);
    * ``admit_margin`` / ``admit_optimism`` — the controller's reserve
      policy: admit when predicted completion fits ``margin ×`` the
      budget (the reserve absorbs work admitted later that lands
      ahead), optimistically up to ``optimism ×`` that bound while not
      latched overloaded;
    * ``adaptive_margin`` — derive the reserve from the controller's
      *realized* predicted-vs-actual completion error (recent-quantile
      tracking, DESIGN.md §19) instead of pinning it at
      ``admit_margin``; the static value stays the floor and the cold
      fallback, so a cold or badly-predicting engine is never less
      conservative than the hand-swept reserve;
    * ``admission_headroom`` — multiplier on every predicted cost
      (measured p50s under-predict the tail the deadline is judged on);
    * ``unit_us_per_kslot`` / ``unit_scalar_us`` — the cold-start cost
      fallbacks used before any measured ``serve.step.*`` samples
      exist;
    * ``serve_memtable`` — refresh() picks up the source's
      ``live_view()`` (sealed segments + the unsealed memtable as an
      overlay pseudo-segment, DESIGN.md §18) instead of the last
      *published* snapshot, making adds/deletes visible to drains
      without waiting for an index refresh;
    * ``scalar_memtable`` — route queries whose lemmas the live overlay
      could contribute postings to through the scalar engine
      (``FB_LIVE_MEMTABLE``) rather than packing the compiled ladder
      against an ephemeral view; overlay-untouched queries keep their
      compiled route either way;
    * ``trace_enabled`` / ``trace_capacity`` — the §15 span tracer (a
      bounded ring of completed spans, sized to hold a 20 s window of
      a busy card's spans; disabling reduces the obs overhead to the
      per-phase timestamps and the registry's instruments: no spans,
      no CUDA step events, no profiler ranges);
    * ``metrics_capacity`` — samples retained per latency histogram."""

    buckets: tuple = (1024, 4096, 16384, 65536)
    max_batch: int = 64
    top_k: int = 16
    doc_shards: int = 1
    compressed: bool = False
    use_pack_cache: bool = True
    use_compressed_cache: bool = True
    cache_entries: int = 4096
    cache_bytes: int = 256 << 20
    k_fst: int = 2
    k_wv: int = 3
    k_ns: int = 3
    k_st: int = 3
    k_ord: int = 4
    r_max: int = 4
    share_buckets: bool = True
    payload_cost_driven: bool = True
    serve_memtable: bool = False
    scalar_memtable: bool = True
    default_deadline_s: float | None = None
    admission: bool = False
    max_queue: int | None = None
    degrade: bool = True
    split_budget: int = 2
    split_max_urgent: int = 8
    shed_enter_s: float = 0.100
    shed_exit_s: float = 0.025
    admit_margin: float = 0.4
    adaptive_margin: bool = True
    admit_optimism: float = 1.2
    admission_headroom: float = 1.3
    unit_us_per_kslot: float = 1.0
    unit_scalar_us: float = 5000.0
    trace_enabled: bool = True
    trace_capacity: int = 1 << 17
    metrics_capacity: int = 4096

    def __post_init__(self):
        object.__setattr__(self, "buckets", tuple(sorted(self.buckets)))

    # -- serialization (the §19 tuner's emit/load contract) ----------------
    def to_json_dict(self) -> dict:
        """Every knob as plain JSON data (tuples become lists).
        ``from_json_dict(to_json_dict())`` is the identity — the tuner
        emits its winning config through this and ``launch/serve.py
        --config`` loads it back."""
        d = dataclasses.asdict(self)
        d["buckets"] = list(self.buckets)
        return d

    @classmethod
    def from_json_dict(cls, data: dict) -> "ServeConfig":
        """Rebuild a config from :meth:`to_json_dict` output. Unknown
        fields fail loudly: a config artifact naming a knob this build
        does not have must not silently serve defaults."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(f"unknown ServeConfig fields: {unknown}")
        kw = dict(data)
        if "buckets" in kw:
            kw["buckets"] = tuple(kw["buckets"])
        return cls(**kw)


@dataclass
class SearchTicket:
    """Future-like handle returned by :meth:`SearchService.submit`,
    resolved in place by the next :meth:`SearchService.drain` (there is
    no background thread — resolution is the drain that serves it).

    On an admission-controlled engine (DESIGN.md §17) a ticket can also
    resolve *at submit time*: rejected/shed requests carry a
    :class:`SearchResponse` with ``status="rejected"``/``"shed"`` and
    empty results — ``result()`` never hangs on a ticket no drain will
    serve. ``verdict`` records the admission decision;
    ``degraded_bucket`` the cheaper bucket a degraded admit was
    rerouted to (applied by the resolving drain against its own pinned
    snapshot). ``request_id`` numbers the request from 1 in submit order
    (the ``request``/``requests`` args of its spans)."""

    lemma_ids: list
    deadline_s: float | None = None
    request_id: int = 0
    arrival: float = field(default_factory=time.perf_counter)
    response: "SearchResponse | None" = None
    verdict: AdmissionVerdict | None = None
    degraded_bucket: int | None = None
    plan: QueryPlan | None = None
    group_key: tuple | None = None  # internal: pending-backlog accounting

    @property
    def done(self) -> bool:
        return self.response is not None

    def result(self) -> "SearchResponse":
        if self.response is None:
            raise RuntimeError("ticket not resolved yet — call drain()")
        return self.response


@dataclass
class SearchResponse:
    """One served request: the results plus the serving contract —
    ``plan`` is the :class:`QueryPlan` that routed it (its ``payload``
    reflects the format actually executed), ``deadline_met`` whether
    resolution beat the ticket's budget (None when no deadline was
    set), ``queue_wait_s`` the time between submit and its batch
    starting execution.

    Observability surface (DESIGN.md §15): ``phases`` maps every phase
    of the request's life to its duration in seconds — ``queue`` (submit
    → its batch starting, less its own planning), ``plan``, then the
    batch phases ``pack`` / ``compress`` / ``compile`` / ``dispatch`` /
    ``execute`` / ``decode`` — and sums to the end-to-end latency
    ``finished_at - arrival``.
    ``started_at``/``finished_at`` are the perf_counter bounds of the
    batch that served it, on every route including scalar fallback and
    empty. ``deadline_blame`` names the largest non-queue phase when
    the deadline was missed — a missed budget names the phase that blew
    it — and the queue when waiting alone exceeded the budget.

    ``status`` is the §17 serving outcome: ``ok`` (served as planned),
    ``degraded`` (served from a truncated-prefix route the admission
    controller rerouted it to), ``rejected`` (budget infeasible even on
    an idle system — resolved at submit, empty results) or ``shed``
    (dropped under overload — resolved at submit or by the bounded
    queue, empty results).

    ``request_id`` is the ticket's; ``batch_span`` the id of the
    tracer's ``batch`` span that served the request, whose ``requests``
    arg lists it (0 when no batch served it or the tracer is off)."""

    results: dict
    latency_s: float
    bucket: int
    batch_size: int
    path: str = "qt1"
    plan: QueryPlan | None = None
    deadline_met: bool | None = None
    queue_wait_s: float = 0.0
    phases: dict = field(default_factory=dict)
    started_at: float = 0.0
    finished_at: float = 0.0
    deadline_blame: str | None = None
    status: str = STATUS_OK
    request_id: int = 0
    batch_span: int = 0

    @property
    def e2e_s(self) -> float:
        """End-to-end submit → resolution latency (queue wait included)."""
        return self.queue_wait_s + (self.finished_at - self.started_at)


def _route_to_path(route: str) -> str:
    """Plan routes -> the executed-path names of ``stats["paths"]``
    (the pre-planner vocabulary: the scalar route reports as "cpu")."""
    return "cpu" if route == _planner.ROUTE_SCALAR else route


class SearchService:
    """Deadline-aware, bucketed, batched proximity-search serving over
    a static ``ProximityIndex`` or a snapshot-able incremental index
    (``repro_torch.index.SegmentedIndex``), on one device or over a
    device mesh: ``device=X`` serves on a (1, 1) mesh on X, ``mesh=`` (a
    ``repro_torch.launch.mesh.Mesh``, (1, S) for a service, whose model
    axis must equal ``config.doc_shards``) shards the documents over S
    devices, and neither means the card (which raises when there is
    none; the tests pass ``"cpu"``). One process drives every device of
    the mesh.

    Serving always runs against an *immutable* searcher snapshot: a
    drain pins the snapshot once, so in-flight batches see a consistent
    view even while the indexer seals memtables and runs background
    merges; :meth:`refresh` picks up the indexer's latest published
    snapshot. Each request is routed by the pure planner per the
    DESIGN.md §13 dispatch matrix, grouped per (step family, L-bucket)
    — with ``share_buckets``, qt34 and qt5 traffic batch together on
    the qt5 executables — padded to the power-of-two batch ladder, and
    served earliest-deadline-group first; shapes the static steps
    cannot express take the scalar engine, so results are always
    exact. :meth:`explain` returns the plan without executing.

    Hot-path machinery under the facade follows DESIGN.md §11-§13: the
    packed-posting row caches (snapshot-identity invalidation, add-only
    and merge-aware retention), the per-key compressed-row cache, and
    the per-(kind, B, L) executable table owned by
    :class:`CompiledExecutor`."""

    def __init__(self, index, config: ServeConfig | None = None,
                 device=None, mesh=None):
        self.config = config if config is not None else ServeConfig()
        cfg = self.config
        self._source = index if hasattr(index, "snapshot") else None
        self.index = index.snapshot() if self._source is not None else index
        if cfg.compressed and getattr(self.index, "max_distance", 0) > 254:
            # all compressed formats carry fragment bounds / NSW offsets
            # as uint8 distances; beyond 254 they would silently clip
            raise ValueError(
                "compressed serving requires max_distance <= 254 "
                f"(got {self.index.max_distance})"
            )
        if device is not None and mesh is not None:
            raise ValueError("pass device= or mesh=, not both")
        if mesh is None:
            mesh = make_mesh((1, 1), ("data", "model"),
                             devices=[resolve_device(device)])
        else:
            for dev in mesh.unique_devices():
                resolve_device(dev)  # a card mesh on a host without a card
        if cfg.doc_shards != tp_size(mesh):
            # the reference states this invariant (jax_search.py) but
            # does not check it; a mismatch would join rows partitioned
            # for another shard count
            raise ValueError(
                f"doc_shards={cfg.doc_shards} must equal the serving "
                f"mesh's model-axis size ({tp_size(mesh)})")
        self.mesh = mesh
        self.device = mesh.devices.flat[0]
        # §15 observability tier: one registry + tracer per service,
        # shared by the executors and both row caches so every layer's
        # timings land in the same place
        self.metrics = MetricsRegistry(histogram_capacity=cfg.metrics_capacity)
        self.tracer = Tracer(capacity=cfg.trace_capacity,
                             enabled=cfg.trace_enabled)
        self._request_ids = itertools.count(1)
        self.pack_cache = (
            PackedPostingCache(max_entries=cfg.cache_entries,
                               max_bytes=cfg.cache_bytes,
                               metrics=self.metrics, scope="cache.pack",
                               tracer=self.tracer)
            if cfg.use_pack_cache
            else None
        )
        # per-key compressed rows derive from (and sit beside) the raw
        # row cache; without it every warm compressed drain re-runs the
        # O(B·K·L) host delta encoding
        self.compressed_cache = (
            PackedPostingCache(max_entries=cfg.cache_entries,
                               max_bytes=cfg.cache_bytes,
                               source=self.pack_cache,
                               metrics=self.metrics,
                               scope="cache.compressed",
                               tracer=self.tracer)
            if cfg.compressed and cfg.use_compressed_cache
            else None
        )
        # measured payload arbitration (DESIGN.md §16): only meaningful
        # when two payload arms exist, i.e. on a compressed engine
        self.payload_costs = (
            PayloadCostModel()
            if cfg.compressed and cfg.payload_cost_driven else None
        )
        self.compiled = CompiledExecutor(
            self.mesh, cfg, pack_cache=self.pack_cache,
            compressed_cache=self.compressed_cache,
            metrics=self.metrics, tracer=self.tracer,
            costs=self.payload_costs,
        )
        self.scalar = ScalarExecutor(cfg, metrics=self.metrics,
                                     tracer=self.tracer)
        # §17 deadline control loop: predictor + controller consulted at
        # submit; pending-group counts and the in-flight horizon feed
        # the backlog estimate the controller judges against
        self.predictor = StepCostPredictor(self.compiled, cfg,
                                           _planner._streams)
        self.admission = (
            AdmissionController(cfg.shed_enter_s, cfg.shed_exit_s,
                                margin=cfg.admit_margin,
                                optimism=cfg.admit_optimism,
                                adaptive_margin=cfg.adaptive_margin)
            if cfg.admission else None
        )
        # measured recall cost of degraded buckets (§19): orders the
        # degrade candidates the controller judges, best-retained-recall
        # first (prefix fraction as the cold prior)
        self.recall_costs = (
            RecallCostModel()
            if cfg.admission and cfg.degrade else None
        )
        self._pending: dict[tuple, int] = {}
        self._inflight_until = 0.0
        self._queue: list[SearchTicket] = []
        self._queue_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # per-snapshot lemma ids -> QueryPlan; validity is tied to the
        # *pinned view's identity* (not to refresh() clearing it: a
        # drain racing a refresh could otherwise re-insert a stale
        # entry after the clear). Bounded: a high-cardinality query
        # stream over a static index never refreshes, so the memo is
        # cleared wholesale at the cap (rebuilding an entry is one
        # n_postings scan per key)
        self._plan_memo: dict[tuple, QueryPlan] = {}
        self._plan_memo_view = None
        self._plan_memo_cap = 65536
        self._plan_memo_gen = 0
        self.stats = {
            "batches": 0, "requests": 0, "refreshes": 0,
            "compressed_batches": 0, "offset_fallbacks": 0,
            "bucket_hist": {b: 0 for b in cfg.buckets},
            "paths": {"qt1": 0, "qt2": 0, "qt34": 0, "qt5": 0,
                      "cpu": 0, "empty": 0},
            "plans": {
                "routes": {r: 0 for r in (*_planner.COMPILED_ROUTES,
                                          _planner.ROUTE_SCALAR,
                                          _planner.ROUTE_EMPTY)},
                "fallbacks": {},
                "executables": 0,
                "shared_batches": 0,
                "est_vs_measured": {},
            },
            "deadlines": {"met": 0, "missed": 0, "unset": 0,
                          "miss_blame": {}},
            "pack_cache": {}, "compressed_cache": {},
        }
        if self.admission is not None:
            self.stats["admission"] = {
                "admitted": 0, "optimistic": 0, "degraded": 0,
                "rejected_infeasible": 0, "shed_overload": 0,
                "queue_shed": 0, "expired": 0, "splits": 0,
                "overload_transitions": 0,
                "margin": self.admission.margin_stats(),
                "recall": {},
            }

    # -- planning ----------------------------------------------------------
    def _plan(self, index, lemma_ids) -> QueryPlan:
        # validity is (snapshot identity, cost-model generation): a
        # payload-choice flip bumps the generation, so memoized plans
        # can never pin a stale payload
        gen = (self.payload_costs.generation
               if self.payload_costs is not None else 0)
        if index is not self._plan_memo_view or gen != self._plan_memo_gen:
            # the scalar executor tracks snapshot identity itself
            self._plan_memo = {}
            self._plan_memo_view = index
            self._plan_memo_gen = gen
        memo_key = tuple(lemma_ids)
        p = self._plan_memo.get(memo_key)
        if p is not None:
            return p
        p = _planner.plan(list(lemma_ids), index, self.config,
                          costs=self.payload_costs)
        if len(self._plan_memo) >= self._plan_memo_cap:
            self._plan_memo.clear()
        self._plan_memo[memo_key] = p
        return p

    def explain(self, lemma_ids, costs: bool = False) -> QueryPlan:
        """The :class:`QueryPlan` this request would execute under —
        route, executable family, L-bucket, payload, estimated step
        cost, fallback reason — without executing anything. Planned
        against the currently pinned snapshot with the same memo the
        next drain will use, so ``explain(q)`` and the executed
        ``response.plan`` agree (tests/test_planner.py pins this per
        dispatch-matrix row).

        With ``costs=True`` the returned plan additionally carries
        ``measured`` — the §15 calibration record for the same
        (step_family, L-bucket) executable family: per-B measured
        run-time percentiles from the live ``serve.step.*`` histograms,
        the first-call warm-up time, and ``us_per_kslot`` (measured p50 per thousand
        ``est_step_cost`` slots — the est-vs-measured ratio). The
        cost-annotated plan is a fresh object (the memoized plan stays
        identity-stable); ``measured`` is None off-device or before any
        warm batch of the shape has run."""
        p = self._plan(self.index, lemma_ids)
        if not costs:
            return p
        measured = None
        if p.is_compiled:
            table = self.compiled.measured_cost(p.step_family, p.bucket)
            if table:
                est = p.est_step_cost
                for entry in table.values():
                    entry["us_per_kslot"] = (
                        entry["measured_p50_us"] / (est / 1000.0)
                    )
                measured = {"est_step_cost": est, "executables": table}
        return dataclasses.replace(p, measured=measured)

    # -- lifecycle ---------------------------------------------------------
    def refresh(self) -> None:
        """Pick up the indexer's latest published snapshot.

        A no-op when serving a static ``ProximityIndex``; for a
        ``repro_torch.index.SegmentedIndex`` source this swaps in the
        newest immutable ``SegmentedView``, making documents added or
        deleted since the previous refresh visible to subsequent drains.
        Already in-flight drains keep the snapshot they pinned. The
        executable table is reused across refreshes (only the host-side
        packing sees the new postings); plans are re-derived lazily, and
        the row caches invalidate themselves on the first lookup against
        the new snapshot — entries are keyed by snapshot identity, and
        benign transitions (add-only refreshes, pure background
        compactions) retain untouched keys (DESIGN.md §12, §18).

        With ``serve_memtable`` the service instead picks the source's
        ``live_view()`` — sealed segments plus the unsealed memtable as
        an overlay — so documents are searchable the moment they are
        added (DESIGN.md §18); the planner routes overlay-touching
        queries to the scalar engine when ``scalar_memtable`` is set."""
        if self._source is not None:
            if self.config.serve_memtable and hasattr(self._source, "live_view"):
                self.index = self._source.live_view()
            else:
                self.index = self._source.snapshot()
            self.stats["refreshes"] += 1

    # -- serving -----------------------------------------------------------
    def submit(self, lemma_ids, deadline_s: float | None = None,
               arrival: float | None = None) -> SearchTicket:
        """Queue one request (a lemma-id list, i.e. one sub-query of
        ``core.query.build_subqueries``) for the next :meth:`drain`;
        returns its :class:`SearchTicket`. ``deadline_s`` is a budget
        from *now* (submission): the resolving drain reports
        ``deadline_met`` per response and prioritizes
        tighter-deadline groups. ``arrival`` backdates the request to a
        scheduled perf_counter instant (trace replay / the open-loop
        load harness, DESIGN.md §17): queue wait, the deadline verdict
        *and* the admission budget are all judged from it. Thread-safe;
        on a non-admission engine no planning, packing or device work
        happens until the batcher cuts a batch — with
        ``config.admission`` the §17 controller plans the request
        (memoized) and judges its budget here, so a rejected or shed
        ticket resolves immediately and never hangs."""
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        ticket = SearchTicket(list(lemma_ids), deadline_s=deadline_s,
                              request_id=next(self._request_ids))
        if arrival is not None:
            ticket.arrival = arrival
        if self.admission is None:
            with self._queue_lock:
                self._queue.append(ticket)
            return ticket
        self._admit(ticket)
        return ticket

    def _group_key(self, p: QueryPlan) -> tuple:
        if p.route == _planner.ROUTE_EMPTY:
            return ("empty", None)
        if p.route == _planner.ROUTE_SCALAR:
            return ("scalar", None)
        return (p.step_family, p.bucket)

    def _backlog_locked(self, now: float) -> float:
        """Predicted seconds of queued + in-flight work (queue lock
        held): the remaining horizon of the currently executing drain
        plus each pending group's batch-count × predicted batch cost —
        per-(family, bucket) counts, not per-request sums, because
        batching amortizes (16 queued qt5@4096 requests are one batch,
        not 16)."""
        backlog = max(0.0, self._inflight_until - now)
        mb = self.config.max_batch
        for (family, bucket), n in self._pending.items():
            if n <= 0 or family == "empty":
                continue
            if family == "scalar":
                backlog += n * self.predictor.scalar_s()
            else:
                B = batch_size_bucket(min(n, mb), mb)
                backlog += (-(-n // mb)) * self.predictor.batch_s(
                    family, B, bucket)
        return backlog

    def _admit(self, ticket: SearchTicket) -> None:
        """The §17 admission decision for one submit: predict the
        request's completion (backlog + its group's batch cost, per
        :class:`StepCostPredictor`), let the controller pick the
        least-degraded feasible route, and either enqueue the ticket or
        resolve it right here as rejected/shed."""
        cfg = self.config
        mb = cfg.max_batch
        with self.tracer.span("admission", request=ticket.request_id):
            p = self._plan(self.index, ticket.lemma_ids)
            gkey = self._group_key(p)
            now = time.perf_counter()
            with self._queue_lock:
                backlog = self._backlog_locked(now)
                pend = self._pending.get(gkey, 0)
            if p.route == _planner.ROUTE_EMPTY:
                candidates = [(None, 0.0)]
                idle_s = 0.0
            elif p.route == _planner.ROUTE_SCALAR:
                candidates = [(None, self.predictor.scalar_s())]
                idle_s = candidates[0][1]
            else:
                B = batch_size_bucket(min(pend + 1, mb), mb)
                candidates = [(p.bucket,
                               self.predictor.batch_s(p.step_family, B,
                                                      p.bucket))]
                if cfg.degrade:
                    # degrade candidates ordered by estimated retained
                    # recall (measured result-count ratio vs the full
                    # route, §19), so "first fit" is "least measured
                    # degradation"; a cold recall model falls back to
                    # the prefix-fraction prior == largest-first
                    below = [b for b in cfg.buckets if b < p.bucket]
                    if self.recall_costs is not None:
                        below = self.recall_costs.order(
                            p.step_family, below, p.bucket)
                    else:
                        below = sorted(below, reverse=True)
                    candidates += [
                        (b, self.predictor.batch_s(p.step_family, B, b))
                        for b in below
                    ]
                # infeasibility is judged on a B=1 batch of the cheapest
                # candidate route — serving this request *alone*, not
                # with the crowd it happens to arrive into
                idle_s = min(self.predictor.batch_s(p.step_family, 1, b)
                             for b, _ in candidates)
            budget = (None if ticket.deadline_s is None
                      else ticket.arrival + ticket.deadline_s - now)
            verdict = self.admission.consider(candidates, backlog, budget,
                                              idle_cost_s=idle_s)
            ticket.verdict = verdict
            self.metrics.inc(f"serve.admission.{verdict.decision}")
            with self._stats_lock:
                adm = self.stats["admission"]
                if verdict.decision == ADMIT:
                    adm["admitted"] += 1
                    if verdict.reason == REASON_OPTIMISTIC:
                        adm["optimistic"] += 1
                elif verdict.decision == DEGRADE:
                    adm["admitted"] += 1
                    adm["degraded"] += 1
                elif verdict.decision == REJECT_INFEASIBLE:
                    adm["rejected_infeasible"] += 1
                else:
                    adm["shed_overload"] += 1
                adm["overload_transitions"] = self.admission.transitions
            if not verdict.admitted:
                status = (STATUS_REJECTED
                          if verdict.decision == REJECT_INFEASIBLE
                          else STATUS_SHED)
                with self.tracer.span(f"admission.{verdict.decision}",
                                      route=p.route,
                                      request=ticket.request_id):
                    self._resolve_unserved(ticket, p, status)
                return
            if verdict.decision == DEGRADE:
                ticket.degraded_bucket = verdict.bucket
                gkey = (p.step_family, verdict.bucket)
            ticket.plan = p
            ticket.group_key = gkey
            self._enqueue(ticket, gkey)

    def _enqueue(self, ticket: SearchTicket, gkey: tuple) -> None:
        """Append under the bounded-queue policy: past ``max_queue`` the
        deadline-aware drop sheds whichever request is already predicted
        infeasible (least remaining budget among those the backlog has
        outrun) — the newcomer only when every queued request is still
        feasible. Never a FIFO head-drop."""
        cfg = self.config
        victim = None
        with self._queue_lock:
            if cfg.max_queue is not None and len(self._queue) >= cfg.max_queue:
                now = time.perf_counter()
                backlog = self._backlog_locked(now)
                victim = self._infeasible_victim_locked(now, backlog)
                if victim is not None:
                    self._queue.remove(victim)
                    if victim.group_key is not None:
                        self._pending[victim.group_key] = max(
                            0, self._pending.get(victim.group_key, 1) - 1)
                    self._queue.append(ticket)
                    self._pending[gkey] = self._pending.get(gkey, 0) + 1
                else:
                    victim = ticket  # full of feasible work: shed newcomer
            else:
                self._queue.append(ticket)
                self._pending[gkey] = self._pending.get(gkey, 0) + 1
        if victim is not None:
            self.metrics.inc("serve.admission.queue_shed")
            with self._stats_lock:
                self.stats["admission"]["queue_shed"] += 1
            with self.tracer.span("admission.queue_shed",
                                  request=victim.request_id):
                self._resolve_unserved(victim, victim.plan, STATUS_SHED)

    def _infeasible_victim_locked(self, now: float,
                                  backlog_s: float) -> SearchTicket | None:
        """The queued ticket the backlog has most clearly outrun: least
        remaining budget among deadline-carrying tickets whose remaining
        budget is below the predicted backlog. None when every queued
        request is still feasible."""
        victim, victim_rem = None, None
        for t in self._queue:
            if t.deadline_s is None:
                continue
            rem = t.arrival + t.deadline_s - now
            if rem < backlog_s and (victim_rem is None or rem < victim_rem):
                victim, victim_rem = t, rem
        return victim

    def _resolve_unserved(self, ticket: SearchTicket, p: QueryPlan | None,
                          status: str) -> None:
        """Resolve a rejected/shed ticket in place with empty results —
        ``result()`` must never hang on a ticket no drain will serve.
        Rejected/shed requests with a deadline count as misses with the
        §17 blame vocabulary (``infeasible`` / ``shed``); deadline-less
        ones count as unset."""
        now = time.perf_counter()
        wait = max(now - ticket.arrival, 0.0)
        blame = None
        if ticket.deadline_s is not None:
            blame = (BLAME_INFEASIBLE if status == STATUS_REJECTED
                     else BLAME_SHED)
            with self._stats_lock:
                dl = self.stats["deadlines"]
                dl["missed"] += 1
                dl["miss_blame"][blame] = dl["miss_blame"].get(blame, 0) + 1
            self.metrics.inc(f"serve.deadline.miss_blame.{blame}")
        else:
            with self._stats_lock:
                self.stats["deadlines"]["unset"] += 1
        resp = SearchResponse(
            results=empty_results(), latency_s=0.0, bucket=0, batch_size=0,
            path=_route_to_path(p.route) if p is not None else "unserved",
            plan=p, deadline_met=False if ticket.deadline_s is not None
            else None,
            queue_wait_s=wait,
            phases={"queue": wait, "plan": 0.0, **zero_phases()},
            started_at=now, finished_at=now, deadline_blame=blame,
            status=status, request_id=ticket.request_id,
        )
        ticket.response = resp

    def drain(self) -> list[SearchResponse]:
        """Serve everything queued, resolving every pending ticket and
        returning one :class:`SearchResponse` per request **in
        submission order**.

        The snapshot is pinned once for the whole drain. Requests are
        planned (memoized per lemma-id tuple per snapshot), grouped per
        (step family, L-bucket) — so with ``share_buckets`` qt34 and
        qt5 requests batch together — padded to the power-of-two batch
        ladder, and groups are served earliest-deadline first
        (deadline-less groups follow, largest first). Each response
        carries its plan, executed path, bucket, batch size, wall-clock
        batch latency, queue wait and deadline verdict.

        On an admission engine, requests whose deadline already expired
        while queued are shed here instead of served (a guaranteed miss
        would still burn a batch slot, §17): they resolve through their
        ticket with ``status="shed"`` and are *not* in the returned
        list."""
        if not self._queue:
            return []
        index = self.index
        # swap the queue out under the submit lock BEFORE grouping: a
        # submit() racing this drain either lands before the swap (and
        # is served now) or after it (and stays queued) — never
        # silently dropped into the already-grouped list
        with self._queue_lock:
            pending, self._queue = self._queue, []
            self._pending = {}
        # this drain lands new step measurements; predictions made from
        # the previous batch of measurements expire now
        self.predictor.invalidate()
        if self.admission is not None:
            pending = self._drop_expired(pending)
            if not pending:
                return []
        slots: list = [None] * len(pending)
        with self.tracer.span("drain", requests=len(pending)):
            # per-request planning time is part of the phase breakdown
            # (memoized hits are sub-µs; misses scan posting counts)
            plans, plan_s = [], []
            with self.tracer.span("plan", n=len(pending)):
                for t in pending:
                    tp0 = time.perf_counter()
                    p = self._plan(index, t.lemma_ids)
                    # a degraded admit reroutes to the cheaper bucket
                    # here, against *this* drain's pinned snapshot (the
                    # memoized plan stays untouched for other requests)
                    if (t.degraded_bucket is not None and p.is_compiled
                            and t.degraded_bucket < p.bucket):
                        p = _planner.degrade(p, t.degraded_bucket,
                                             self.config,
                                             costs=self.payload_costs)
                    plans.append(p)
                    plan_s.append(time.perf_counter() - tp0)
            with self.tracer.span("group"):
                groups: dict[tuple, list[int]] = {}
                for i, p in enumerate(plans):
                    if p.route == _planner.ROUTE_EMPTY:
                        key = ("empty", None)
                    elif p.route == _planner.ROUTE_SCALAR:
                        key = ("scalar", None)
                    else:
                        key = (p.step_family, p.bucket)
                    groups.setdefault(key, []).append(i)

                def urgency(item):
                    _, idxs = item
                    deadline = min(
                        (pending[i].arrival + pending[i].deadline_s
                         for i in idxs if pending[i].deadline_s is not None),
                        default=float("inf"),
                    )
                    return (deadline, -len(idxs))

                order = sorted(groups.items(), key=urgency)

            # publish the drain's predicted work horizon: submits racing
            # this drain see it as in-flight backlog (the queue itself
            # was swapped empty above)
            mb = self.config.max_batch
            now0 = time.perf_counter()
            horizon = 0.0
            for (family, bucket), idxs in order:
                if family == "empty":
                    continue
                if family == "scalar":
                    horizon += len(idxs) * self.predictor.scalar_s()
                else:
                    Bg = batch_size_bucket(min(len(idxs), mb), mb)
                    horizon += (-(-len(idxs) // mb)) * self.predictor.batch_s(
                        family, Bg, bucket)
            self._inflight_until = now0 + horizon

            # EDF group splitting (§17): when a tail ticket's budget
            # cannot survive its whole group, peel an urgent sub-batch
            # off at a smaller B-bucket — bounded by split_budget extra
            # dispatches per drain
            units: list[tuple[tuple, list[int]]] = []
            splits_left = self.config.split_budget
            t_acc = 0.0
            for (family, bucket), idxs in order:
                split = None
                if family not in ("empty", "scalar") and splits_left > 0:
                    split = self._split_urgent(pending, idxs, family,
                                               bucket, t_acc, now0)
                if split is not None:
                    urgent, rest = split
                    splits_left -= 1
                    self.metrics.inc("serve.admission.split")
                    with self._stats_lock:
                        if "admission" in self.stats:
                            self.stats["admission"]["splits"] += 1
                    units.append(((family, bucket), urgent))
                    units.append(((family, bucket), rest))
                else:
                    units.append(((family, bucket), idxs))
                if family == "scalar":
                    t_acc += len(idxs) * self.predictor.scalar_s()
                elif family != "empty":
                    Bg = batch_size_bucket(min(len(idxs), mb), mb)
                    t_acc += (-(-len(idxs) // mb)) * self.predictor.batch_s(
                        family, Bg, bucket)

            for (family, bucket), idxs in units:
                if family == "empty":
                    now = time.perf_counter()
                    for i in idxs:
                        self._resolve(
                            pending[i], plans[i], slots, i,
                            ExecResult(results=empty_results(), latency_s=0.0,
                                       bucket=0, batch_size=1, started_at=now,
                                       finished_at=now),
                            plan_s[i],
                        )
                    continue
                queries = [pending[i].lemma_ids for i in idxs]
                ids = ([pending[i].request_id for i in idxs]
                       if self.tracer.enabled else None)
                if family == "scalar":
                    execs = self.scalar.execute(index, queries,
                                                [None] * len(idxs),
                                                step_family=None, bucket=None,
                                                request_ids=ids)
                else:
                    sels = [self._selection_for(plans[i], family) for i in idxs]
                    shared = [plans[i].route != family for i in idxs]
                    # one payload per (family, bucket) group: all its
                    # plans were routed under the same cost-model state
                    execs = self.compiled.execute(index, queries, sels,
                                                  step_family=family,
                                                  bucket=bucket, shared=shared,
                                                  payload=plans[idxs[0]].payload,
                                                  request_ids=ids)
                    if bucket in self.stats["bucket_hist"]:
                        mb = self.config.max_batch
                        with self._stats_lock:
                            self.stats["bucket_hist"][bucket] += (
                                -(-len(idxs) // mb)
                            )
                for i, ex in zip(idxs, execs):
                    self._resolve(pending[i], plans[i], slots, i, ex,
                                  plan_s[i])
        self._inflight_until = 0.0
        self._finish_stats(plans)
        return slots

    def _drop_expired(self, pending: list) -> list:
        """Shed requests whose deadline has already passed before any
        batch work starts (§17, admission engines only): serving an
        expired request is a *guaranteed* miss that still costs a full
        batch slot, so it is resolved as shed here and its slot goes to
        traffic that can still meet its budget. This is the burst-onset
        backstop — the latch and the margin judge predictions at
        submit, but a flood arriving inside one drain window can outrun
        any decision made at its front. Returns the still-live tickets;
        expired ones resolve via their ticket (they are not in the
        drain's return list)."""
        now = time.perf_counter()
        live, expired = [], []
        for t in pending:
            if (t.deadline_s is not None
                    and t.arrival + t.deadline_s < now):
                expired.append(t)
            else:
                live.append(t)
        for t in expired:
            self.metrics.inc("serve.admission.expired")
            with self._stats_lock:
                self.stats["admission"]["expired"] += 1
            with self.tracer.span("admission.expired", request=t.request_id):
                self._resolve_unserved(t, t.plan, STATUS_SHED)
        return live

    def _split_urgent(self, pending, idxs, family: str, bucket: int,
                      t_acc: float, now: float):
        """EDF group splitting (§17): does some deadline-carrying tail
        of this group miss its budget if served with the whole group,
        but survive a small urgent sub-batch at a cheaper B-bucket?

        Returns ``(urgent_idxs, rest_idxs)`` or None. ``t_acc`` is the
        predicted time already committed to earlier EDF groups this
        drain. The urgent sub-batch must be *strictly* cheaper than the
        full-group chunk — padding both to the same B-bucket, or
        splitting onto a cold shape (whose prediction carries the AOT
        compile penalty), makes splitting pure overhead and is refused
        here."""
        cfg = self.config
        mb = cfg.max_batch
        B_full = batch_size_bucket(min(len(idxs), mb), mb)
        chunk_s = self.predictor.batch_s(family, B_full, bucket,
                                         strict_warm=True)
        urgent = []
        for pos, i in enumerate(idxs):
            t = pending[i]
            if t.deadline_s is None:
                continue
            remaining = t.arrival + t.deadline_s - now
            # the chunk this request rides finishes after all earlier
            # chunks of the group
            finish = t_acc + (pos // mb + 1) * chunk_s
            if remaining < finish:
                urgent.append(i)
        if not urgent or len(urgent) >= len(idxs):
            return None
        urgent.sort(key=lambda i: pending[i].arrival + pending[i].deadline_s)
        urgent = urgent[:cfg.split_max_urgent]
        B_u = batch_size_bucket(min(len(urgent), mb), mb)
        if self.predictor.batch_s(family, B_u, bucket,
                                  strict_warm=True) >= chunk_s:
            return None
        urgent_set = set(urgent)
        rest = [i for i in idxs if i not in urgent_set]
        return urgent, rest

    @staticmethod
    def _selection_for(p: QueryPlan, family: str):
        """Packer-ready key selection: a qt34 plan riding the qt5 step
        becomes a zero-stop qt5 plan (anchor, others, (), counts)."""
        if p.route == _planner.ROUTE_QT34 and family == _planner.ROUTE_QT5:
            anchor, others, counts = p.selection
            return anchor, others, (), counts
        return p.selection

    def _resolve(self, ticket, p: QueryPlan, slots, i, ex: ExecResult,
                 plan_dt: float = 0.0) -> None:
        # deadline and queue wait are judged against *this request's
        # batch* (its ExecResult timestamps), not the whole group — in a
        # multi-chunk group, earlier chunks resolve earlier
        queue_wait = max(ex.started_at - ticket.arrival, 0.0)
        # the per-request phase breakdown (§15): queue + plan + the
        # batch phases. The batch phases tile [started_at, finished_at];
        # the request's own planning ran inside [arrival, started_at],
        # so queue is that window less plan, and the values sum to the
        # end-to-end latency
        phases = {"queue": max(queue_wait - plan_dt, 0.0), "plan": plan_dt}
        phases.update(ex.phases if ex.phases else zero_phases())
        met = None
        blame = None
        e2e = ex.finished_at - ticket.arrival
        if ticket.deadline_s is not None:
            met = e2e <= ticket.deadline_s
            if not met:
                # name the phase that blew the budget: queue when
                # waiting alone exceeded it, else the slowest work phase
                if queue_wait > ticket.deadline_s:
                    blame = "queue"
                else:
                    blame = max(
                        (ph for ph in phases if ph != "queue"),
                        key=lambda ph: phases[ph],
                    )
            with self._stats_lock:
                dl = self.stats["deadlines"]
                dl["met" if met else "missed"] += 1
                if blame is not None:
                    dl["miss_blame"][blame] = (
                        dl["miss_blame"].get(blame, 0) + 1
                    )
        else:
            with self._stats_lock:
                self.stats["deadlines"]["unset"] += 1
        m = self.metrics
        for name, dur in phases.items():
            m.observe(f"serve.phase.{name}", dur * 1e6)
        if blame is not None:
            m.inc(f"serve.deadline.miss_blame.{blame}")
        # §19 feedback loops: realized predicted-vs-actual completion
        # error for the adaptive reserve, and served result counts for
        # the recall-cost model that orders degrade candidates
        if (self.admission is not None and ticket.verdict is not None
                and ticket.verdict.admitted):
            self.admission.observe_completion(
                ticket.verdict.predicted_e2e_s, e2e)
        if self.recall_costs is not None and p.is_compiled:
            n_res = int(ex.results["doc"].size) if ex.results else 0
            if p.degraded:
                self.recall_costs.observe_degraded(p.step_family,
                                                   p.bucket, n_res)
            else:
                self.recall_costs.observe_full(p.step_family, n_res)
        executed = p if ex.payload in (None, p.payload) \
            else dataclasses.replace(p, payload=ex.payload)
        resp = SearchResponse(
            results=ex.results, latency_s=ex.latency_s, bucket=ex.bucket,
            batch_size=ex.batch_size, path=_route_to_path(p.route),
            plan=executed, deadline_met=met, queue_wait_s=queue_wait,
            phases=phases, started_at=ex.started_at,
            finished_at=ex.finished_at, deadline_blame=blame,
            status=STATUS_DEGRADED if p is not None and p.degraded
            else STATUS_OK, request_id=ticket.request_id,
            batch_span=ex.batch_span,
        )
        ticket.response = resp
        slots[i] = resp

    def _finish_stats(self, plans: list[QueryPlan]) -> None:
        ex = self.compiled
        est_vs_measured = ex.est_vs_measured(_planner._streams)
        pack_stats = (self.pack_cache.stats
                      if self.pack_cache is not None else None)
        comp_stats = (self.compressed_cache.stats
                      if self.compressed_cache is not None else None)
        with self._stats_lock:
            st = self.stats
            st["requests"] += len(plans)
            routes = st["plans"]["routes"]
            for p in plans:
                routes[p.route] = routes.get(p.route, 0) + 1
                st["paths"][_route_to_path(p.route)] += 1
                if p.fallback_reason is not None:
                    fb = st["plans"]["fallbacks"]
                    fb[p.fallback_reason] = fb.get(p.fallback_reason, 0) + 1
            st["batches"] = ex.stats["batches"]
            st["compressed_batches"] = ex.stats["compressed_batches"]
            st["offset_fallbacks"] = ex.stats["offset_fallbacks"]
            st["plans"]["executables"] = ex.n_executables
            st["plans"]["shared_batches"] = ex.stats["shared_batches"]
            st["plans"]["est_vs_measured"] = est_vs_measured
            if self.payload_costs is not None:
                st["plans"]["payload_costs"] = self.payload_costs.table()
            if pack_stats is not None:
                st["pack_cache"] = pack_stats
            if comp_stats is not None:
                st["compressed_cache"] = comp_stats
            if self.admission is not None:
                st["admission"]["margin"] = self.admission.margin_stats()
            if self.recall_costs is not None:
                st["admission"]["recall"] = self.recall_costs.table()

    # -- observability (DESIGN.md §15) -------------------------------------
    def stats_snapshot(self) -> dict:
        """A deep, consistent copy of :attr:`stats`, with the cache
        stats re-read fresh. ``stats`` itself is mutated in place during
        :meth:`drain` — a concurrent reader iterating it can see
        half-updated counters (or hit a dict-size-changed error); this
        snapshot is taken under the same lock the mutators hold, so the
        counters in one snapshot are mutually consistent. Benchmarks and
        examples read this, never ``stats`` directly. ``tracer`` reports
        the span ring's capacity and the spans it ``dropped``."""
        with self._stats_lock:
            snap = copy.deepcopy(self.stats)
        # cache stats properties already return fresh dicts under the
        # cache's own lock; re-read them so the snapshot is current even
        # between drains
        if self.pack_cache is not None:
            snap["pack_cache"] = self.pack_cache.stats
        if self.compressed_cache is not None:
            snap["compressed_cache"] = self.compressed_cache.stats
        if self.admission is not None:
            snap["admission"]["margin"] = self.admission.margin_stats()
        if self.recall_costs is not None:
            snap["admission"]["recall"] = self.recall_costs.table()
        snap["tracer"] = {"capacity": self.tracer.capacity,
                          "dropped": self.tracer.dropped}
        return snap

    def metrics_snapshot(self, prefix: str = "") -> dict:
        """Plain-data snapshot of the metrics registry (counters,
        gauges, histogram percentiles) — ``prefix`` filters by dotted
        name (``"serve.phase."`` for the request phase breakdown)."""
        return self.metrics.snapshot(prefix)

    def trace_snapshot(self) -> dict:
        """The recorded span buffer as a Chrome JSON trace object —
        ``json.dump`` it and load the file in https://ui.perfetto.dev
        One span tree per drain:
        ``drain`` → ``plan`` / ``group`` / per-batch ``batch`` →
        ``pack``/``compress``/``compile``/``dispatch``/``execute``/
        ``decode``, with ``h2d`` and ``derive`` under ``pack``; each
        event's args carry its ``id`` and ``parent``, a batch's the
        ``requests`` it served."""
        return chrome_trace(self.tracer.snapshot())

    def write_trace(self, path: str) -> dict:
        """Write :meth:`trace_snapshot` to ``path``; returns the trace
        object (callers report event counts)."""
        return write_chrome_trace(path, self.tracer.snapshot())
