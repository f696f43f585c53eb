"""Executors: the device/scalar execution layer of the serving tier
(DESIGN.md §14), instrumented per phase (DESIGN.md §15).

Two implementations of one :class:`Executor` protocol sit below the
:class:`repro_torch.serving.service.SearchService` facade:

* :class:`CompiledExecutor` owns the serve-step factories and the
  per-(step kind, B, L) **executable table** — every distinct step shape
  ever executed, the denominator of the response-time guarantee. It
  implements dispatch-aware batching: a ``qt34`` group whose plan fits
  the QT5 step's non-stop slots is packed with zero stop constraints and
  served on the ``qt5`` step of the same (B, L) — ``qt5_join`` with zero
  stop constraints *is* ``qt34_join``.
* :class:`ScalarExecutor` wraps the scalar
  :class:`repro_torch.core.search.ProximitySearchEngine` — the
  correctness backstop every ``scalar``-route plan of the dispatch
  matrix falls back to (routing affects latency, never results).

Observability contract (§15): both executors record into the service's
shared :class:`repro_torch.obs.MetricsRegistry` and
:class:`repro_torch.obs.Tracer`. Every batch emits a span tree
(``batch`` → ``pack`` / ``compress`` / ``compile`` / ``dispatch`` /
``execute`` / ``decode``; the host-to-device copy is an ``h2d`` span
inside ``pack``, or inside ``compress`` on the cache-less compressed
path, with its ``bytes``, and the row cache's misses ``derive`` spans
inside ``pack``); a ``batch`` span lists the ``requests`` it serves
and every :class:`ExecResult` names that span (``batch_span``) and carries the same
timings as a ``phases`` dict whose values tile ``[started_at,
finished_at]`` exactly — the service adds queue/plan on top, which is how
a response's phase breakdown sums to its end-to-end latency. PyTorch runs
eagerly, so there is no ahead-of-time compile: the first execution of a
(kind, B, L) triple runs the step once as a warm-up (kernel build and
load, allocator growth, first-launch costs), timed as the ``compile``
phase, and fills its ``cost_summaries`` entry: the cost pass
(:mod:`repro_torch.obs.cost`) over one call of the step on ``meta``
tensors of the batch's shapes, on the host, never on the card and never
on a warm call. Later calls skip it, so
the ``serve.step.<family>.B<B>.L<L>`` histograms measure run time only.
On a card the ``execute`` phase ends with ``torch.cuda.synchronize`` on
every device of the mesh; while the tracer is enabled, CUDA events on
each device's current stream just before and after the step's launches
give the device time of one warm step in ``step_event_every``, the
longest over the mesh, in the ``serve.step_device.<family>.B<B>.L<L>``
histograms (µs): the stream's span from the step's first operation to
its last, launch gaps included. Recording and reading the events costs
the host ~0.1 ms a batch, so the histograms hold a sample. The copy's host time streams into ``serve.h2d.<family>``
(µs) and its bytes into the ``serve.h2d.bytes`` counter.

The executor serves over a device mesh (``repro_torch.launch.mesh``):
on a one-device mesh a batch's host arrays go to that device whole
(``LocalStep.place``); on a (D, S) mesh each shard's block goes from the
host straight to its own device (``ShardedStep.place``), as part of the
``pack`` (or ``compress``) phase.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Protocol

import numpy as np
import torch

from repro_torch.core.torch_search import (
    ShardedStep,
    assemble_qt1_compressed,
    assemble_qt2_compressed,
    assemble_qt34_compressed,
    assemble_qt5_compressed,
    batch_size_bucket,
    compress_qt1_batch,
    compress_qt2_batch,
    compress_qt34_batch,
    compress_qt5_batch,
    decode_results,
    make_qt1_serve_step,
    make_qt1_serve_step_compressed,
    make_wv_serve_step,
    pack_qt1_batch,
    pack_qt2_batch,
    pack_qt34_batch,
    pack_qt5_batch,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.obs.cost import count, to_meta
from repro_torch.serving.planner import (
    PAYLOAD_DELTA16,
    PAYLOAD_OFFSETS,
    PAYLOAD_RAW,
    delta16_aligned,
)

# the batch-level phases every ExecResult reports; the service prepends
# "queue" and "plan" (tests assert this exact vocabulary)
BATCH_PHASES = ("pack", "compress", "compile", "dispatch", "execute", "decode")


def zero_phases() -> dict:
    return {p: 0.0 for p in BATCH_PHASES}


@dataclass
class ExecResult:
    """Per-request execution record: the decoded results plus the
    executed shape — ``payload`` is the format actually served (a
    planner delta16 prediction downgrades to offsets when a key's
    in-block span overflows uint16), ``latency_s`` the wall-clock of the
    whole batch the request rode in, ``started_at``/``finished_at`` the
    perf_counter timestamps of *that batch* (not the whole group: the
    service derives queue waits and deadline verdicts per batch), and
    ``phases`` the batch's per-phase durations in seconds — contiguous
    sub-intervals tiling [started_at, finished_at]; ``batch_span`` the
    id of the tracer's ``batch`` span that served it (0 without one)."""

    results: dict
    latency_s: float
    bucket: int
    batch_size: int
    payload: str | None = None
    started_at: float = 0.0
    finished_at: float = 0.0
    phases: dict = field(default_factory=zero_phases)
    batch_span: int = 0


class Executor(Protocol):
    """One (route, bucket) group of requests in, one ExecResult per
    request out, aligned with the inputs."""

    def execute(self, index, queries: list, selections: list, *,
                step_family: str | None, bucket: int | None,
                shared: list | None = None,
                request_ids: list | None = None) -> list[ExecResult]: ...


# kind suffix -> planner payload name
_PAYLOAD_OF_KIND = {"base": PAYLOAD_RAW, "raw": PAYLOAD_RAW,
                    "delta": PAYLOAD_DELTA16, "offsets": PAYLOAD_OFFSETS}


def _payload_of_kind(kind: str) -> str:
    return _PAYLOAD_OF_KIND[kind.rsplit("_", 1)[-1] if "_" in kind else kind]


def _record_events(devices, events) -> None:
    """Record each card's timing event on that card's current stream."""
    for device, ev in zip(devices, events):
        ev.record(torch.cuda.current_stream(device))


def _sync(devices) -> None:
    """Wait for the devices to finish queued work; a no-op on the CPU,
    where every op has finished when it returns."""
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _cost_summary(step, placed) -> dict:
    """The cost pass's ``{"flops", "bytes_accessed", "transcendentals"}``
    of one call of ``step`` (a ``LocalStep`` or ``ShardedStep``) on
    ``meta`` tensors shaped like the placed batch: a sharded step runs
    over a mesh of ``meta`` entries of its grid's shape."""
    if isinstance(step, ShardedStep):
        mesh = make_mesh(step.grid.shape, ("data", "model"), devices=["meta"] * step.grid.size)
        step = ShardedStep(step.local, step.specs, mesh, step.top_k)
    _, cost = count(step.run, to_meta(placed))
    return cost.summary()


class CompiledExecutor:
    """Packs, compresses and executes padded batches on the per-(step
    kind, B-bucket, L-bucket) serve steps, over one device mesh (a
    (1, 1) mesh is one device; ``device`` is the mesh's first).

    ``executables`` maps every (kind, B, L) triple ever executed to its
    batch count — the engine-stats surface tests assert B-bucket
    sharing on; ``stats["shared_batches"]`` counts qt34 groups served
    on qt5 steps. ``compile_times`` holds the first-call warm-up
    wall-clock per triple, ``cost_summaries`` each one's counted
    ``{"flops", "bytes_accessed", "transcendentals"}`` (the reference's
    ``xla_cost_summary`` keys; its ``optimal_seconds`` has no
    counterpart); measured run times stream into the
    metrics registry as ``serve.step.<family>.B<B>.L<L>`` histograms
    (µs)."""

    # one warm step in this many is timed by CUDA events (tracer on, card)
    step_event_every = 16

    def __init__(self, mesh, config, pack_cache=None, compressed_cache=None,
                 metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None, costs=None):
        self.mesh = mesh
        self.device = mesh.devices.flat[0]
        self._devices = mesh.unique_devices()
        self._cards = [d for d in self._devices if d.type == "cuda"]
        # a warm step's (start, end) timing events on each card, reused:
        # each batch reads them after its synchronise, before the next
        self._step_events = None
        self._warm_steps = 0  # warm steps while the events could time them
        self.config = config
        self.pack_cache = pack_cache
        self.compressed_cache = compressed_cache
        # optional PayloadCostModel (owned by the service): warm batch
        # times stream into it per (family, bucket, payload arm), and
        # the planner consults it for the group's payload choice
        self.costs = costs
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        # one step per step kind; shapes are fixed per call, and
        # batch_size_bucket bounds how many each one ever sees
        self._steps: dict[str, object] = {}
        self.executables: dict[tuple, int] = {}
        # (kind, B, L) triples whose warm-up has run
        self._warm: set[tuple] = set()
        self.compile_times: dict[tuple, float] = {}
        self.cost_summaries: dict[tuple, dict | None] = {}
        # (family, B, L) triples with measured run-time histograms
        self.measured_keys: set[tuple] = set()
        self.stats = {"batches": 0, "compressed_batches": 0,
                      "offset_fallbacks": 0, "shared_batches": 0,
                      "compiles": 0}
        # delta-format eligibility on the cache-less compressed path is
        # static per (family, bucket) and goes sticky-False after a
        # uint16 span overflow so persistent-overflow corpora don't pay
        # a failed delta encoding per batch (with the compressed cache
        # the verdict is per key instead)
        self._delta_ok: dict[tuple, bool] = {}

    @property
    def n_executables(self) -> int:
        return len(self.executables)

    def _step(self, kind: str, max_distance: int):
        step = self._steps.get(kind)
        if step is None:
            cfg = self.config
            if kind == "base":
                step = make_qt1_serve_step(top_k=cfg.top_k, mesh=self.mesh)
            elif kind in ("delta", "offsets"):
                step = make_qt1_serve_step_compressed(
                    top_k=cfg.top_k, delta_g=(kind == "delta"),
                    mesh=self.mesh)
            else:  # "qt2_raw" ... "qt5_offsets"
                qtype, payload = kind.split("_", 1)
                step = make_wv_serve_step(
                    qtype, top_k=cfg.top_k, payload=payload,
                    max_distance=max_distance, r_max=cfg.r_max,
                    mesh=self.mesh,
                )
            self._steps[kind] = step
        return step

    def _family_fns(self, family: str):
        """(assemble_fn, pack_fn, compress_fn, kind prefix, K kwargs)
        for one step family — the only place the four families differ."""
        cfg = self.config
        if family == "qt1":
            return (assemble_qt1_compressed, pack_qt1_batch,
                    compress_qt1_batch, "", {"K": cfg.k_fst})
        if family == "qt2":
            return (assemble_qt2_compressed, pack_qt2_batch,
                    compress_qt2_batch, "qt2_", {"K": cfg.k_wv})
        if family == "qt34":
            return (assemble_qt34_compressed, pack_qt34_batch,
                    compress_qt34_batch, "qt34_", {"Kn": cfg.k_ord})
        return (assemble_qt5_compressed, pack_qt5_batch,
                compress_qt5_batch, "qt5_", {"Kn": cfg.k_ns, "Ks": cfg.k_st})

    def execute(self, index, queries, selections, *, step_family, bucket,
                shared=None, payload=None, request_ids=None):
        """Serve one (step family, L-bucket) group: chunked to
        ``config.max_batch``, each chunk padded to the power-of-two
        batch ladder and executed on the (kind, B, L) step.
        ``shared`` (aligned with ``queries``) flags requests riding a
        foreign step family — qt34 plans converted to zero-stop qt5
        plans by the caller; a batch containing any counts as shared.
        ``payload`` is the group's planner-chosen format: ``raw`` on a
        compressed engine forces the raw pack path (the cost model's
        raw arm); None keeps the config-static behavior.
        ``request_ids`` (aligned with ``queries``) are listed on each
        batch span while the tracer is enabled."""
        cfg = self.config
        out: list[ExecResult] = []
        for lo in range(0, len(queries), cfg.max_batch):
            chunk_q = queries[lo:lo + cfg.max_batch]
            chunk_s = selections[lo:lo + cfg.max_batch]
            B_pad = batch_size_bucket(len(chunk_q), cfg.max_batch)
            pad = B_pad - len(chunk_q)
            traced = self.tracer.enabled
            ids = ({"requests": request_ids[lo:lo + cfg.max_batch]}
                   if traced and request_ids is not None else {})
            with self.tracer.span("batch", family=step_family, bucket=bucket,
                                  B=B_pad, n=len(chunk_q), **ids) as bsp:
                t0 = time.perf_counter()
                kind, stub, args, t_pack, t_comp = self._prepare(
                    index, step_family, bucket,
                    chunk_q + [[]] * pad, chunk_s + [None] * pad, t0,
                    payload=payload,
                )
                key = (kind, B_pad, bucket)
                step = self._step(kind, index.max_distance)
                first = self._warm_up(key, kind, step, args)
                timed = bool(traced and not first and self._cards)
                if timed:
                    timed = self._warm_steps % self.step_event_every == 0
                    self._warm_steps += 1
                if timed and self._step_events is None:
                    self._step_events = tuple(
                        [torch.cuda.Event(enable_timing=True) for _ in self._cards]
                        for _ in range(2))
                t_compile = time.perf_counter()
                with self.tracer.span("dispatch", kind=kind):
                    if timed:
                        starts, ends = self._step_events
                        _record_events(self._cards, starts)
                    raw = step.run(args)
                    if timed:
                        _record_events(self._cards, ends)
                t_disp = time.perf_counter()
                with self.tracer.span("execute", kind=kind, compile=first):
                    _sync(self._devices)
                t_exec = time.perf_counter()
                with self.tracer.span("decode"):
                    decoded = decode_results(stub, *raw)
                t1 = time.perf_counter()
                bsp.set(kind=kind, compile=first)
            phases = {
                "pack": t_pack - t0,
                "compress": t_comp - t_pack,
                "compile": t_compile - t_comp,
                "dispatch": t_disp - t_compile,
                "execute": t_exec - t_disp,
                "decode": t1 - t_exec,
            }
            self.stats["batches"] += 1
            if shared is not None and any(shared[lo:lo + cfg.max_batch]):
                self.stats["shared_batches"] += 1
            self.executables[key] = self.executables.get(key, 0) + 1
            if not first:
                # measured step cost = dispatch + device execute, run-only
                self.metrics.observe(
                    f"serve.step.{step_family}.B{B_pad}.L{bucket}",
                    (t_exec - t_compile) * 1e6,
                )
                if timed:
                    # the step's device time: the longest stream span
                    # over the mesh's cards (the events completed by the
                    # execute phase's synchronise)
                    self.metrics.observe(
                        f"serve.step_device.{step_family}.B{B_pad}.L{bucket}",
                        max(s.elapsed_time(e) for s, e in zip(starts, ends)) * 1e3,
                    )
                # whole warm batch wall-clock (host pack/compress/decode
                # included, warm-up excluded): what one more batch of the shape
                # actually costs the serving loop — the admission
                # predictor's primitive
                self.metrics.observe(
                    f"serve.batch.{step_family}.B{B_pad}.L{bucket}",
                    ((t1 - t0) - phases["compile"]) * 1e6,
                )
                self.measured_keys.add((step_family, B_pad, bucket))
                if self.costs is not None:
                    # payload arbitration sees the whole warm batch cost
                    # (pack/compress/decode included — host encode work
                    # counts against the arm that incurs it), per padded
                    # query; warm-up is excluded like the step metric
                    warm_s = (t1 - t0) - phases["compile"]
                    self.costs.observe(step_family, bucket,
                                       _payload_of_kind(kind),
                                       warm_s * 1e6 / B_pad)
            payload = _payload_of_kind(kind)
            out.extend(
                ExecResult(results=decoded[bi], latency_s=t1 - t0,
                           bucket=bucket, batch_size=len(chunk_q),
                           payload=payload, started_at=t0, finished_at=t1,
                           phases=dict(phases), batch_span=bsp.id)
                for bi in range(len(chunk_q))
            )
        return out

    # -- warm-up-vs-run split ----------------------------------------------
    def _warm_up(self, key, kind, step, args) -> bool:
        """First call per (kind, B, L) triple: run the step once and wait
        for it, then count it on ``meta`` (the ``compile`` phase: kernel
        build and load, allocator growth, first-launch costs, the cost
        count). Returns whether this was that call; later calls return
        False at once, so their step timings are pure run."""
        if key in self._warm:
            return False
        with self.tracer.span("compile", kind=kind, B=key[1], L=key[2]):
            t0 = time.perf_counter()
            step.run(args)
            _sync(self._devices)
            self.cost_summaries[key] = _cost_summary(step, args)
            dt = time.perf_counter() - t0
        self._warm.add(key)
        self.compile_times[key] = dt
        self.stats["compiles"] += 1
        self.metrics.observe(
            f"serve.compile.{kind}.B{key[1]}.L{key[2]}", dt * 1e6)
        return True

    # -- measured-cost surface ---------------------------------------------
    def measured_step_us(self, family: str, B: int, L: int) -> float | None:
        """Measured warm batch run time (p50 µs) for one (family, B, L)
        shape — the admission controller's prediction primitive
        (DESIGN.md §17). Falls back from the exact shape to the nearest
        measured shape of the family scaled by the slot ratio
        ``(B*L) / (B'*L')`` (step work is linear in both axes); None
        when the family has no measurement at all (the caller then uses
        the unit estimate)."""
        return self._nearest_p50("serve.step", family, B, L)

    def measured_batch_us(self, family: str, B: int, L: int) -> float | None:
        """Measured warm *whole-batch* wall-clock (p50 µs, host pack and
        decode included, warm-up excluded) for one (family, B, L) shape —
        what one more batch of the shape costs the serving loop. Same
        nearest-shape fallback as :meth:`measured_step_us`."""
        return self._nearest_p50("serve.batch", family, B, L)

    def _nearest_p50(self, metric: str, family: str, B: int,
                     L: int) -> float | None:
        hist = self.metrics.get(f"{metric}.{family}.B{B}.L{L}")
        if hist is not None and hist.count:
            return hist.percentile(50)
        best = None
        for (fam, Bm, Lm) in self.measured_keys:
            if fam != family:
                continue
            h = self.metrics.get(f"{metric}.{fam}.B{Bm}.L{Lm}")
            if h is None or not h.count:
                continue
            # prefer the measured shape closest in slot count
            dist = abs(Bm * Lm - B * L)
            if best is None or dist < best[0]:
                best = (dist, h.percentile(50) * (B * L) / (Bm * Lm))
        return best[1] if best is not None else None

    def is_warm(self, family: str, B: int, L: int) -> bool:
        """Whether some step of the family already ran its warm-up at
        (B, L) — a batch routed to a cold shape pays the warm-up, which
        admission prediction must price in."""
        return any(kb == B and kl == L and _kind_family(kind) == family
                   for (kind, kb, kl) in self._warm)

    def family_warm(self, family: str, L: int) -> bool:
        """Whether the family has *any* warm B at this L-bucket. The
        admission predictor amortizes the warm-up penalty once this
        holds (a new B-bucket of an already-serving (family, L) pays one
        warm-up over the service lifetime)."""
        return any(kl == L and _kind_family(kind) == family
                   for (kind, _kb, kl) in self._warm)

    def compile_penalty_s(self) -> float:
        """Predicted first-call warm-up cost for a cold (kind, B, L)
        shape: the mean of the observed warm-up times (0.0 before any
        has run)."""
        if not self.compile_times:
            return 0.0
        return sum(self.compile_times.values()) / len(self.compile_times)

    def measured_scalar_us(self) -> float | None:
        """Measured per-request p50 of the scalar backstop engine."""
        hist = self.metrics.get("serve.step.scalar")
        if hist is not None and hist.count:
            return hist.percentile(50)
        return None

    def measured_cost(self, family: str, bucket: int) -> dict:
        """Measured run-time percentiles for every B-bucket of one
        (step_family, L-bucket) step, plus its warm-up time — the
        calibration table for ``est_step_cost`` (µs; empty until a
        second batch of the shape has run)."""
        out = {}
        for (fam, B, L) in sorted(self.measured_keys):
            if fam != family or L != bucket:
                continue
            hist = self.metrics.get(f"serve.step.{fam}.B{B}.L{L}")
            if hist is None or hist.count == 0:
                continue
            snap = hist.snapshot()
            entry = {"measured_p50_us": snap["p50"],
                     "measured_p95_us": snap["p95"],
                     "measured_p99_us": snap["p99"],
                     "count": snap["count"]}
            for (kind, kb, kl), dt in self.compile_times.items():
                if kb == B and kl == L and _kind_family(kind) == fam:
                    entry["compile_us"] = dt * 1e6
                    cost = self.cost_summaries.get((kind, kb, kl))
                    if cost:
                        entry["cost"] = cost
                    break
            out[f"B{B}"] = entry
        return out

    def est_vs_measured(self, streams_of) -> dict:
        """est_step_cost calibration: per measured (family, B, L), the
        planner's estimate (padded posting slots) against the measured
        run-time p50 — ``us_per_kslot`` is the live conversion factor
        admission control needs to turn an estimate into a time budget."""
        cfg = self.config
        out = {}
        for (fam, B, L) in sorted(self.measured_keys):
            hist = self.metrics.get(f"serve.step.{fam}.B{B}.L{L}")
            if hist is None or hist.count == 0:
                continue
            est = streams_of(fam, cfg) * L * cfg.doc_shards
            p50 = hist.percentile(50)
            out[f"{fam}/B{B}/L{L}"] = {
                "est_step_cost": est,
                "measured_p50_us": p50,
                "n": hist.count,
                "us_per_kslot": p50 / (est / 1000.0),
            }
        return out

    # -- batch preparation --------------------------------------------------
    def _place(self, family: str, kind: str, args, max_distance: int):
        """A batch's host arrays on the mesh: whole on a one-device
        mesh, each shard's block on its own device otherwise. The copy
        from pageable memory holds the host until it is done, so its
        host time (``serve.h2d.<family>``, µs) is the copy's time."""
        nbytes = sum(a.nbytes for a in args if isinstance(a, np.ndarray))
        step = self._step(kind, max_distance)
        with self.tracer.span("h2d", bytes=nbytes):
            t0 = time.perf_counter()
            placed = step.place(args)
            dt = time.perf_counter() - t0
        self.metrics.observe(f"serve.h2d.{family}", dt * 1e6)
        self.metrics.inc("serve.h2d.bytes", nbytes)
        return placed

    def _prepare(self, index, family, bucket, queries, selections, t0,
                 payload=None):
        """Pack (and compress) one padded batch and move it to the mesh;
        returns ``(kind, decode stub, device args, t_pack_end,
        t_compress_end)`` so the caller can tile the phase timeline
        without gaps. ``payload=PAYLOAD_RAW`` forces the raw pack path
        even on a compressed engine — the cost model's raw arm; the raw
        and compressed steps of a family are bit-identical in results, so
        the choice only moves time."""
        assemble_fn, pack_fn, compress_fn, prefix, kw = self._family_fns(family)
        cfg = self.config
        ccache = self.compressed_cache
        serve_compressed = cfg.compressed and payload != PAYLOAD_RAW
        if serve_compressed and ccache is not None:
            # the per-key compressed-row cache derives raw + compressed
            # rows in one pass, so pack and compress are one phase here
            # (attributed to pack; compress reads 0)
            with self.tracer.span("pack", family=family, cached=True):
                kind, args, stub = assemble_fn(
                    index, queries, L=bucket, doc_shards=cfg.doc_shards,
                    ccache=ccache, cache=self.pack_cache, plans=selections,
                    **kw,
                )
                args = self._place(family, kind, args, index.max_distance)
            self._count_compressed(kind)
            t_pack = time.perf_counter()
            return kind, stub, args, t_pack, t_pack
        if not serve_compressed:
            kind = "base" if family == "qt1" else f"{family}_raw"
            with self.tracer.span("pack", family=family):
                batch = pack_fn(
                    index, queries, L=bucket, doc_shards=cfg.doc_shards,
                    cache=self.pack_cache, plans=selections, **kw,
                )
                # the host->device transfer of the packed rows belongs
                # to pack, not to whatever phase is timed next
                args = self._place(family, kind, batch.host_args(),
                                   index.max_distance)
            t_pack = time.perf_counter()
            return kind, batch, args, t_pack, t_pack
        with self.tracer.span("pack", family=family):
            batch = pack_fn(
                index, queries, L=bucket, doc_shards=cfg.doc_shards,
                cache=self.pack_cache, plans=selections, **kw,
            )
        t_pack = time.perf_counter()
        with self.tracer.span("compress", family=family):
            kind, args = self._compress_batch(bucket, batch, compress_fn,
                                              prefix)
            args = self._place(family, kind, args, index.max_distance)
        return kind, batch, args, t_pack, time.perf_counter()

    def _compress_batch(self, bucket, batch, compress_fn, prefix=""):
        """Cache-less compressed path: whole-batch re-encode with the
        per-(family, bucket) sticky delta verdict (the
        use_compressed_cache=False path, kept for benchmarking)."""
        ck = (prefix, bucket)
        ok = self._delta_ok.get(ck)
        if ok is None:
            ok = delta16_aligned(bucket, self.config)
            self._delta_ok[ck] = ok
        kind = "offsets"
        if ok:
            try:
                args = compress_fn(batch, delta_g=True)
                kind = "delta"
            except ValueError:  # in-block key span overflows uint16
                self._delta_ok[ck] = False
        if kind == "offsets":
            args = compress_fn(batch, delta_g=False)
        self._count_compressed(kind)
        return prefix + kind, args

    def _count_compressed(self, kind: str) -> None:
        self.stats["compressed_batches"] += 1
        if kind.endswith("offsets"):
            self.stats["offset_fallbacks"] += 1


def _kind_family(kind: str) -> str:
    """Step-kind -> step-family name ("base"/"delta"/"offsets" are the
    qt1 payload kinds; everything else is "<family>_<payload>")."""
    return kind.split("_", 1)[0] if "_" in kind else "qt1"


class ScalarExecutor:
    """The scalar correctness backstop: wraps a per-snapshot
    :class:`ProximitySearchEngine` behind the same Executor protocol —
    every dispatch-matrix shape the fixed-shape steps cannot express is
    served here, bit-identical to the reference the device paths are
    tested against. Responses carry the same timing surface as the
    device path (started_at/finished_at + a phase breakdown whose work
    all lands in ``execute``), so scalar-fallback traffic is first-class
    in deadline and phase accounting."""

    def __init__(self, config, metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        self.config = config
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self._engine = None  # rebuilt per snapshot on first use

    def _engine_for(self, index):
        from repro_torch.core.search import ProximitySearchEngine

        if self._engine is None or self._engine.index is not index:
            self._engine = ProximitySearchEngine(
                index, top_k=self.config.top_k, equalize_mode="bulk"
            )
        return self._engine

    def execute(self, index, queries, selections, *, step_family=None,
                bucket=None, shared=None, request_ids=None):
        eng = self._engine_for(index)
        out = []
        ids = ({"requests": request_ids}
               if self.tracer.enabled and request_ids is not None else {})
        with self.tracer.span("batch", family="scalar", n=len(queries),
                              **ids) as bsp:
            for q in queries:
                t0 = time.perf_counter()
                with self.tracer.span("execute", kind="scalar"):
                    res, _ = eng.search_ids(list(q))
                t1 = time.perf_counter()
                self.metrics.observe("serve.step.scalar", (t1 - t0) * 1e6)
                phases = zero_phases()
                phases["execute"] = t1 - t0
                out.append(ExecResult(
                    results={"doc": res.doc, "start": res.start,
                             "end": res.end, "score": res.score},
                    latency_s=t1 - t0, bucket=0, batch_size=1,
                    started_at=t0, finished_at=t1, phases=phases,
                    batch_span=bsp.id,
                ))
        return out


def empty_results() -> dict:
    """A zero-hit result set with freshly allocated arrays — callers
    may mutate their response in place, so empty responses must never
    share buffers."""
    return {"doc": np.zeros(0, np.int64), "start": np.zeros(0, np.int64),
            "end": np.zeros(0, np.int64), "score": np.zeros(0, np.float32)}
