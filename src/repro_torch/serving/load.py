"""Open-loop load harness for the deadline control loop (DESIGN.md §17).

A closed-loop load generator (submit a batch, drain, repeat — what
``serve_bench`` measures) can never overload the service: its arrival
rate adapts to the service's own speed, so the deadline met-rate it
reports says nothing about behaviour at a fixed *offered* rate. This
module drives :class:`repro_torch.serving.SearchService` **open-loop**:
arrivals follow a generated schedule (Poisson, or bursty MMPP-style
on/off) that does not slow down when the service falls behind, so queue
buildup, admission verdicts, shedding and EDF splitting are exercised
exactly as a deployment would exercise them.

No threads: the harness exploits ``submit(..., arrival=t)`` arrival
backdating. The replay loop submits every request whose scheduled
instant has passed and drains whatever is queued; when a drain overruns
the schedule, the requests that "arrived" during it are submitted with
their *scheduled* perf_counter stamps, so queue waits, deadline
verdicts and admission budgets all measure the open-loop reality rather
than the submit call's lateness.

Vocabulary:

* :func:`poisson_arrivals` / :func:`bursty_arrivals` — arrival-offset
  schedules (seconds from trace start, deterministic per seed);
* :func:`run_open_loop` — replay a schedule over a query mix (e.g.
  ``repro_torch.data.corpus.sample_mixed_queries``) against one service;
* :func:`run_closed_loop` — the adaptive baseline / capacity probe:
  submit-drain lockstep, reporting achieved QPS;
* :class:`LoadReport` — offered vs achieved QPS, met/shed/reject rates
  and per-phase latency percentiles, as plain data for benches.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from repro_torch.serving.admission import (
    STATUS_DEGRADED,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHED,
)

# statuses that were actually served by a drain (carry real results)
SERVED_STATUSES = (STATUS_OK, STATUS_DEGRADED)


def poisson_arrivals(qps: float, duration_s: float,
                     seed: int = 0) -> list[float]:
    """Offsets (seconds from trace start) of a Poisson arrival process
    at rate ``qps``, truncated to ``duration_s``. Deterministic per
    seed; i.i.d. exponential gaps."""
    if qps <= 0:
        raise ValueError(f"qps must be positive (got {qps})")
    rng = random.Random(seed)
    out, t = [], 0.0
    while True:
        t += rng.expovariate(qps)
        if t >= duration_s:
            return out
        out.append(t)


def bursty_arrivals(qps: float, duration_s: float, seed: int = 0,
                    burst_factor: float = 3.0, mean_on_s: float = 0.25,
                    mean_off_s: float = 0.75) -> list[float]:
    """Offsets of a two-state Markov-modulated (on/off) Poisson process
    with time-averaged rate ``qps``: exponential dwell times
    (``mean_on_s`` / ``mean_off_s``), arrival rate
    ``burst_factor × qps`` while *on* and whatever residual rate keeps
    the long-run average at ``qps`` while *off* (clamped at zero). The
    mean offered load matches the Poisson schedule at the same ``qps``;
    the bursts are what exercise hysteresis and shedding.

    The default factor keeps the off state *non-silent* (qps/3 here):
    the overload latch smooths backlog over admission decisions, so a
    completely silent off phase gives the controller nothing to decay
    its EWMA on and a stale latch greets the next burst — a degenerate
    trace, not a controller property worth benchmarking. With the
    default dwell split, ``burst_factor >= 4`` is exactly the silent
    regime (``qps_off = (1 - factor·0.25) / 0.75 × qps``)."""
    if qps <= 0:
        raise ValueError(f"qps must be positive (got {qps})")
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1 (got {burst_factor})")
    qps_on = qps * burst_factor
    # time-average: (qps_on*on + qps_off*off) / (on+off) == qps
    qps_off = max(
        0.0,
        (qps * (mean_on_s + mean_off_s) - qps_on * mean_on_s) / mean_off_s,
    )
    rng = random.Random(seed)
    out, t, on = [], 0.0, True
    while t < duration_s:
        dwell = rng.expovariate(1.0 / (mean_on_s if on else mean_off_s))
        end = min(t + dwell, duration_s)
        rate = qps_on if on else qps_off
        if rate > 0:
            tt = t
            while True:
                tt += rng.expovariate(rate)
                if tt >= end:
                    break
                out.append(tt)
        t, on = end, not on
    return out


def _pctl(values: list[float], q: float) -> float:
    """Nearest-rank percentile of a non-empty list (0 for empty)."""
    if not values:
        return 0.0
    vs = sorted(values)
    k = min(len(vs) - 1, max(0, int(round(q / 100.0 * (len(vs) - 1)))))
    return vs[k]


@dataclass
class LoadReport:
    """One load run as plain data (benches serialize this verbatim).

    ``met_rate`` is over *served* deadline-carrying requests (the SLO a
    controlled service advertises for what it accepts);
    ``met_rate_offered`` charges every shed/rejected request as a miss
    (the uncontrolled-comparable number — on a service without
    admission the two coincide). ``phase_us`` maps each serving phase
    to its {p50, p95} over served requests, in microseconds."""

    mode: str                      # "open" | "closed"
    process: str                   # "poisson" | "bursty" | "lockstep"
    offered_qps: float
    achieved_qps: float
    duration_s: float
    n_offered: int
    n_served: int
    n_ok: int
    n_degraded: int
    n_rejected: int
    n_shed: int
    met_rate: float
    met_rate_offered: float
    shed_rate: float
    reject_rate: float
    queue_wait_p50_us: float
    queue_wait_p95_us: float
    e2e_p50_us: float
    e2e_p95_us: float
    phase_us: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def build_report(tickets, *, mode: str, process: str, offered_qps: float,
                 duration_s: float) -> LoadReport:
    """Fold a run's resolved tickets into a :class:`LoadReport`. Every
    ticket must be resolved (the §17 contract: rejected/shed resolve at
    submit, the rest by the drains the runner issued)."""
    n = len(tickets)
    by_status = {STATUS_OK: 0, STATUS_DEGRADED: 0,
                 STATUS_REJECTED: 0, STATUS_SHED: 0}
    served_met = served_deadlined = 0
    offered_met = offered_deadlined = 0
    waits, e2es = [], []
    phases: dict[str, list[float]] = {}
    first = last = None
    for t in tickets:
        r = t.result()
        by_status[r.status] = by_status.get(r.status, 0) + 1
        if t.deadline_s is not None:
            offered_deadlined += 1
            if r.deadline_met:
                offered_met += 1
        if r.status in SERVED_STATUSES:
            if t.deadline_s is not None:
                served_deadlined += 1
                if r.deadline_met:
                    served_met += 1
            waits.append(r.queue_wait_s * 1e6)
            e2es.append(r.e2e_s * 1e6)
            for ph, dur in r.phases.items():
                phases.setdefault(ph, []).append(dur * 1e6)
            first = (t.arrival if first is None else min(first, t.arrival))
            last = (r.finished_at if last is None
                    else max(last, r.finished_at))
    n_served = by_status[STATUS_OK] + by_status[STATUS_DEGRADED]
    span = (last - first) if (first is not None and last is not None
                              and last > first) else duration_s
    return LoadReport(
        mode=mode, process=process, offered_qps=offered_qps,
        achieved_qps=(n_served / span if span > 0 else 0.0),
        duration_s=duration_s, n_offered=n, n_served=n_served,
        n_ok=by_status[STATUS_OK], n_degraded=by_status[STATUS_DEGRADED],
        n_rejected=by_status[STATUS_REJECTED], n_shed=by_status[STATUS_SHED],
        met_rate=(served_met / served_deadlined if served_deadlined else 1.0),
        met_rate_offered=(offered_met / offered_deadlined
                          if offered_deadlined else 1.0),
        shed_rate=(by_status[STATUS_SHED] / n if n else 0.0),
        reject_rate=(by_status[STATUS_REJECTED] / n if n else 0.0),
        queue_wait_p50_us=_pctl(waits, 50), queue_wait_p95_us=_pctl(waits, 95),
        e2e_p50_us=_pctl(e2es, 50), e2e_p95_us=_pctl(e2es, 95),
        phase_us={ph: {"p50": _pctl(vs, 50), "p95": _pctl(vs, 95)}
                  for ph, vs in sorted(phases.items())},
    )


def warm_service(service, queries) -> int:
    """Warm every (step family, B-bucket, L-bucket) executable the mix
    can route to: for each distinct compiled (family, bucket) group one
    representative query is served at every B of the batch ladder, so
    an open-loop run measures steady-state serving instead of
    first-call warm-ups (kernel build and load, allocator growth: a
    mid-trace warm-up stalls the drain and blows every deadline behind
    it — deployments warm shapes at startup for exactly this reason).
    Scalar/empty routes need no warming. Returns the number of
    (kind, B, L) steps warmed."""
    reps: dict[tuple, list] = {}
    for q in queries:
        p = service.explain(q)
        if p.is_compiled:
            reps.setdefault((p.step_family, p.bucket), q)
    mb = service.config.max_batch
    ladder, B = [], 1
    while B <= mb:
        ladder.append(B)
        B *= 2
    for q in reps.values():
        for B in ladder:
            for _ in range(B):
                service.submit(q)
            service.drain()
    return service.compiled.n_executables


def _deadline_for(deadline_s, i: int):
    """Per-request offered deadline: a float applies to every request, a
    sequence is cycled (mixed-SLO traffic), None disables."""
    if deadline_s is None or isinstance(deadline_s, (int, float)):
        return deadline_s
    return deadline_s[i % len(deadline_s)]


def run_open_loop(service, queries, arrivals, *, deadline_s=0.05,
                  process: str = "poisson", offered_qps: float | None = None,
                  idle_sleep_s: float = 0.0005) -> LoadReport:
    """Replay an arrival schedule open-loop against ``service``.

    ``queries`` (a list of lemma-id lists, cycled) is the query mix;
    ``arrivals`` the offset schedule (:func:`poisson_arrivals` /
    :func:`bursty_arrivals`). The loop submits every request whose
    scheduled instant has passed — backdated to that instant — then
    drains whatever queued; arrivals do **not** wait for the service.
    Returns the :class:`LoadReport`; every ticket is resolved on
    return (one final drain sweeps the stragglers)."""
    if not arrivals:
        raise ValueError("empty arrival schedule")
    if not queries:
        raise ValueError("empty query mix")
    duration = arrivals[-1]
    if offered_qps is None:
        offered_qps = len(arrivals) / duration if duration > 0 else 0.0
    tickets = []
    t0 = time.perf_counter()
    i, n = 0, len(arrivals)
    while i < n:
        now = time.perf_counter()
        due = False
        while i < n and t0 + arrivals[i] <= now:
            tickets.append(service.submit(
                queries[i % len(queries)],
                deadline_s=_deadline_for(deadline_s, i),
                arrival=t0 + arrivals[i],
            ))
            i += 1
            due = True
        if due and service._queue:
            service.drain()
        elif i < n:
            # ahead of schedule: yield until the next scheduled arrival
            time.sleep(min(idle_sleep_s,
                           max(0.0, t0 + arrivals[i] - time.perf_counter())))
    service.drain()
    return build_report(tickets, mode="open", process=process,
                        offered_qps=offered_qps, duration_s=duration)


def run_closed_loop(service, queries, n_requests: int, *, deadline_s=0.05,
                    batch: int = 1) -> LoadReport:
    """The adaptive baseline: submit ``batch`` requests, drain, repeat —
    arrival rate is whatever the service sustains, so queue buildup is
    impossible by construction. The report's ``achieved_qps`` is the
    service's capacity on this mix (load benches calibrate their
    open-loop offered rates against it)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1 (got {batch})")
    tickets = []
    t0 = time.perf_counter()
    i = 0
    while i < n_requests:
        for _ in range(min(batch, n_requests - i)):
            tickets.append(service.submit(
                queries[i % len(queries)],
                deadline_s=_deadline_for(deadline_s, i)))
            i += 1
        service.drain()
    duration = time.perf_counter() - t0
    qps = n_requests / duration if duration > 0 else 0.0
    return build_report(tickets, mode="closed", process="lockstep",
                        offered_qps=qps, duration_s=duration)
