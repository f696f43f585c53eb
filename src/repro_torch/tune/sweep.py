"""Successive-halving sweep over the joint (MaxDistance, ServeConfig)
space (DESIGN.md §19).

The search space is the product of an index-build axis (MaxDistance —
one :func:`repro_torch.core.index_builder.build_index` per value, shared by
every serve candidate) and serve-time axes (k_fst/k_wv/k_ns/k_st,
r_max, bucket ladder, share_buckets, payload policy, admit_margin...).
Measuring every cell is quadratically wasteful, so the sweep runs
successive halving:

* **rung 0 (estimate)** — every candidate is scored *without device
  work*: the pure planner routes the whole workload under the
  candidate config and :class:`repro_torch.serving.costs.StepCostPredictor`
  prices each (family, B, L-bucket) group with its unit cost model
  (`PayloadCostModel` likewise starts in its static phase, so
  compressed candidates are priced by the same static rule the planner
  applies cold). Crude, but monotone in the shape variables that
  dominate — enough to prune the clearly-bad half;
* **measured rungs** — survivors get a real run each:
  :func:`repro_torch.serving.load.warm_service` (so no AOT compile lands
  inside the measurement) then an open-loop replay of the workload's
  arrival schedule, with the measurement budget growing as the field
  halves.

:func:`successive_halving` is the generic engine (injectable score
functions — tests rig a cost table and assert the known-best candidate
is never dropped); :func:`sweep` wires it to real estimate/measure
stages and returns a :class:`SweepOutcome` the report layer consumes.

Every service the sweep builds serves over ``mesh`` (a
``repro_torch.launch.mesh.Mesh``) or, with ``mesh=None``, on ``device``
(the card when both are None), as ``SearchService`` takes them.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field

from repro_torch.core.torch_search import batch_size_bucket
from repro_torch.serving import SearchService, ServeConfig, warm_service
from repro_torch.serving.load import run_closed_loop, run_open_loop
from repro_torch.tune.objective import Objective


def _fmt_value(v) -> str:
    if isinstance(v, (tuple, list)):
        return "-".join(str(x) for x in v)
    return str(v)


@dataclass(frozen=True)
class Candidate:
    """One cell of the joint space: ``max_distance`` (index build) plus
    ``overrides`` applied to a base :class:`ServeConfig` (sorted
    (field, value) pairs — hashable, so candidates key dicts).
    ``axis_values`` preserves the sweep-axis labelling for the
    sensitivity table (one axis may set several config fields)."""

    max_distance: int
    overrides: tuple = ()
    axis_values: tuple = ()

    @property
    def config_id(self) -> str:
        parts = [f"d={self.max_distance}"]
        parts += [f"{k}={_fmt_value(v)}" for k, v in
                  (self.axis_values or self.overrides)]
        return "|".join(parts)

    def serve_config(self, base: ServeConfig | None = None) -> ServeConfig:
        kw = (base.to_json_dict() if base is not None
              else ServeConfig().to_json_dict())
        kw.update(dict(self.overrides))
        return ServeConfig.from_json_dict(kw)


def grid(max_distances, axes: dict) -> list[Candidate]:
    """The full cartesian product. ``axes`` maps an axis name to a list
    of values; a scalar/tuple value overrides the ServeConfig field of
    the axis's name, a dict value overrides several fields at once
    (e.g. ``{"k": [{"k_ns": 2, "k_st": 2}, ...]}``)."""
    names = sorted(axes)
    out = []
    for d in max_distances:
        for combo in itertools.product(*(axes[n] for n in names)):
            overrides: dict = {}
            labels = []
            for name, value in zip(names, combo):
                if isinstance(value, dict):
                    overrides.update(value)
                    labels.append((name, "+".join(
                        f"{k}{v}" for k, v in sorted(value.items()))))
                else:
                    overrides[name] = value
                    labels.append((name, value))
            out.append(Candidate(
                max_distance=int(d),
                overrides=tuple(sorted(overrides.items())),
                axis_values=tuple(labels),
            ))
    return out


def successive_halving(candidates, rungs, *, keep=None, eta: float = 2.0,
                       min_keep: int = 2) -> list[list[tuple]]:
    """Generic successive halving: ``rungs`` is a list of score
    functions (lower is better, one per rung, later rungs assumed more
    faithful and more expensive); after each non-final rung the top
    ``keep[i]`` candidates (default ``ceil(n / eta)``, floored at
    ``min_keep``) survive. Returns the per-rung history as
    ``[(candidate, score), ...]`` sorted best-first — the winner is
    ``history[-1][0][0]``.

    Scores are ranked with a stable sort, so a candidate that is best
    (or tied-best) at every rung is mathematically never dropped: the
    survivor cut keeps a prefix of the ranking and ``keep >= 1``
    always. Tests pin this on a rigged cost table."""
    if not candidates:
        raise ValueError("no candidates")
    if not rungs:
        raise ValueError("no rungs")
    survivors = list(candidates)
    history: list[list[tuple]] = []
    for i, score_fn in enumerate(rungs):
        scored = [(c, float(score_fn(c))) for c in survivors]
        scored.sort(key=lambda t: t[1])
        history.append(scored)
        if i < len(rungs) - 1:
            k = int(keep[i] if keep is not None and i < len(keep)
                    else math.ceil(len(scored) / eta))
            k = max(1, min(len(scored), max(min_keep, k)))
            survivors = [c for c, _ in scored[:k]]
    return history


# -- estimate stage ---------------------------------------------------------
def index_bytes(index) -> int:
    """Total bytes of an index's size report (the objective's size
    input): every ``*_bytes`` entry of ``ProximityIndex.size_report``."""
    rep = index.size_report()
    return int(sum(v for k, v in rep.items() if k.endswith("_bytes")))


def estimate_workload_us(service: SearchService, queries) -> float:
    """Predicted mean per-query cost of serving ``queries`` under the
    service's config, with **no device work**: every query is planned
    (pure planner), grouped per (family, L-bucket) exactly as one drain
    would, and priced by the service's :class:`StepCostPredictor` — on
    a cold service that is the unit model (``unit_us_per_kslot`` /
    ``unit_scalar_us``), the same estimates admission degrades to
    before measurements exist."""
    if not queries:
        raise ValueError("empty workload")
    mb = service.config.max_batch
    groups: dict[tuple, int] = {}
    n_scalar = 0
    for q in queries:
        p = service.explain(q)
        if p.is_compiled:
            key = (p.step_family, p.bucket)
            groups[key] = groups.get(key, 0) + 1
        elif p.route == "scalar":
            n_scalar += 1
    total_s = n_scalar * service.predictor.scalar_s()
    for (family, bucket), n in groups.items():
        B = batch_size_bucket(min(n, mb), mb)
        total_s += (-(-n // mb)) * service.predictor.batch_s(family, B, bucket)
    return total_s * 1e6 / len(queries)


def make_estimator(indexes: dict, mesh, base: ServeConfig, queries,
                   objective: Objective, *, device=None):
    """Rung-0 score function: ``candidate -> estimate_score`` (predicted
    mean per-query us + the index-size penalty). ``indexes`` maps each
    MaxDistance in the grid to its built index."""
    size = {d: index_bytes(idx) for d, idx in indexes.items()}

    def score(candidate: Candidate) -> float:
        svc = SearchService(indexes[candidate.max_distance],
                            candidate.serve_config(base), device=device,
                            mesh=mesh)
        est = estimate_workload_us(svc, queries)
        return objective.estimate_score(est, size[candidate.max_distance])

    return score


# -- measured stage ---------------------------------------------------------
def measure_candidate(index, mesh, config: ServeConfig, workload, *,
                      deadline_s: float = 0.05, arrivals=None,
                      closed_n: int = 64, device=None) -> dict:
    """One measured evaluation: build the service, warm every (family,
    B, L) executable the workload routes to, then replay the arrival
    schedule open-loop (or, with no schedule, a closed-loop run of
    ``closed_n`` requests). Returns the plain measurement dict the
    objective scores."""
    svc = SearchService(index, config, device=device, mesh=mesh)
    warm_service(svc, workload.queries)
    arrivals = arrivals if arrivals is not None else workload.arrivals
    if arrivals:
        rep = run_open_loop(svc, workload.queries, arrivals,
                            deadline_s=deadline_s)
    else:
        rep = run_closed_loop(svc, workload.queries, closed_n,
                              deadline_s=deadline_s)
    return {
        "p50_us": rep.e2e_p50_us,
        "p95_us": rep.e2e_p95_us,
        "met_rate": rep.met_rate,
        "met_rate_offered": rep.met_rate_offered,
        "shed_rate": rep.shed_rate,
        "achieved_qps": rep.achieved_qps,
        "n_offered": rep.n_offered,
        "index_bytes": index_bytes(index),
        "executables": svc.compiled.n_executables,
    }


@dataclass
class SweepOutcome:
    """Everything the report layer needs: the per-rung history (as
    plain ``{config_id, score}`` records), the measured candidates'
    objective verdicts, and the winner."""

    winner: Candidate
    winner_verdict: dict
    history: list = field(default_factory=list)
    verdicts: list = field(default_factory=list)
    measurements: dict = field(default_factory=dict)
    n_candidates: int = 0


def sweep(indexes: dict, mesh, candidates, workload, *,
          base: ServeConfig | None = None,
          objective: Objective | None = None,
          rung_arrivals=None, keep=None, device=None) -> SweepOutcome:
    """Run the full halving sweep: one estimate rung over every
    candidate, then one measured rung per arrival schedule in
    ``rung_arrivals`` (later schedules should be longer — the
    escalating-budget half of successive halving). ``keep`` bounds the
    survivors after each rung (default: halve)."""
    base = base if base is not None else ServeConfig()
    objective = objective if objective is not None else Objective()
    rung_arrivals = rung_arrivals or [None]
    measurements: dict[str, dict] = {}
    verdicts: dict[str, dict] = {}

    def make_measured(arrivals):
        def score(candidate: Candidate) -> float:
            m = measure_candidate(
                indexes[candidate.max_distance], mesh,
                candidate.serve_config(base), workload,
                deadline_s=objective.deadline_s, arrivals=arrivals,
                device=device)
            measurements[candidate.config_id] = m
            v = objective.score(m, config_id=candidate.config_id)
            verdicts[candidate.config_id] = v
            return v["score"]

        return score

    rungs = [make_estimator(indexes, mesh, base, workload.queries,
                            objective, device=device)]
    rungs += [make_measured(a) for a in rung_arrivals]
    history = successive_halving(candidates, rungs, keep=keep)
    winner = history[-1][0][0]
    return SweepOutcome(
        winner=winner,
        winner_verdict=verdicts[winner.config_id],
        history=[[{"config_id": c.config_id, "score": s}
                  for c, s in rung] for rung in history],
        verdicts=[verdicts[cid] for cid in sorted(verdicts)],
        measurements=measurements,
        n_candidates=len(candidates),
    )
