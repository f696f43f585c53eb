"""Parameter autotuner + scenario workload suite (DESIGN.md §19).

The paper's core experiment is search-speed dependence on MaxDistance,
and its follow-up (arXiv 2101.03327) is optimal-parameter selection for
these exact indexes. This package turns every serving knob that was
swept by hand into a measured decision:

* :mod:`repro_torch.tune.workloads` — named, seeded, replayable workload
  generators (Zipfian frequency draws, long-tail L skew, all-stop-word
  floods, configurable five-type mixes) with JSON record/replay and
  arrival-process attachment;
* :mod:`repro_torch.tune.sweep` — successive halving over the joint
  (MaxDistance, ServeConfig) space: a StepCostPredictor-priced estimate
  rung prunes the grid before any device work, survivors are measured
  via ``warm_service`` + open-loop replay;
* :mod:`repro_torch.tune.objective` — the scoring policy (warm p50/p95,
  deadline met-rate at a target budget, index-size penalty) with
  machine-readable per-config verdicts;
* :mod:`repro_torch.tune.report` — the winning ServeConfig as a JSON
  artifact (``python -m repro_torch.launch.serve --config`` serves with
  it) plus the per-parameter sensitivity table.

Services are built over a device mesh or on one device, as
``repro_torch.serving.SearchService`` takes them (``mesh=`` / ``device=``).
"""

from repro_torch.tune.objective import Objective  # noqa: F401
from repro_torch.tune.report import (  # noqa: F401
    emit_serve_config,
    load_serve_config,
    sensitivity_table,
)
from repro_torch.tune.sweep import (  # noqa: F401
    Candidate,
    SweepOutcome,
    estimate_workload_us,
    grid,
    index_bytes,
    measure_candidate,
    successive_halving,
    sweep,
)
from repro_torch.tune.workloads import (  # noqa: F401
    WORKLOAD_GENERATORS,
    Workload,
    attach_arrivals,
    load_workload,
    longtail_workload,
    make_workload,
    mixed_workload,
    record_workload,
    stopword_flood,
    zipfian_workload,
)

__all__ = [
    "Candidate",
    "Objective",
    "SweepOutcome",
    "WORKLOAD_GENERATORS",
    "Workload",
    "attach_arrivals",
    "emit_serve_config",
    "estimate_workload_us",
    "grid",
    "index_bytes",
    "load_serve_config",
    "load_workload",
    "longtail_workload",
    "make_workload",
    "measure_candidate",
    "mixed_workload",
    "record_workload",
    "sensitivity_table",
    "stopword_flood",
    "successive_halving",
    "sweep",
    "zipfian_workload",
]
