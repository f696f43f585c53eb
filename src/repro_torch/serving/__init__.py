"""Serving tier: deadline-aware, batched, bucketed proximity-search
serving with a response-time guarantee (the paper's product), on a card.

The tier is three explicit layers (DESIGN.md §14):

* :mod:`repro_torch.serving.planner` — pure per-query routing:
  ``plan(request, snapshot, config) -> QueryPlan`` captures query type,
  route, L-bucket, payload, estimated step cost and a machine-readable
  ``fallback_reason`` for every scalar-route shape of the DESIGN.md §13
  dispatch matrix;
* :mod:`repro_torch.serving.executors` — ``CompiledExecutor`` (serve-step
  factories + the per-(kind, B, L) executable table, shared across
  paths by dispatch-aware batching) and ``ScalarExecutor`` behind one
  ``Executor`` protocol;
* :mod:`repro_torch.serving.service` — the :class:`SearchService` facade:
  one :class:`ServeConfig`, ``submit(lemma_ids, deadline_s=...) ->
  SearchTicket``, ``drain()`` resolving tickets with per-response
  ``plan``/``deadline_met``/``queue_wait_s``, and ``explain()``.

Public API
----------

* :class:`SearchService` / :class:`ServeConfig` / :class:`SearchTicket`
  / :class:`SearchResponse` — the serving facade.
* :class:`QueryPlan` — the inspectable routing decision.
* :class:`AdmissionController` / :class:`AdmissionVerdict` — the §17
  deadline control loop consulted by ``submit()`` on an
  ``admission=True`` engine (fast-reject, degrade, shed).
* :class:`PackedPostingCache` — LRU memo of the padded per-key rows,
  invalidated by snapshot identity (DESIGN.md §11).
"""

from repro_torch.serving.admission import (  # noqa: F401
    AdmissionController,
    AdmissionVerdict,
)
from repro_torch.serving.pack_cache import PackedPostingCache  # noqa: F401
from repro_torch.serving.planner import QueryPlan  # noqa: F401
from repro_torch.serving.service import (  # noqa: F401
    SearchResponse,
    SearchService,
    SearchTicket,
    ServeConfig,
)

__all__ = [
    "AdmissionController",
    "AdmissionVerdict",
    "PackedPostingCache",
    "QueryPlan",
    "SearchResponse",
    "SearchService",
    "SearchTicket",
    "ServeConfig",
]
