"""Admission control: the decision layer that closes the deadline
control loop (DESIGN.md §17).

The paper's headline is a *response-time guarantee*, yet before this
layer the serving tier only measured deadline misses (§15) — it never
enforced budgets. :class:`AdmissionController` is consulted by
``SearchService.submit()`` on every deadline-carrying request: using
the planner's ``est_step_cost`` calibrated by the measured
``us_per_kslot`` (through :class:`repro_torch.serving.costs.StepCostPredictor`,
with the unit estimate as the cold fallback) plus the current queue
backlog, it predicts the request's completion time and returns a
machine-readable :class:`AdmissionVerdict`:

* ``admit`` — predicted to meet its budget (or optimistically admitted
  during a transient burst, see hysteresis below);
* ``degrade`` — the planned route cannot meet the budget, but a
  cheaper bucket (a *truncated posting prefix*, ``planner.degrade``)
  can: served degraded instead of rejected outright;
* ``reject_infeasible`` — the budget cannot be met even by the
  cheapest route on an idle system: rejected fast, before any queueing
  or device work;
* ``shed_overload`` — feasible in isolation but the backlog makes it
  miss: load shedding. Sheds when the controller's overload latch is
  set, or — latched or not — when the predicted completion overshoots
  the budget beyond the ``optimism`` factor (a hopeless miss; admitting
  it only deepens the backlog for the feasible traffic behind it).

**Hysteresis.** Overload is a latched state with separate enter/exit
thresholds (``enter_s > exit_s``) on an EWMA-smoothed backlog (the
drain loop empties the queue every cycle, so the raw backlog sawtooths
through zero and would flap any latch keyed on it): the controller
sheds every predicted-miss request while latched, and a transient
burst that pushes the smoothed backlog above ``exit_s`` but not
``enter_s`` cannot flap it — *marginal* predicted misses are admitted
optimistically (EDF ordering and group splitting often still rescue
them) until the backlog demonstrably exceeds ``enter_s``, and shedding
continues until it falls back below ``exit_s``.

**Adaptive reserve (DESIGN.md §19).** The utilization margin the admit
test applies (``predicted <= margin × budget``) defaults to a
hand-swept constant, but the error it exists to absorb — work admitted
later landing ahead of this request — is measurable after the fact:
``observe_completion(predicted, actual)`` tracks realized
actual/predicted completion ratios over a recent window, and the
effective margin becomes ``1 / (q95(error) × safety)``, floored at the
static value (the cold fallback and the never-less-conservative
guarantee). A well-calibrated predictor thus admits more of the budget;
a badly-calibrated one falls back to the hand-swept reserve.

The controller itself is deliberately free of service state: it takes
the predicted costs and backlog as numbers and returns a verdict, so
its state machine is unit-testable without a running engine
(tests/test_admission.py drives it directly).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

# -- adaptive reserve (DESIGN.md §19) ---------------------------------------
# window of realized actual/predicted completion ratios; samples needed
# before the adaptive margin is trusted; the error quantile the reserve
# is derived from; the safety multiplier on that quantile; and how many
# observations between quantile recomputes (a sort per observation would
# tax the resolve path for nothing — the window moves slowly)
MARGIN_WINDOW = 256
MARGIN_MIN_SAMPLES = 32
MARGIN_QUANTILE = 0.95
MARGIN_SAFETY = 1.25
MARGIN_REFRESH = 8


def _quantile(sorted_vals, q: float) -> float:
    """Nearest-rank quantile of a sorted non-empty sequence."""
    k = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[k]

# -- verdicts (machine-readable, the §17 vocabulary) -----------------------
ADMIT = "admit"
DEGRADE = "degrade"
REJECT_INFEASIBLE = "reject_infeasible"
SHED_OVERLOAD = "shed_overload"

# -- response statuses ------------------------------------------------------
STATUS_OK = "ok"
STATUS_DEGRADED = "degraded"
STATUS_REJECTED = "rejected"
STATUS_SHED = "shed"

# -- deadline_blame extensions: a shed/rejected request's budget was not
# blown by a serving phase but by the controller's decision — the blame
# vocabulary names that explicitly (DESIGN.md §17)
BLAME_SHED = "shed"
BLAME_INFEASIBLE = "infeasible"

# -- admit sub-reasons ------------------------------------------------------
REASON_NO_BUDGET = "no_budget"        # deadline-less: nothing to enforce
REASON_PREDICTED_MET = "predicted_met"
REASON_OPTIMISTIC = "optimistic"      # predicted miss, but not overloaded


@dataclass(frozen=True)
class AdmissionVerdict:
    """One admission decision, machine-readable end to end.

    * ``decision`` — ``admit`` / ``degrade`` / ``reject_infeasible`` /
      ``shed_overload``;
    * ``predicted_e2e_s`` — backlog + predicted batch cost of the
      chosen route (for reject/shed: of the best candidate judged);
    * ``budget_s`` — the remaining budget the prediction was judged
      against (None for deadline-less admits);
    * ``backlog_s`` — the queue backlog estimate at decision time;
    * ``bucket`` — the chosen route's L-bucket; differs from the
      planned bucket exactly when ``decision == "degrade"``;
    * ``reason`` — admit sub-reason (``predicted_met`` vs
      ``optimistic``) or None."""

    decision: str
    predicted_e2e_s: float
    budget_s: float | None
    backlog_s: float
    bucket: int | None = None
    reason: str | None = None

    @property
    def admitted(self) -> bool:
        return self.decision in (ADMIT, DEGRADE)


class AdmissionController:
    """The §17 verdict state machine: feasibility + hysteresis.

    ``consider(candidates, backlog_s, budget_s)`` judges one request;
    ``candidates`` is a non-empty preference-ordered list of
    ``(bucket, predicted_batch_s)`` routes — the planned bucket first,
    then (when degradation is enabled) each smaller ladder bucket, so
    "first candidate that fits" is "least degradation". Scalar-route
    plans pass a single ``(None, predicted_s)`` candidate."""

    def __init__(self, enter_s: float, exit_s: float,
                 margin: float = 0.4, optimism: float = 1.2,
                 alpha: float = 0.3, adaptive_margin: bool = True):
        if exit_s > enter_s:
            raise ValueError(f"hysteresis requires exit_s <= enter_s "
                             f"(got exit={exit_s}, enter={enter_s})")
        if not 0.0 < margin <= 1.0:
            raise ValueError(f"margin must be in (0, 1] (got {margin})")
        self.enter_s = enter_s
        self.exit_s = exit_s
        # utilization margin: the admit test is predicted <= margin ×
        # budget, not the raw budget. The backlog estimate is taken at
        # decision time, but traffic admitted *later* still lands ahead
        # of this request (its batch group grows; earlier-deadline
        # groups grow) — an error that scales with the backlog itself,
        # so judging against the full budget systematically over-admits
        # under load. The margin is the reserve that absorbs it.
        #
        # With ``adaptive_margin`` the reserve is *derived* from the
        # realized error instead of pinned: `observe_completion()` feeds
        # actual/predicted completion ratios into a bounded window, and
        # the effective margin becomes 1 / (q95(error) × safety) — "if
        # predictions run at most q95× optimistic, admitting up to
        # 1/(q95·safety) of the budget still completes inside it".
        # The static value stays the floor (never *less* conservative
        # than the hand-swept reserve) and the cold fallback (below
        # MARGIN_MIN_SAMPLES observations).
        self.static_margin = margin
        self.adaptive_margin = adaptive_margin
        self._errors: deque = deque(maxlen=MARGIN_WINDOW)
        self._margin_eff = margin
        self._since_refresh = 0
        # optimistic-admit bound: a predicted miss is admitted (unlatched
        # state only) when predicted completion <= optimism × the
        # margined budget — marginal misses are often rescued by EDF
        # ordering and group splitting, hopeless ones never are, and
        # admitting them only deepens the backlog for the feasible
        # traffic behind them
        self.optimism = optimism
        # the latch judges a smoothed backlog: the drain loop empties
        # the queue every cycle, so the instantaneous backlog sawtooths
        # through zero at every drain boundary and would flap a latch
        # keyed on it directly no matter the thresholds
        self.alpha = alpha
        self.backlog_ewma = 0.0
        self.overloaded = False
        self.transitions = 0  # overload latch flips (flap observability)

    @property
    def margin(self) -> float:
        """The effective reserve the admit test uses right now: the
        static margin while cold (or with ``adaptive_margin=False``),
        the realized-error-derived value once enough completions have
        been observed."""
        return self._margin_eff

    def observe_completion(self, predicted_s: float,
                          actual_s: float) -> None:
        """Feed one realized outcome: the ``predicted_e2e_s`` of an
        admitted verdict vs the actual end-to-end completion of the
        request it admitted. The ratio actual/predicted is the
        controller's realized prediction error — the quantity the
        reserve exists to absorb — tracked over a bounded recent window
        so the margin follows the prevailing workload."""
        if predicted_s <= 1e-9 or actual_s < 0.0:
            return
        self._errors.append(actual_s / predicted_s)
        self._since_refresh += 1
        if self._since_refresh >= MARGIN_REFRESH:
            self._since_refresh = 0
            self._margin_eff = self._derive_margin()

    def _derive_margin(self) -> float:
        if (not self.adaptive_margin
                or len(self._errors) < MARGIN_MIN_SAMPLES):
            return self.static_margin
        q = _quantile(sorted(self._errors), MARGIN_QUANTILE)
        if q <= 0.0:
            return self.static_margin
        # admit up to 1/(q·safety) of the budget: even a q95-pessimal
        # prediction error, padded by the safety factor, still lands
        # the request inside the full budget. Floored at the static
        # reserve, capped at the raw budget.
        return min(1.0, max(self.static_margin,
                            1.0 / (q * MARGIN_SAFETY)))

    def margin_stats(self) -> dict:
        """The realized-error stat surfaced in ``stats["admission"]``:
        static vs effective margin plus the error window's quantiles."""
        errs = sorted(self._errors)
        return {
            "static": self.static_margin,
            "effective": self._margin_eff,
            "adaptive": int(self.adaptive_margin),
            "n_samples": len(errs),
            "error_p50": _quantile(errs, 0.5) if errs else None,
            "error_p95": _quantile(errs, MARGIN_QUANTILE) if errs else None,
        }

    def _update_overload(self, backlog_s: float) -> None:
        self.backlog_ewma += self.alpha * (backlog_s - self.backlog_ewma)
        if not self.overloaded and self.backlog_ewma > self.enter_s:
            self.overloaded = True
            self.transitions += 1
        elif self.overloaded and self.backlog_ewma < self.exit_s:
            self.overloaded = False
            self.transitions += 1

    def consider(self, candidates, backlog_s: float,
                 budget_s: float | None,
                 idle_cost_s: float | None = None) -> AdmissionVerdict:
        """Judge one request. ``budget_s`` is the *remaining* budget at
        decision time (deadline minus time already spent since
        arrival); None means no deadline. ``idle_cost_s`` is the cost
        of serving the request *alone* on an idle system (a B=1 batch
        of the cheapest route) — the infeasibility test: candidate
        costs are priced at the current crowd's batch size, so under
        load they overstate what an idle system would charge, and
        judging feasibility on them would mislabel overload sheds as
        infeasible rejects. Defaults to the cheapest candidate."""
        self._update_overload(backlog_s)
        planned_bucket, planned_s = candidates[0]
        if budget_s is None:
            return AdmissionVerdict(ADMIT, backlog_s + planned_s, None,
                                    backlog_s, bucket=planned_bucket,
                                    reason=REASON_NO_BUDGET)
        effective = self.margin * budget_s
        # least-degraded candidate predicted to complete within the
        # margined budget
        for bucket, cost_s in candidates:
            predicted = backlog_s + cost_s
            if predicted <= effective:
                decision = ADMIT if bucket == planned_bucket else DEGRADE
                return AdmissionVerdict(decision, predicted, budget_s,
                                        backlog_s, bucket=bucket,
                                        reason=REASON_PREDICTED_MET)
        # nothing fits under the current backlog: is the request
        # feasible on an idle system at all? (judged against the full
        # budget — infeasibility is a property of the request, not of
        # the reserve policy or the current crowd)
        if idle_cost_s is None:
            idle_cost_s = min(cost_s for _, cost_s in candidates)
        if idle_cost_s > budget_s:
            return AdmissionVerdict(REJECT_INFEASIBLE,
                                    backlog_s + candidates[-1][1],
                                    budget_s, backlog_s,
                                    bucket=planned_bucket)
        best = min(backlog_s + cost_s for _, cost_s in candidates)
        if self.overloaded or best > self.optimism * effective:
            return AdmissionVerdict(SHED_OVERLOAD, best,
                                    budget_s, backlog_s,
                                    bucket=planned_bucket)
        # transient-burst tolerance: a *marginal* predicted miss while
        # the latch is open — admit and let EDF ordering / group
        # splitting try to rescue it (hopeless misses shed above even
        # unlatched: admitting them only deepens the backlog)
        return AdmissionVerdict(ADMIT, backlog_s + planned_s, budget_s,
                                backlog_s, bucket=planned_bucket,
                                reason=REASON_OPTIMISTIC)
