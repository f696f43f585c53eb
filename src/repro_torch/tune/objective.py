"""Scoring for the parameter sweep (DESIGN.md §19).

A candidate (MaxDistance + ServeConfig) is judged on the three axes the
paper's guarantee actually trades between:

* warm per-query latency — open-loop e2e p50 (weight 1) and p95
  (weight ``w_p95``), in microseconds;
* the deadline guarantee — a penalty per unit of met-rate shortfall
  below ``target_met_rate`` at the target budget (charged on the
  *offered* met rate, so shedding is not a free way to hit the SLO);
* index size — MaxDistance grows the (w,v)/(f,s,t) indexes
  superlinearly (the paper's core trade-off), so bytes carry a small
  latency-equivalent price.

``score()`` folds a measurement dict into one number (lower is better)
and returns a machine-readable verdict with every component broken out;
``estimate_score()`` is the cheap pre-measurement stand-in the halving
sweep's first rung uses (predicted latency + the size penalty — no met
rate exists before a measured run).
"""

from __future__ import annotations

from dataclasses import dataclass

MIB = float(1 << 20)


@dataclass(frozen=True)
class Objective:
    """The sweep's scoring policy, frozen so one objective is shared by
    every rung of one sweep (scores are only comparable under the same
    weights)."""

    deadline_s: float = 0.05
    target_met_rate: float = 0.99
    w_p95: float = 0.25
    # 1.0 of met-rate shortfall == 100k us of latency: missing the SLO
    # by 1% costs 1ms-equivalent, so no latency win can buy its way out
    # of a collapsed guarantee
    miss_penalty_us: float = 100_000.0
    size_penalty_us_per_mib: float = 2.0

    def estimate_score(self, est_us_per_query: float,
                       index_bytes: int) -> float:
        """Rung-0 score from the StepCostPredictor-based estimate."""
        return (est_us_per_query
                + self.size_penalty_us_per_mib * index_bytes / MIB)

    def score(self, measurement: dict, config_id: str = "") -> dict:
        """Fold one measured run into a verdict dict.

        ``measurement`` is the sweep's measurement record: ``p50_us``,
        ``p95_us``, ``met_rate_offered`` (or ``met_rate``),
        ``index_bytes``. The verdict carries the total ``score`` plus
        each component, so a report can attribute *why* a config won."""
        p50 = float(measurement["p50_us"])
        p95 = float(measurement.get("p95_us", p50))
        met = float(measurement.get("met_rate_offered",
                                    measurement.get("met_rate", 1.0)))
        index_mib = float(measurement.get("index_bytes", 0)) / MIB
        latency_us = p50 + self.w_p95 * p95
        shortfall = max(0.0, self.target_met_rate - met)
        miss_us = self.miss_penalty_us * shortfall
        size_us = self.size_penalty_us_per_mib * index_mib
        return {
            "config_id": config_id,
            "score": latency_us + miss_us + size_us,
            "p50_us": p50,
            "p95_us": p95,
            "met_rate": met,
            "met_target_ok": met >= self.target_met_rate,
            "index_mib": index_mib,
            "components": {
                "latency_us": latency_us,
                "miss_penalty_us": miss_us,
                "size_penalty_us": size_us,
            },
            "target": {
                "deadline_ms": self.deadline_s * 1e3,
                "met_rate": self.target_met_rate,
            },
        }
