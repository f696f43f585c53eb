"""Measured-cost models for the serving tier: cost-driven payload
arbitration for the planner (DESIGN.md §16) and the step-cost
predictor behind admission control and EDF group splitting
(:class:`StepCostPredictor`, DESIGN.md §17).

The static payload rule ("compressed engine => delta16 when the bucket
is block-aligned, else offsets") encodes a bytes-per-posting argument,
but what the response-time guarantee cares about is *measured* warm
batch time — and the measured calibration showed the compressed payload
winning on some routes (QT4) while losing on others (QT3) at the same
bucket. :class:`PayloadCostModel` closes that loop: per (step_family,
L-bucket) it keeps a warm per-query EWMA for each payload *arm* —
``raw`` vs the static rule's compressed format — explores both briefly,
then routes the group to the measured argmin, re-probing the losing arm
every ``probe_every`` winner observations so a probe window that landed
on cache-cold drains cannot pin a stale verdict.

Integration contract:

* ``choose(family, bucket, static_payload)`` is consulted by
  ``planner._payload`` only when the engine is compressed (raw engines
  have a single candidate). Exploration order is compressed-arm first:
  short-lived services behave exactly like the static rule (the
  existing compressed-serving tests pin that), and only sustained
  traffic pays the one-off raw probe.
* ``observe(family, bucket, payload, us_per_query)`` is fed by the
  executor from *warm* batches only (first-call compiles are excluded,
  as in the ``serve.step.*`` histograms), with the whole warm batch
  wall-clock — pack/compress/decode included — divided by the padded
  batch size, so host-side encode costs count against the arm that
  incurs them.
* ``generation`` increments whenever the *effective* choice for some
  (family, bucket) changes — exploration-phase transitions (compressed
  arm sampled -> raw probe window -> measured argmin) as well as later
  EWMA flips; the service keys its plan memo on it, so memoized plans
  can never pin a stale payload or starve the raw probe.

The model is intentionally tiny (dict + EWMA, no locking beyond the
GIL): it arbitrates between two arms whose measured gap on the routes
that matter is tens of percent, far beyond EWMA noise.

:class:`RecallCostModel` (DESIGN.md §19) applies the same
measure-don't-assume move to degraded admits: instead of ordering
degrade candidates largest-prefix-first (a proxy for least
degradation), it tracks the measured result-count ratio of each
degraded (family, bucket) against the family's full route and orders
candidates by retained recall — with the prefix fraction as the
unmeasured prior, so a cold model reproduces the old ordering.
"""

from __future__ import annotations

from repro_torch.serving.planner import PAYLOAD_RAW

# observations of an arm before the other arm is explored / the argmin
# is trusted; EWMA weight of the newest observation; winner observations
# between re-probes of the losing arm
MIN_SAMPLES = 2
ALPHA = 0.4
PROBE_EVERY = 16

# recall-cost tracking (degraded admits, DESIGN.md §19): observations
# per (family, bucket) before a measured recall is trusted over the
# prefix-fraction prior; EWMA weight
RECALL_MIN_SAMPLES = 4
RECALL_ALPHA = 0.3


def _arm(payload: str) -> str:
    """delta16 and offsets are one arm: which of them serves is the
    packer's uint16-overflow verdict, not a planner choice."""
    return PAYLOAD_RAW if payload == PAYLOAD_RAW else "compressed"


class StepCostPredictor:
    """Predicted wall-clock batch cost per (step_family, B, L-bucket) —
    the admission controller's time model (DESIGN.md §17).

    Prediction order, per shape:

    1. the live measured ``serve.batch.*`` whole-batch p50 (host
       pack/compress/decode included) for the exact or nearest measured
       shape of the family, scaled by the slot ratio — step work is
       linear in B and L; the run-only ``serve.step.*`` p50 backs it
       up when only the step metric exists;
    2. the *unit estimate* when no measurement exists: the planner's
       ``est_step_cost`` slots converted at
       ``config.unit_us_per_kslot`` — deliberately crude, but it makes
       a cold controller monotone in the same shape variables the
       measured model is, so admission decisions degrade gracefully
       instead of being unavailable;

    plus the mean observed AOT compile time whenever the shape has no
    executable yet (a batch routed to a cold shape pays the first-call
    compile, and admission/splitting must not pretend it is free). Two
    warmth regimes:

    * default (admission, backlog, drain horizon): the penalty applies
      only while the whole (family, L-bucket) is cold at *every* B —
      once some B serves warm, a new B-bucket's one-off compile is
      amortized over the service lifetime. Pricing it into every
      admit would cold-reject all traffic whose exact B never ran,
      and what is never admitted never warms (a reject spiral);
    * ``strict_warm=True`` (EDF split decisions): the exact (B, L)
      shape must be warm — a mid-drain split onto a cold B pays the
      compile *inside* the very deadline it is trying to save, so the
      split planner must see the true first-call cost.

    ``headroom`` scales every prediction: measured p50s under-predict
    the tail the deadline verdict is judged on, so the controller plans
    against ``headroom ×`` the median."""

    def __init__(self, executor, config, streams_of):
        self.executor = executor
        self.config = config
        self.streams_of = streams_of
        # per-shape prediction memo: reading a measured p50 sorts the
        # histogram's sample window, which is far too expensive to do
        # per candidate per submit at serving rates — the admission
        # path would stall the very drains it schedules around.
        # invalidate() is called once per drain (the only place new
        # measurements land), so between drains predictions are O(1)
        self._memo: dict[tuple, float] = {}

    def invalidate(self) -> None:
        """Drop memoized predictions (new measurements just landed)."""
        self._memo.clear()

    def batch_s(self, family: str, B: int, bucket: int,
                strict_warm: bool = False) -> float:
        key = (family, B, bucket, strict_warm)
        cached = self._memo.get(key)
        if cached is not None:
            return cached
        cfg = self.config
        us = self.executor.measured_batch_us(family, B, bucket)
        if us is None:
            us = self.executor.measured_step_us(family, B, bucket)
        if us is None:
            slots = self.streams_of(family, cfg) * bucket * cfg.doc_shards
            us = cfg.unit_us_per_kslot * B * slots / 1000.0
        warm = (self.executor.is_warm(family, B, bucket) if strict_warm
                else self.executor.family_warm(family, bucket))
        if not warm:
            us += self.executor.compile_penalty_s() * 1e6
        out = us * cfg.admission_headroom / 1e6
        self._memo[key] = out
        return out

    def scalar_s(self) -> float:
        """Per-request cost of the scalar backstop engine."""
        cached = self._memo.get("scalar")
        if cached is not None:
            return cached
        us = self.executor.measured_scalar_us()
        if us is None:
            us = self.config.unit_scalar_us
        out = us * self.config.admission_headroom / 1e6
        self._memo["scalar"] = out
        return out


class RecallCostModel:
    """Measured recall cost of degraded buckets (DESIGN.md §19).

    A degraded admit serves a *truncated posting prefix*
    (``planner.degrade``): its results are a subset of the full
    route's, and how much of the result set a given bucket retains is
    an empirical property of the posting distribution — not of the
    prefix fraction alone (hot lemmas front-load their postings in
    low doc ids; a quarter-length prefix can retain most results).
    Before this model, the admission controller ordered degrade
    candidates largest-prefix-first as a proxy for least degradation;
    this model replaces the proxy with the measured result-count ratio:

    * ``observe_full(family, n)`` — result count of a full-route
      compiled response (the per-family denominator);
    * ``observe_degraded(family, bucket, n)`` — result count of a
      response served from the degraded bucket;
    * ``recall(family, bucket)`` — EWMA(degraded) / EWMA(full), or
      None until both sides have ``min_samples`` observations;
    * ``order(family, buckets, planned_bucket)`` — degrade candidates
      sorted by estimated retained recall, best first. Unmeasured
      buckets use the prefix fraction ``bucket / planned_bucket`` as
      the prior, so a cold model reproduces the old largest-first
      ordering exactly (the static behaviour stays the fallback)."""

    def __init__(self, min_samples: int = RECALL_MIN_SAMPLES,
                 alpha: float = RECALL_ALPHA):
        self.min_samples = min_samples
        self.alpha = alpha
        self._full: dict[str, float] = {}       # family -> EWMA count
        self._full_n: dict[str, int] = {}
        self._deg: dict[tuple, float] = {}      # (family, bucket) -> EWMA
        self._deg_n: dict[tuple, int] = {}

    def _ewma(self, table: dict, key, value: float) -> None:
        prev = table.get(key)
        table[key] = (value if prev is None
                      else prev + self.alpha * (value - prev))

    def observe_full(self, family: str, n_results: int) -> None:
        self._ewma(self._full, family, float(n_results))
        self._full_n[family] = self._full_n.get(family, 0) + 1

    def observe_degraded(self, family: str, bucket: int,
                         n_results: int) -> None:
        key = (family, bucket)
        self._ewma(self._deg, key, float(n_results))
        self._deg_n[key] = self._deg_n.get(key, 0) + 1

    def recall(self, family: str, bucket: int) -> float | None:
        """Measured retained-recall estimate, or None while either side
        is under-sampled (an ordering must not flap on one batch)."""
        key = (family, bucket)
        if (self._deg_n.get(key, 0) < self.min_samples
                or self._full_n.get(family, 0) < self.min_samples):
            return None
        full = self._full.get(family, 0.0)
        if full <= 0.0:
            return None
        return min(1.0, self._deg[key] / full)

    def order(self, family: str, buckets, planned_bucket: int) -> list:
        """Degrade candidates best-recall-first; measured recall where
        it exists, the prefix fraction as the prior elsewhere. Ties
        break to the larger bucket (the superset per request)."""
        def key(b):
            r = self.recall(family, b)
            if r is None:
                r = b / planned_bucket if planned_bucket > 0 else 0.0
            return (-r, -b)
        return sorted(buckets, key=key)

    def table(self) -> dict:
        """Plain-data snapshot for ``stats["admission"]["recall"]``."""
        out: dict = {}
        for (family, bucket), ew in sorted(self._deg.items()):
            out[f"{family}/L{bucket}"] = {
                "recall": self.recall(family, bucket),
                "degraded_ewma_results": ew,
                "n": self._deg_n[(family, bucket)],
            }
        for family, ew in sorted(self._full.items()):
            out[f"{family}/full"] = {
                "full_ewma_results": ew,
                "n": self._full_n[family],
            }
        return out


class PayloadCostModel:
    """Measured per-(step_family, L-bucket) payload arbitration."""

    def __init__(self, min_samples: int = MIN_SAMPLES, alpha: float = ALPHA,
                 probe_every: int = PROBE_EVERY):
        self.min_samples = min_samples
        self.alpha = alpha
        self.probe_every = probe_every
        self._stale: dict[tuple, int] = {}  # winner obs since loser sampled
        self._ewma: dict[tuple, float] = {}  # (family, bucket, arm) -> us
        self._count: dict[tuple, int] = {}
        self._chosen: dict[tuple, str] = {}  # (family, bucket) -> arm
        self._phases: dict[tuple, str] = {}  # (family, bucket) -> phase
        self.generation = 0

    def observe(self, family: str, bucket: int, payload: str,
                us_per_query: float) -> None:
        key = (family, bucket, _arm(payload))
        prev = self._ewma.get(key)
        self._ewma[key] = (us_per_query if prev is None
                           else prev + self.alpha * (us_per_query - prev))
        self._count[key] = self._count.get(key, 0) + 1
        gk = (family, bucket)
        winner = self._argmin(family, bucket)
        if winner is not None:
            self._stale[gk] = (self._stale.get(gk, 0) + 1
                               if _arm(payload) == winner else 0)
        now = self._phase(family, bucket)
        if self._phases.get(gk, "explore_compressed") != now:
            self._phases[gk] = now
            if now in ("compressed", PAYLOAD_RAW):
                self._chosen[gk] = now
            self.generation += 1

    def _phase(self, family: str, bucket: int) -> str:
        """The exploration state machine: sample the static compressed
        format first, then a raw probe window, then the measured argmin
        — re-probing the losing arm after every ``probe_every`` winner
        observations. Any transition is a change in what :meth:`choose`
        returns, so :meth:`observe` bumps ``generation`` on it — without
        that, a service's memoized plans would pin the compressed
        payload and the raw arm would never be sampled. The periodic
        re-probe matters for the same reason the probe itself does: a
        probe window that happened to land on cache-cold drains writes
        an inflated EWMA for the losing arm, and with one-shot probing
        that stale verdict would never be revisited (the winner keeps
        refreshing its EWMA, the loser never does)."""
        if self._count.get((family, bucket, "compressed"), 0) < self.min_samples:
            return "explore_compressed"
        if self._count.get((family, bucket, PAYLOAD_RAW), 0) < self.min_samples:
            return "explore_raw"
        winner = self._argmin(family, bucket)
        if self._stale.get((family, bucket), 0) >= self.probe_every:
            return ("probe_raw" if winner == "compressed"
                    else "probe_compressed")
        return winner

    def _argmin(self, family: str, bucket: int) -> str | None:
        """The measured-best arm, or None while either arm is still
        unexplored (choices must not flap on one-sided evidence)."""
        arms = []
        for arm in ("compressed", PAYLOAD_RAW):
            key = (family, bucket, arm)
            if self._count.get(key, 0) < self.min_samples:
                return None
            arms.append((self._ewma[key], arm))
        return min(arms)[1]

    def choose(self, family: str, bucket: int, static_payload: str) -> str:
        """The payload one compiled group should serve: the static
        compressed format while that arm explores, one raw probe window
        next, then the measured argmin."""
        phase = self._phase(family, bucket)
        if phase in ("explore_compressed", "probe_compressed", "compressed"):
            return static_payload
        return PAYLOAD_RAW  # explore_raw / probe_raw / raw

    def table(self) -> dict:
        """Plain-data snapshot for stats/bench reporting: per
        (family, bucket), each arm's EWMA + count and the current
        choice."""
        out: dict = {}
        for (family, bucket, arm), us in sorted(self._ewma.items()):
            entry = out.setdefault(f"{family}/L{bucket}", {})
            entry[arm] = {"ewma_us_per_query": us,
                          "n": self._count[(family, bucket, arm)]}
            chosen = self._chosen.get((family, bucket))
            if chosen is not None:
                entry["chosen"] = chosen
        return out
