"""Fault tolerance + straggler mitigation for the training loop (the
reference's ``train/fault_tolerance.py``; plain Python, copied).

At thousand-node scale the supervisor discipline is:
  * every step runs under a watchdog; failures (device loss, NaN blowup,
    preemption) abort the step, not the job;
  * on failure the runner re-initializes from the latest atomic
    checkpoint (possibly on a different device count — elastic restore)
    and replays the data stream to the restored step (deterministic,
    seed+step-keyed batches make replay exact);
  * per-step wall times feed a straggler watermark (P50 * tolerance);
    slow steps raise a StragglerEvent so the deployment layer can hedge
    (re-schedule the slow host's shard, refresh its data feed, or drop it
    from the mesh at the next elastic restart).

The container is single-host, so hardware failures are *injected*
(FailureInjector) and the mitigation logic is what's under test — the
same supervisor runs unchanged on a real fleet where `step_fn` raises on
collective timeouts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.train.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic failure schedule: {step: kind}."""

    schedule: dict = field(default_factory=dict)
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        kind = self.schedule.get(step)
        if kind and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected {kind} at step {step}")


@dataclass
class StragglerEvent:
    step: int
    seconds: float
    watermark: float


class StragglerDetector:
    """Flags steps slower than tolerance x rolling median."""

    def __init__(self, window: int = 32, tolerance: float = 3.0, warmup: int = 5):
        self.times: list[float] = []
        self.window = window
        self.tolerance = tolerance
        self.warmup = warmup
        self.events: list[StragglerEvent] = []

    def observe(self, step: int, seconds: float) -> StragglerEvent | None:
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < self.warmup:
            return None
        watermark = float(np.median(self.times)) * self.tolerance
        if seconds > watermark:
            ev = StragglerEvent(step, seconds, watermark)
            self.events.append(ev)
            return ev
        return None


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_events: int = 0
    final_step: int = 0
    losses: list = field(default_factory=list)


class TrainSupervisor:
    """Run a training loop with checkpoint/restart + straggler detection.

    step_fn(state, batch) -> (state, metrics);
    batch_fn(step) -> batch   (deterministic per step — replay-exact);
    state is a pytree (params, opt, ...).
    """

    def __init__(
        self,
        step_fn,
        batch_fn,
        init_state_fn,
        ckpt_dir,
        ckpt_every: int = 20,
        max_restarts: int = 8,
        injector: FailureInjector | None = None,
        straggler: StragglerDetector | None = None,
        keep: int = 3,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.init_state_fn = init_state_fn
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep=keep)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.injector = injector or FailureInjector()
        self.straggler = straggler or StragglerDetector()

    def _restore_or_init(self):
        last = latest_step(self.ckpt_dir)
        state = self.init_state_fn()
        if last is None:
            return state, 0
        state, manifest = restore_checkpoint(self.ckpt_dir, state)
        return state, manifest["step"] + 1

    def run(self, total_steps: int) -> SupervisorReport:
        report = SupervisorReport()
        restarts = 0
        while True:
            state, start = self._restore_or_init()
            try:
                for step in range(start, total_steps):
                    t0 = time.perf_counter()
                    self.injector.maybe_fail(step)
                    batch = self.batch_fn(step)
                    state, metrics = self.step_fn(state, batch)
                    dt = time.perf_counter() - t0
                    if self.straggler.observe(step, dt):
                        report.straggler_events += 1
                    report.steps_run += 1
                    report.final_step = step
                    if metrics is not None and "loss" in metrics:
                        loss = float(metrics["loss"])
                        if not np.isfinite(loss):
                            raise RuntimeError(f"non-finite loss at step {step}")
                        report.losses.append(loss)
                    if (step + 1) % self.ckpt_every == 0:
                        self.ckpt.save(step, state, {"time": time.time()})
                self.ckpt.wait()
                self.ckpt.save(total_steps - 1, state, {"final": True})
                self.ckpt.wait()
                report.restarts = restarts
                return report
            except (InjectedFailure, RuntimeError) as e:
                restarts += 1
                self.ckpt.wait()
                if restarts > self.max_restarts:
                    raise RuntimeError(f"exceeded max restarts: {e}") from e
                # loop re-enters: restore from latest checkpoint and replay
