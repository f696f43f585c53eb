"""Background compaction executor (DESIGN.md §18).

``CompactionExecutor`` takes physical merges off the ``refresh()`` hot
path: a ``SegmentedIndex`` in background mode *schedules* merge jobs
here instead of running them inline, and a bounded worker pool merges
off-thread while readers keep serving immutable snapshots.

Protocol (the correctness rules the tests in
``tests/test_background_compaction.py`` pin down):

* **Capture at schedule time.** A job snapshots its victim ``Segment``
  objects and the tombstone set *as of scheduling*. The merge runs over
  exactly that capture; mutations racing the merge never feed it.
* **Atomic swap-in.** The merged output replaces its victims under the
  owner's lock in one step, and a fresh ``SegmentedView`` is published
  in the same critical section — a reader sees either the pre-merge or
  the post-merge segment set, never a torn mix.
* **Validate or supersede.** Swap-in first checks every victim is still
  live in the owner *by identity*. If any victim was already rewritten
  (an overlapping merge won, or a fully-dead segment was dropped by
  ``refresh``), the output is discarded and the job counts as
  ``superseded`` — never a second copy of a document.
* **Late tombstones survive.** Only tombstones that were in the capture
  *and* covered by the victims are purged at swap-in. A delete arriving
  mid-merge stays in the live set and keeps masking the merged segment
  at read time — a background merge can never resurrect a document.
* **Overlap cancellation.** Scheduling skips plans whose victims overlap
  a queued/running job, and a queued job whose victim set is strictly
  contained in a newly scheduled plan is cancelled in favour of the
  wider merge. Cancellation is cooperative: a running merge finishes
  (or fails) and then loses at validation.
* **Rate limit.** Merge *starts* are spaced ``min_interval_s`` apart so
  a churn burst cannot saturate the host with back-to-back merges.

``fault_hook(stage, job)`` is a test seam invoked at ``"before_merge"``
and ``"before_swap"``; raising from it fails the job (counted, surfaced
via ``result()``, never wedging the pool), sleeping in it simulates a
slow merge. ``result()`` waits on an event that is set in a ``finally``
— it cannot hang on a failed or cancelled job.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.index.compaction import merge_segments
from repro_torch.index.segment import Segment

# terminal job states
MERGED = "merged"
SUPERSEDED = "superseded"
CANCELLED = "cancelled"
FAILED = "failed"
NOOP = "noop"  # merge produced no survivors and victims were dropped


class CompactionJob:
    """One scheduled merge: captured victims + tombstones, a terminal
    state, and a never-hanging ``result()``."""

    def __init__(self, victims: list[Segment], tombstones: np.ndarray, segment_id: int):
        self.victims = list(victims)
        self.victim_ids = frozenset(s.segment_id for s in victims)
        self.tombstones = np.sort(np.asarray(tombstones, np.int64))
        self.segment_id = segment_id
        self.state: str | None = None  # terminal state once _done is set
        self.error: BaseException | None = None
        self._done = threading.Event()
        self._cancel = threading.Event()

    def cancel(self) -> None:
        """Cooperative: honoured if the job has not started merging."""
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def _finish(self, state: str, error: BaseException | None = None) -> None:
        self.state = state
        self.error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> str:
        """Block until terminal and return the state. Raises TimeoutError
        on timeout and re-raises the merge error for ``FAILED`` jobs."""
        if not self._done.wait(timeout):
            raise TimeoutError("compaction job still running")
        if self.state == FAILED and self.error is not None:
            raise self.error
        return self.state


class CompactionExecutor:
    """Bounded off-thread merge runner with rate limiting and overlap
    cancellation. One executor may serve one ``SegmentedIndex`` owner
    (the owner passes itself at ``schedule`` time)."""

    def __init__(
        self,
        workers: int = 1,
        min_interval_s: float = 0.0,
        metrics=None,
        tracer=None,
        fault_hook=None,
    ):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.min_interval_s = float(min_interval_s)
        self.metrics = metrics
        self.tracer = tracer
        self.fault_hook = fault_hook
        self.stats = {
            "scheduled": 0,
            "started": 0,
            "merged": 0,
            "superseded": 0,
            "cancelled": 0,
            "failed": 0,
            "noop": 0,
        }
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._queue: list[tuple[CompactionJob, object]] = []
        self._inflight: set[CompactionJob] = set()
        self._last_start = -float("inf")
        self._closed = False
        self._threads = [
            threading.Thread(target=self._worker, name=f"compaction-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    # -- scheduling --------------------------------------------------------
    def _busy_ids(self) -> set[int]:
        ids: set[int] = set()
        for job, _ in self._queue:
            ids.update(job.victim_ids)
        for job in self._inflight:
            ids.update(job.victim_ids)
        return ids

    def schedule(self, owner) -> list[CompactionJob]:
        """Plan merges over the owner's current segments and enqueue the
        non-overlapping groups. Returns the jobs enqueued (possibly [])."""
        specs = owner._compaction_specs()  # [(victims, tomb, segment_id)]
        jobs: list[CompactionJob] = []
        with self._lock:
            if self._closed:
                return []
            for victims, tomb, segment_id in specs:
                job = CompactionJob(victims, tomb, segment_id)
                # a queued job strictly inside this plan is superseded by it
                for queued, _ in list(self._queue):
                    if queued.victim_ids < job.victim_ids and not queued.done():
                        queued.cancel()
                        self._queue.remove((queued, owner))
                        queued._finish(CANCELLED)
                        self._count(CANCELLED)
                        self._idle.notify_all()
                if job.victim_ids & self._busy_ids():
                    continue  # overlap with queued/running work: skip this round
                self._queue.append((job, owner))
                jobs.append(job)
                self.stats["scheduled"] += 1
                if self.metrics is not None:
                    self.metrics.inc("compaction.scheduled")
            if jobs:
                self._idle.notify_all()
        return jobs

    # -- worker loop -------------------------------------------------------
    def _next_job(self):
        with self._lock:
            while True:
                if self._closed:
                    return None
                if self._queue:
                    wait = self._last_start + self.min_interval_s - time.monotonic()
                    if wait <= 0:
                        job, owner = self._queue.pop(0)
                        self._last_start = time.monotonic()
                        self._inflight.add(job)
                        return job, owner
                    self._idle.wait(timeout=wait)
                else:
                    self._idle.wait(timeout=0.1)

    def _worker(self) -> None:
        while True:
            item = self._next_job()
            if item is None:
                return
            job, owner = item
            try:
                self._run_job(job, owner)
            finally:
                with self._lock:
                    self._inflight.discard(job)
                    self._idle.notify_all()

    def _run_job(self, job: CompactionJob, owner) -> None:
        if job.cancelled:
            with self._lock:
                self._count(CANCELLED)
            job._finish(CANCELLED)
            return
        with self._lock:
            self.stats["started"] += 1
        if self.metrics is not None:
            self.metrics.inc("compaction.started")
        t0 = time.perf_counter()
        span = (
            self.tracer.span(
                "compaction.merge",
                cat="compaction",
                victims=sorted(job.victim_ids),
                out_segment=job.segment_id,
            )
            if self.tracer is not None
            else None
        )
        try:
            if span is not None:
                span.__enter__()
            try:
                if self.fault_hook is not None:
                    self.fault_hook("before_merge", job)
                merged = merge_segments(
                    job.victims,
                    job.tombstones,
                    owner.lexicon,
                    owner.max_distance,
                    segment_id=job.segment_id,
                )
                if self.fault_hook is not None:
                    self.fault_hook("before_swap", job)
                state = owner._apply_merge(job.victims, merged, job.tombstones)
            finally:
                if span is not None:
                    span.__exit__(None, None, None)
        except BaseException as exc:  # fault injection included
            with self._lock:
                self._count(FAILED)
            job._finish(FAILED, exc)
            return
        with self._lock:  # counted before result() can return
            self._count(state)
        job._finish(state)
        if self.metrics is not None:
            self.metrics.observe("compaction.merge_ms", (time.perf_counter() - t0) * 1e3)

    def _count(self, state: str) -> None:
        """Count a terminal state; callers hold ``_lock`` (the schedule
        path and the worker both count)."""
        self.stats[state] = self.stats.get(state, 0) + 1
        if self.metrics is not None:
            self.metrics.inc(f"compaction.{state}")

    # -- lifecycle ---------------------------------------------------------
    def pending(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._inflight)

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until no job is queued or running. Returns False on
        timeout (never raises: callers poll in loops)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._queue or self._inflight:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(timeout=remaining if remaining is not None else 0.1)
            return True

    def close(self, timeout: float | None = 10.0) -> None:
        """Cancel queued jobs, let running ones finish, stop the workers."""
        with self._lock:
            if self._closed:
                return
            for job, _ in self._queue:
                job._finish(CANCELLED)
                self._count(CANCELLED)
            self._queue.clear()
            self._closed = True
            self._idle.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
