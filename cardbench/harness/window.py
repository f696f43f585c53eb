"""The measured window: clients in a closed loop against one service.

Each turn of the loop submits the next query of every client that is
ready (every client is: a drain answers all it was given), calls
``drain()``, and timestamps the replies when it returns. A request with
no reply at all once its drain has returned is ``unanswered``. Each query
the clients send is the next of the run's stream (``harness.traffic``),
drawn from the seed; none is sent twice. A request's
latency runs from its ``submit`` to that return; a request that comes
back without results of its own (unserved, shed, rejected) counts as
failed and misses every limit. The window closes at the first turn that
would start after ``seconds``; its length runs to the end of the last
drain, so a rate covers all the work and all the time. Where ``on_turn``
returns true (it has started the traced slice), the requests sent from
that turn on are the traced ones: ``traced_from`` counts those before.

A sample of the answers, drawn from the seed, is kept for the judge: a
reservoir of ``per_route`` answers for each route the responses name."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

SERVED = ("ok", "degraded")


@dataclass
class Window:
    latencies_s: np.ndarray
    attempted: int
    completed: int
    failed: int
    unanswered: int
    window_s: float
    drains: int
    deadline_met: int
    by_route: dict
    samples: dict = field(default_factory=dict)  # route -> [(query, results)]
    drain_ends: list = field(default_factory=list)  # seconds from the window's start
    traced_from: int | None = None  # requests sent before the traced slice

    def untraced_latencies(self) -> np.ndarray:
        """Latencies of the requests sent before the traced slice began."""
        return self.latencies_s[:self.traced_from]

    def quarter_rates(self) -> list[float]:
        """Answers a second in each quarter of the window (drains counted
        in the quarter they end in)."""
        if self.window_s <= 0 or not self.drain_ends:
            return []
        per = self.completed / len(self.drain_ends)
        q = self.window_s / 4
        counts = [0, 0, 0, 0]
        for t in self.drain_ends:
            counts[min(int(t / q), 3)] += 1
        return [c * per / q for c in counts]


def serve_prefix(service, stream, clients: int, deadline_s: float, n: int) -> int:
    """Set-up, not timed: the clients send the stream's first ``n`` queries
    as the window would (a turn of ``clients`` queries, then ``drain()``),
    so the window begins where a service that has served them stands. The
    window goes on with the queries after them. Returns the number sent."""
    sent = 0
    while sent < n:
        turn = min(clients, n - sent)
        for _ in range(turn):
            service.submit(stream.next(), deadline_s=deadline_s)
        service.drain()
        sent += turn
    return sent


def closed_loop(service, stream, clients: int, deadline_s: float, seconds: float,
                rng: np.random.Generator, per_route: int, on_turn=None) -> Window:
    lat: list[float] = []
    samples: dict[str, list] = {}
    seen: dict[str, int] = {}
    attempted = completed = failed = unanswered = met = drains = 0
    traced_from = None
    ends: list[float] = []
    t0 = time.perf_counter()
    t_end = t0
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
        if on_turn is not None and on_turn(elapsed) and traced_from is None:
            traced_from = attempted
        sent = []
        for _ in range(clients):
            q = stream.next()
            sent.append((q, time.perf_counter(), service.submit(q, deadline_s=deadline_s)))
        service.drain()
        t_end = time.perf_counter()
        ends.append(t_end - t0)
        drains += 1
        attempted += len(sent)
        for q, t_sub, ticket in sent:
            r = ticket.response
            if r is None or r.status not in SERVED:
                failed += 1
                unanswered += r is None
                lat.append(float("inf"))
                continue
            completed += 1
            lat.append(t_end - t_sub)
            met += bool(r.deadline_met)
            route = r.path
            k = seen.get(route, 0)
            seen[route] = k + 1
            bucket = samples.setdefault(route, [])
            if len(bucket) < per_route:
                bucket.append((q, r.results))
            else:
                j = int(rng.integers(k + 1))
                if j < per_route:
                    bucket[j] = (q, r.results)
    return Window(latencies_s=np.asarray(lat, np.float64), attempted=attempted,
                  completed=completed, failed=failed, unanswered=unanswered,
                  window_s=t_end - t0,
                  drains=drains, deadline_met=met, by_route=seen, samples=samples,
                  drain_ends=ends, traced_from=traced_from)
