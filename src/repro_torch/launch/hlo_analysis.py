"""Copies between shards for the roofline (the reference's
``launch/hlo_analysis.py``).

The reference parses the compiled HLO text: the collectives' result
bytes, split into those outside loops and those inside ``while`` bodies,
which the caller multiplies by the trip count, since XLA's
``cost_analysis()`` counts a scanned layer body once. The port compiles
nothing and has no HLO: :func:`collective_stats` reads the record that
``repro_torch.parallel``'s collectives keep during a cost count
(``repro_torch.obs.cost.Cost.copies``), bytes by kind as a mesh of
distinct devices would move them. The layers run as a Python loop, so
every layer's copies are counted where they happen: ``op_bytes`` holds
them all and ``in_loop_bytes`` stays empty. ``split_computations`` and
the HLO regular expressions have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# the reference's collective kinds; the port's record also names
# "broadcast", "reduce", "scatter" and "gather" (replicate, its backward,
# split_rows, its backward)
_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclass
class CollectiveStats:
    op_bytes: dict = field(default_factory=dict)  # outside loops
    in_loop_bytes: dict = field(default_factory=dict)  # inside while bodies
    count: int = 0

    def total(self, loop_trip_count: int = 1) -> float:
        return sum(self.op_bytes.values()) + sum(self.in_loop_bytes.values()) * max(
            loop_trip_count, 1
        )


def collective_stats(cost, n_devices: int = 1) -> CollectiveStats:
    """The copies of a count (a ``Cost``, or a ``parallel.CopyRecord``)
    per device: each kind's bytes over the mesh divided by ``n_devices``,
    and the number of copies."""
    copies = cost.copies if hasattr(cost, "copies") else cost.bytes
    n = cost.n_copies if hasattr(cost, "n_copies") else cost.count
    return CollectiveStats(op_bytes={k: v / n_devices for k, v in copies.items()}, count=n)
