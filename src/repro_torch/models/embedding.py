"""Embedding tables of the recsys models (the reference's
``models/embedding.py``), unsharded.

``embedding_bag_sum`` is the reference's bag on its kernel path: it goes
through :func:`repro_torch.kernels.embedding_bag.embedding_bag` (the port
of ``embedding_bag_pallas``), so a table on a card runs
``csrc/embedding_bag.cu`` and one on the CPU the kernel's plain version.
Both add a bag's rows in float32 in the order s = 0..S-1; the reference
sums with XLA's reduce, so the two agree within rounding, not bit for bit.
The bag is differentiable with respect to a float32 table: its gradient
is the entry point's backward (``embedding_bag_bwd`` on a card, a sorted
segment sum in (b, s) order; ``embedding_bag_backward_plain`` on the CPU,
equal to it bit for bit), dense like the reference's gradient of its
gather and sum.
The row-sharded lookups (``sharded_embedding_*``) come with the
multi-device model slice.
"""

from __future__ import annotations

from repro_torch.kernels.embedding_bag import embedding_bag


def embedding_lookup(table, ids):
    """Unsharded lookup: ids (...,) int, -1 = padding -> zeros. An id at
    or past the table's rows gives a row of NaN, as ``jnp.take``'s fill
    mode does in the reference."""
    V = table.shape[0]
    rows = table[ids.clamp(0, V - 1).long()]
    mask = (ids >= 0).to(table.dtype).masked_fill(ids >= V, float("nan"))
    return rows * mask[..., None]


def embedding_bag_sum(table, ids, weights=None):
    """Bag-reduce over the last id axis: ids (..., S) -> (..., D), -1 =
    padding, through the embedding-bag kernel's entry point. Weights are
    rounded to the table's type, as the reference multiplies them in.
    Departure: an id at or past the table's rows adds nothing (the
    kernel's rule), where the reference's fill mode gives NaN."""
    lead, S = ids.shape[:-1], ids.shape[-1]
    w = None if weights is None else weights.reshape(-1, S)
    out = embedding_bag(ids.reshape(-1, S), table, w, "sum")
    return out.reshape(*lead, table.shape[1])
