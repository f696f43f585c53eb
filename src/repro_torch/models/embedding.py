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

The row-sharded lookups (``sharded_embedding_lookup``,
``sharded_embedding_bag``) are the reference's ``shard_map``s on the
port's single-controller mesh (``launch/mesh.py``, with the collectives
of ``parallel.py``): the table's rows are ``tp`` contiguous blocks over
the model axis: a :class:`Sharded` (one leaf per block) or a plain tensor
split by ``split_rows``. Shard ``(d, r)`` of the mesh's (data, model)
grid takes data shard d's ids and block r (:func:`table_blocks`: its
own where the table is placed once per data shard, else ``replicate``d
over the data shards from the model column's first device), looks up or
bags the ids it owns, and ``sum_to_lead`` adds the ``tp`` partials of
data shard d on its lead device ``grid[d, 0]`` in rank order; the data
shards' results are concatenated on the mesh's lead device in shard
order (``concat_to_lead``). A built recsys step calls these over one data
shard's row of the grid at a time (``models/recsys.py``
``DataShards``), so each result stays on its data shard. ``ids_pspec``
is the reference's partition spec of the ids, a tuple of None, an axis
name or a tuple of axis names per axis: the axis it names is split over
those axes' data shards (default: the first axis over ``dp_axes``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.parallel import Sharded, concat_to_lead, replicate, split_rows, sum_to_lead


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


def _owned(ids, rank: int, rows_per_shard: int):
    """Shard ``rank``'s row for each id, and whether the shard owns it."""
    local = ids - rank * rows_per_shard
    return local, (local >= 0) & (local < rows_per_shard) & (ids >= 0)


def _local_lookup(table_l, ids, rank: int, rows_per_shard: int):
    """Shard ``rank``'s lookup: its rows of ``ids``, zeros for an id it
    does not own. Such an id reads row ``position mod rows`` (the
    reference clamps it to the first or last row): in the backward each
    adds its zero to its own row, where clamped ids would make two long
    runs of one row that CUDA's sorted ``index_put_`` adds one by one."""
    local, valid = _owned(ids, rank, rows_per_shard)
    spread = torch.arange(ids.numel(), device=ids.device).reshape(ids.shape) % rows_per_shard
    safe = torch.where(valid, local.long(), spread)
    return table_l[safe] * valid[..., None].to(table_l.dtype)


def local_ids(ids, rank: int, rows_per_shard: int):
    """Shard ``rank``'s rows for ``ids``, -1 (the bag's pad) for an id it
    does not own."""
    local, valid = _owned(ids, rank, rows_per_shard)
    return torch.where(valid, local, torch.full_like(local, -1))


def _names(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _ids_split(ids, mesh, tp_axis: str, dp_axes, ids_pspec) -> tuple:
    """(axis of ``ids`` split over data shards or None, number of data
    shards) from the reference's partition spec of the ids."""
    spec = tuple(ids_pspec) if ids_pspec is not None else (tuple(dp_axes),)
    split = [(i, _names(e)) for i, e in enumerate(spec) if _names(e)]
    if any(tp_axis in names for _, names in split):
        raise ValueError(f"ids sharded over {tp_axis!r} ({spec}): the psum over table shards "
                         "would add different rows' partials")
    if len(split) > 1:
        raise ValueError(f"ids split over more than one axis: {spec}")
    if not split:
        return None, 1
    axis, names = split[0]
    n = math.prod(mesh.shape[a] for a in names)
    if ids.shape[axis] % n:
        raise ValueError(f"ids axis {axis} of {ids.shape[axis]} does not split over {n} shards")
    return axis, n


def table_blocks(table, mesh, n: int, tp_axis: str = "model") -> list:
    """The table's ``tp`` row blocks for each of the first ``n`` data
    shards, [r][d]: a ``Sharded`` placed once per data shard hands data
    shard d its own row of blocks and copies nothing; a plain tensor, or a
    ``Sharded`` of one row, is split over the model columns' first devices
    and each block ``replicate``d over the data shards (one data shard
    takes a block on its device as it is)."""
    if tp_axis != "model":
        raise ValueError(f"tables are sharded over the model axis, not {tp_axis!r}")
    tp = mesh.shape[tp_axis]
    if table.shape[0] % tp:
        raise ValueError(f"{table.shape[0]} table rows do not split over {tp} shards")
    grid = mesh.grid()
    if isinstance(table, Sharded):
        rows, cols = table.grid
        if cols != tp or table.axes != (None, 0) or rows not in (1, grid.shape[0]) or (
                rows > 1 and n not in (1, rows)):
            raise ValueError(f"a table on a grid of {table.grid} split along {table.axes}; the "
                             f"step takes row blocks over {tp} model shards for {n} data shards")
        if rows > 1:
            return [[table.block(d if n > 1 else 0, r) for d in range(n)] for r in range(tp)]
        blocks = list(table.shards)
    else:
        blocks = split_rows(table, list(grid[0]))
    return [[b] if n == 1 and b.device == grid[0, r] else replicate(b, list(grid[:n, r]))
            for r, b in enumerate(blocks)]


def _sharded(per_shard, table, ids, mesh, tp_axis, dp_axes, ids_pspec, *others):
    """Run ``per_shard(block, ids, *others, rank, rows_per_shard)`` on every
    (data, model) shard, add each data shard's partials on its lead device
    and concatenate the data shards' sums on the mesh's lead device;
    ``others`` are split like ``ids``."""
    axis, n = _ids_split(ids, mesh, tp_axis, dp_axes, ids_pspec)
    per_data = table_blocks(table, mesh, n, tp_axis)
    rows = per_data[0][0].shape[0]
    grid = mesh.grid()
    pieces = [(ids, *others)] if axis is None else list(zip(
        *(t.chunk(n, dim=axis) if t is not None else [None] * n for t in (ids, *others))))
    outs = []
    for d, (ids_d, *others_d) in enumerate(pieces):
        parts = []
        for r in range(len(per_data)):
            dev = grid[d, r]
            moved = [None if t is None else t.to(dev) for t in others_d]
            parts.append(per_shard(per_data[r][d], ids_d.to(dev), *moved, r, rows))
        outs.append(sum_to_lead(parts, grid[d, 0]))
    return outs[0] if len(outs) == 1 else concat_to_lead(outs, axis, mesh.lead)


def lookup_row(blocks, ids, lead):
    """One data shard's lookup of ``ids`` over its row of table blocks
    (block r holds rows [r R, (r + 1) R) on its own device): each block
    gathers the ids it owns, zeros elsewhere, and ``sum_to_lead`` adds the
    partials on ``lead`` in rank order, so each row is its one owner's."""
    rows = blocks[0].shape[0]
    return sum_to_lead([_local_lookup(b, ids.to(b.device), r, rows)
                        for r, b in enumerate(blocks)], lead)


def sharded_embedding_lookup(table, ids, mesh, tp_axis="model", dp_axes=("data",),
                             ids_pspec=None):
    """The lookup of ``ids`` in a table row-sharded over the model axis:
    every shard gathers the ids it owns, zeros elsewhere, and the partials
    are added, so each result row is its one owner's row (-1 and ids past
    the table give zeros). On the lead device."""
    return _sharded(_local_lookup, table, ids, mesh, tp_axis, dp_axes, ids_pspec)


def sharded_embedding_bag(table, ids, mesh, weights=None, tp_axis="model", dp_axes=("data",),
                          ids_pspec=None):
    """The (weighted) bag-sum of ``ids`` (..., S) in a table row-sharded
    over the model axis: each shard sets the ids it does not own to -1 and
    runs the embedding-bag entry point (the kernel and, under autograd,
    its backward, on a card) over its block; the (..., D) partials are
    added on the lead device. Ids must not be split over the model axis."""
    S = ids.shape[-1]

    def per_shard(block, ids_l, w_l, rank, rows):
        local = local_ids(ids_l, rank, rows).to(torch.int32)
        w = None if w_l is None else w_l.reshape(-1, S)
        out = embedding_bag(local.reshape(-1, S), block, w, "sum")
        return out.reshape(*local.shape[:-1], block.shape[1])

    if ids.dim() < 2 or (ids_pspec is not None and len(tuple(ids_pspec)) == ids.dim()
                         and _names(tuple(ids_pspec)[-1])):
        raise ValueError(f"ids {tuple(ids.shape)} (spec {ids_pspec}) need a batch axis and "
                         "an unsplit bag axis")
    return _sharded(per_shard, table, ids, mesh, tp_axis, dp_axes, ids_pspec, weights)
