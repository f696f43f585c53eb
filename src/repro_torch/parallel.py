"""Collectives of the single-controller mesh's model paths.

The model paths over a mesh (``repro_torch.launch.mesh``: row-sharded
tables, the recsys steps' data shards, expert parallelism, the
edge-sharded EGNN, the LM's tensor parallelism and FSDP) move tensors
between shards through six ``torch.autograd.Function``s, and sum a
gradient's replicas through :func:`all_reduce`, so that every sum across
shards, forward and backward, is one made in shard order on one device:

* :func:`replicate` copies a tensor to each shard's device; its backward
  adds the shards' gradients in shard order on the source device;
* :func:`sum_to_lead` copies each shard's partial to the lead device and
  adds them left to right from the first (the ``psum``); its backward
  copies the gradient back to each shard;
* :func:`split_rows` gives shard i the i-th of equal contiguous row
  blocks, on its device; its backward concatenates the blocks' gradients;
* :func:`concat_to_lead` concatenates the shards' blocks on the first
  shard's device (data shards' outputs meeting on the lead); its
  backward hands each block its slice of the gradient;
* :func:`gather_blocks` concatenates blocks split along an axis onto each
  device of a group (FSDP's all-gather); its backward adds the group's
  gradients in group order and hands each block its slice on its own
  device (the reduce-scatter);
* :func:`all_reduce` sums replicas, one per shard, in place, and gives
  every shard the sum (a train step's gradients of a leaf held once per
  data shard, outside autograd): each shard adds its 1/n of the elements
  over all replicas in shard order (the reduce-scatter), then the slices
  are copied into every replica (the all-gather), so every replica gets
  the same bits;
* :func:`all_to_all` re-lays blocks out across a row of shards (the
  LM's attention split inside heads: columns to sequence blocks and
  back); it adds nothing, forward or backward.

Each of the seven notes what it copies in every :func:`copy_record` that
is open, by kind (the reference's collective names where the collective
is the same): ``replicate`` a ``broadcast`` and its backward a
``reduce``; ``sum_to_lead`` an ``all-reduce`` and its backward a
``broadcast``; ``split_rows`` a ``scatter`` and its backward a
``gather``; ``concat_to_lead`` a ``gather`` and its backward a
``scatter``; ``gather_blocks`` an ``all-gather`` and its backward a
``reduce-scatter``; ``all_reduce`` a ``reduce-scatter`` and an
``all-gather``; ``all_to_all`` an ``all-to-all`` both ways.
The bytes are those a mesh of distinct devices would move, counted by
shard index and not by what was copied here: on a mesh whose shards share
a device (a dry run's ``meta`` entries, one card in several shards) every
shard other than the source's receives its part.
A tensor lives on the first shard whose device is its own (or on none).

Left to plain ``.to(device)`` under autograd, a tensor used on several
distinct devices would get its gradients added by autograd's per-device
threads in whatever order they finish. Where a shard's device is the
source's, each hands out a view and copies nothing. :class:`Sharded` is a
parameter (or cache) kept as a grid of blocks, one leaf per block, so
each is differentiated and updated where it lives; :class:`MeshPlan`
hands each device of a step the blocks it uses.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class CopyRecord:
    """Bytes copied between shards by kind, and how many copies."""

    bytes: dict = field(default_factory=dict)
    count: int = 0


_RECORDS: list = []  # the open copy records


@contextlib.contextmanager
def copy_record():
    """A :class:`CopyRecord` of every copy the collectives make inside the
    block, forward and backward."""
    rec = CopyRecord()
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def _note(kind: str, nbytes: int, copies: int) -> None:
    if nbytes:
        for rec in _RECORDS:
            rec.bytes[kind] = rec.bytes.get(kind, 0) + int(nbytes)
            rec.count += copies


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _at(device, devices) -> int | None:
    """The shard a tensor on ``device`` lives on among ``devices``: the
    first whose device it is, None where there is none."""
    device = torch.device(device)
    return next((i for i, d in enumerate(devices) if torch.device(d) == device), None)


def _view_or_copy(x: torch.Tensor, device) -> torch.Tensor:
    return x.view_as(x) if x.device == torch.device(device) else x.to(device)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.source = x.device
        copies = len(devices) - (_at(x.device, devices) is not None)
        ctx.moved = (copies * _nbytes(x), copies)
        _note("broadcast", *ctx.moved)
        return tuple(_view_or_copy(x, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        _note("reduce", *ctx.moved)
        total = None
        for g in grads:
            g = g.to(ctx.source)
            total = g if total is None else total + g
        return total, None


class _SumToLead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lead, *parts):
        ctx.devices = [p.device for p in parts]
        home = _at(lead, ctx.devices)
        moved = [_nbytes(p) for i, p in enumerate(parts) if i != home]
        ctx.moved = (sum(moved), len(moved))
        _note("all-reduce", *ctx.moved)
        total = _view_or_copy(parts[0], lead)
        for p in parts[1:]:
            total = total + p.to(lead)
        return total

    @staticmethod
    def backward(ctx, grad):
        _note("broadcast", *ctx.moved)
        return (None, *(grad.to(d) for d in ctx.devices))


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.source = x.device
        blocks = x.chunk(len(devices))
        home = _at(x.device, devices)
        moved = [_nbytes(b) for i, b in enumerate(blocks) if i != home]
        ctx.moved = (sum(moved), len(moved))
        _note("scatter", *ctx.moved)
        return tuple(_view_or_copy(block, d) for block, d in zip(blocks, devices))

    @staticmethod
    def backward(ctx, *grads):
        _note("gather", *ctx.moved)
        return torch.cat([g.to(ctx.source) for g in grads]), None


class _ConcatToLead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, lead, *blocks):
        ctx.axis = axis
        ctx.homes = [b.device for b in blocks]
        ctx.sizes = [b.shape[axis] for b in blocks]
        moved = [_nbytes(b) for b in blocks[1:]]  # by shard index: every block but the first's
        ctx.moved = (sum(moved), len(moved))
        _note("gather", *ctx.moved)
        return torch.cat([b.to(lead) for b in blocks], axis)

    @staticmethod
    def backward(ctx, grad):
        _note("scatter", *ctx.moved)
        return (None, None, *(g.to(h) for g, h in zip(grad.split(ctx.sizes, ctx.axis),
                                                       ctx.homes)))


def _own(replicas) -> list:
    """The replicas, each contiguous and with storage of its own (a copy
    of one that is not, or that shares another's)."""
    out, seen = [], set()
    for r in replicas:
        key = None if r.device.type == "meta" else (r.device, r.untyped_storage().data_ptr())
        if not r.is_contiguous() or key in seen:
            r = r.clone(memory_format=torch.contiguous_format)
        seen.add(key)
        out.append(r)
    return out


RECEIVE_CHUNK = 1 << 24  # elements of a slice that all_reduce receives at once
_STREAMS: dict = {}  # a card's (send, receive) streams for all_reduce's copies


def _side_streams(devices):
    """(each device's own stream, a send stream, a receive stream) a device
    where every replica is on a card of its own, else None. PyTorch runs a
    copy between cards on the source's current stream once the
    destination's current stream has drained, so on the cards' own
    streams each copy would wait for all the work queued before it; on
    these, in rounds in which each card sends one block and receives one,
    the cards' copies run at once."""
    if any(d.type != "cuda" for d in devices) or len(set(devices)) < len(devices):
        return None
    for d in devices:
        if d not in _STREAMS:
            _STREAMS[d] = (torch.cuda.Stream(d), torch.cuda.Stream(d))
    own = [torch.cuda.current_stream(d) for d in devices]
    send = [_STREAMS[d][0] for d in devices]
    recv = [_STREAMS[d][1] for d in devices]
    for o, s in zip(own, send):
        s.wait_stream(o)  # the replicas are written
    return own, send, recv


def _copy(x: torch.Tensor, streams, src: int, dst: int, into: torch.Tensor):
    """``x`` (shard ``src``'s) copied into ``into`` (shard ``dst``'s), on
    the side streams where there are any."""
    if streams is None:
        return into.copy_(x)
    _, send, recv = streams
    with torch.cuda.stream(send[src]), torch.cuda.stream(recv[dst]):
        return into.copy_(x)


def _add_in_order(mine: torch.Tensor, parts: list, i: int) -> None:
    """``mine`` (``parts[i]``) made ``parts[0] + parts[1] + ...`` added left
    to right: the parts before it summed first, then added to it
    (addition commutes), then the parts after it."""
    if i:
        before = parts[0]
        for p in parts[1:i]:
            before = before + p
        mine.add_(before)
    for p in parts[i + 1:]:
        mine.add_(p)


def all_reduce(replicas) -> list:
    """The sum of ``replicas`` (replica i shard i's, each on its device, all
    of one shape) written into them, equal to the bit on every device, and
    the replicas returned: replica i's device adds its 1/n of the elements
    over all replicas in shard order into its own slice (the
    reduce-scatter), and each finished slice is copied into the other
    replicas' (the all-gather); both noted by shard index. No replica is
    allocated anew: a device receives RECEIVE_CHUNK elements of its slice
    from each other shard at a time, and adds one chunk while the next
    arrives. In round k of each half, shard i receives from shard
    (i + k) mod n (on side streams where the replicas are on cards of
    their own: :func:`_side_streams`)."""
    n = len(replicas)
    replicas = _own(replicas)
    devices = [r.device for r in replicas]
    slices = [torch.tensor_split(r.view(-1), n) for r in replicas]
    streams = _side_streams(devices)
    pending = None
    for start in range(0, slices[0][0].numel(), RECEIVE_CHUNK):
        pieces = [[s.narrow(0, start, max(0, min(RECEIVE_CHUNK, s.numel() - start)))
                   for s in row] for row in slices]
        got = [[pieces[i][i] if j == i else None for j in range(n)] for i in range(n)]
        if streams is not None:
            for o, r in zip(streams[0], streams[2]):
                r.wait_stream(o)  # a received chunk's block is free on its device's own stream
        for k in range(1, n):
            for i in range(n):
                j = (i + k) % n
                if streams is None:
                    got[i][j] = _view_or_copy(pieces[j][i], devices[i])
                else:
                    got[i][j] = _copy(pieces[j][i], streams, j, i,
                                      torch.empty_like(pieces[j][i], device=devices[i]))
        done = None if streams is None else [r.record_event() for r in streams[2]]
        if pending is not None:
            _add_chunk(*pending, streams)
        pending = (got, done)
    if pending is not None:
        _add_chunk(*pending, streams)
    if streams is not None:
        for o, s in zip(streams[0], streams[1]):
            s.wait_stream(o)  # the sums are written, and every read of a slice they replace
    for k in range(1, n):
        for i in range(n):
            j = (i + k) % n
            _copy(slices[i][i], streams, i, j, slices[j][i])
    if streams is not None:
        for o, s, r in zip(*streams):
            o.wait_stream(s)
            o.wait_stream(r)
    moved = (n - 1) * _nbytes(replicas[0])
    _note("reduce-scatter", moved, n * (n - 1))
    _note("all-gather", moved, n * (n - 1))
    return replicas


def _add_chunk(got: list, done, streams) -> None:
    """Each shard's chunk of its slice summed in shard order, on its own
    stream once the chunk's copies have arrived."""
    for i, parts in enumerate(got):
        if done is not None:
            streams[0][i].wait_event(done[i])
        _add_in_order(parts[i], parts, i)


def replicate(x: torch.Tensor, devices) -> list:
    """``x`` on each of ``devices`` (a view where the device is ``x``'s);
    the gradient is the shards' gradients added in shard order on ``x``'s
    device."""
    return list(_Replicate.apply(x, [torch.device(d) for d in devices]))


def sum_to_lead(parts, lead) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, left to right on ``lead`` after a
    copy of each part there; each part's gradient is the sum's, copied to
    the part's device."""
    return _SumToLead.apply(torch.device(lead), *parts)


def split_rows(x: torch.Tensor, devices) -> list:
    """``x``'s first axis in ``len(devices)`` equal contiguous blocks, block
    i on ``devices[i]`` (a view where that is ``x``'s device); the gradient
    is the blocks' gradients concatenated on ``x``'s device."""
    if x.shape[0] % len(devices):
        raise ValueError(f"{x.shape[0]} rows do not split over {len(devices)} shards")
    return list(_SplitRows.apply(x, [torch.device(d) for d in devices]))


def concat_to_lead(blocks, axis: int, lead) -> torch.Tensor:
    """The blocks (block i shard i's) concatenated along ``axis`` on
    ``lead``, the first shard's device, in shard order; block i's gradient
    is its slice of the result's, copied to block i's device."""
    return _ConcatToLead.apply(axis, torch.device(lead), *blocks)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, devices, moved, *blocks):
        ctx.axis = axis
        ctx.homes = [b.device for b in blocks]
        ctx.sizes = [b.shape[axis] for b in blocks]
        if moved is None:  # block i lives on the first target of its device
            homes = [_at(h, devices) for h in ctx.homes]
            sent = [b for t in range(len(devices)) for b, h in zip(blocks, homes) if h != t]
            moved = (sum(map(_nbytes, sent)), len(sent))
        ctx.moved = moved
        _note("all-gather", *moved)
        if len(blocks) == 1:
            return tuple(_view_or_copy(blocks[0], d) for d in devices)
        return tuple(torch.cat([b.to(d) for b in blocks], axis) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        _note("reduce-scatter", *ctx.moved)
        out, start = [], 0
        for home, size in zip(ctx.homes, ctx.sizes):
            total = None
            for g in grads:
                g = g.narrow(ctx.axis, start, size).to(home)
                total = g if total is None else total + g
            out.append(total)
            start += size
        return (None, None, None, *out)


def gather_blocks(blocks, axis: int, devices, moved=None) -> list:
    """The blocks concatenated along ``axis`` on each of ``devices`` (a
    view where there is one block and the device is its own); block i's
    gradient is the slice of each device's gradient that it gave, added in
    device order on block i's device. ``moved`` is what the copy records
    note, (bytes, copies), where the caller knows the shards better than
    the devices tell (:meth:`MeshPlan.views`)."""
    return list(_GatherBlocks.apply(axis, [torch.device(d) for d in devices], moved, *blocks))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_axis, cat_axis, devices, *parts):
        n = len(devices)
        if any(p.shape[split_axis] % n for p in parts):
            raise ValueError(f"an axis of {parts[0].shape[split_axis]} does not split over "
                             f"{n} shards")
        ctx.axes = (split_axis, cat_axis)
        ctx.homes = [p.device for p in parts]
        ctx.widths = [p.shape[cat_axis] for p in parts]
        pieces = [p.chunk(n, split_axis) for p in parts]
        moved = [_nbytes(pc[j]) for r, pc in enumerate(pieces) for j in range(n) if r != j]
        ctx.moved = (sum(moved), len(moved))
        _note("all-to-all", *ctx.moved)
        out = []
        for j, d in enumerate(devices):
            got = [_view_or_copy(pc[j], d) for pc in pieces]
            out.append(got[0] if len(got) == 1 else torch.cat(got, cat_axis))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        _note("all-to-all", *ctx.moved)
        split, cat = ctx.axes
        out, start = [], 0
        for home, width in zip(ctx.homes, ctx.widths):
            got = [g.narrow(cat, start, width).to(home) for g in grads]
            out.append(got[0] if len(got) == 1 else torch.cat(got, split))
            start += width
        return (None, None, None, *out)


def all_to_all(parts, split_axis: int, cat_axis: int, devices) -> list:
    """Each of ``parts`` (part r on shard r of a row) cut into
    ``len(devices)`` equal blocks along ``split_axis``, and target j (shard
    j, on ``devices[j]``) given the parts' j-th blocks concatenated along
    ``cat_axis``: columns to row blocks, or back. One part is a split, one
    target a gather. Nothing is added, forward or backward (the backward is
    the inverse re-layout), and the bytes noted are the blocks whose shard
    is not their target's."""
    return list(_AllToAll.apply(split_axis, cat_axis, [torch.device(d) for d in devices],
                                *parts))


def _spans(n: int, parts: int) -> list:
    if n % parts:
        raise ValueError(f"an axis of {n} does not split over {parts} shards")
    k = n // parts
    return [(i * k, (i + 1) * k) for i in range(parts)]


@dataclass(eq=False)
class Sharded:
    """A tensor kept as a grid of blocks, block (i, j) on its own device:
    ``shards`` holds them row-major over ``grid`` (rows: the data shards,
    columns: the model shards). ``axes`` names the tensor's axis split
    over the rows and over the columns (None: not split; rows not split
    are replicas, one per data shard, as serving keeps its weights).
    ``spans`` gives each column's (start, stop) along the
    column axis, equal contiguous blocks unless given (a KV cache whose
    model shards share a kv head holds it in each: spans may overlap).

    The default is an embedding table row-sharded over the model axis,
    block r on the model column r's first device. In a parameter tree each
    block is a leaf (``repro_torch.models.tree_leaves``), so each gets its
    own gradient and optimizer state where it lives."""

    shards: list
    grid: tuple = None
    axes: tuple = (None, 0)
    spans: tuple = None

    def __post_init__(self):
        if self.grid is None:
            self.grid = (1, len(self.shards))
        self.grid = tuple(self.grid)
        if self.grid[0] * self.grid[1] != len(self.shards):
            raise ValueError(f"{len(self.shards)} blocks on a grid of {self.grid}")
        if self.spans is None and self.axes[1] is not None:
            n = self.shards[0].shape[self.axes[1]]
            self.spans = tuple((j * n, (j + 1) * n) for j in range(self.grid[1]))

    @classmethod
    def of(cls, x: torch.Tensor, devices) -> "Sharded":
        """``x``'s rows split over ``devices``: row views of ``x`` where a
        device is ``x``'s (no copy), copies elsewhere."""
        return cls.split(x, [[torch.device(d) for d in devices]], (None, 0))

    @classmethod
    def split(cls, x: torch.Tensor, devices, axes: tuple, spans=None) -> "Sharded":
        """``x`` as contiguous blocks on ``devices`` (an array shaped like
        the grid): split over the rows along ``axes[0]`` (each row a
        replica where that is None) and over the columns along ``axes[1]``
        (at ``spans`` where given). A block that is already contiguous on
        its device is a view of ``x``, except a replica of a block already
        placed there, which is a copy of its own (each replica is updated
        in place)."""
        devices = np.array(devices, dtype=object).reshape(len(devices), -1)
        rows, cols = devices.shape
        row_spans = _spans(x.shape[axes[0]], rows) if axes[0] is not None else [None] * rows
        if spans is None:
            spans = _spans(x.shape[axes[1]], cols) if axes[1] is not None else [None]
        blocks, placed = [], set()
        x = x.detach()
        with torch.no_grad():
            for i, rs in enumerate(row_spans):
                part = x if rs is None else x.narrow(axes[0], rs[0], rs[1] - rs[0])
                for j, cs in enumerate(spans):
                    b = part if cs is None else part.narrow(axes[1], cs[0], cs[1] - cs[0])
                    b = b.to(devices[i, j]).contiguous()
                    if rs is None and i > 0 and b.device.type != "meta" and (
                            b.device, b.data_ptr()) in placed:
                        b = b.clone()
                    placed.add((b.device, b.data_ptr()))
                    blocks.append(b)
        return cls(blocks, (rows, cols), tuple(axes),
                   None if axes[1] is None else tuple(spans))

    def block(self, i: int, j: int) -> torch.Tensor:
        return self.shards[i * self.grid[1] + j]

    @property
    def shape(self) -> tuple:
        shape = list(self.shards[0].shape)
        if self.axes[0] is not None:
            shape[self.axes[0]] *= self.grid[0]
        if self.axes[1] is not None:
            shape[self.axes[1]] = max(stop for _, stop in self.spans)
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def rows_per_shard(self) -> int:
        return int(self.shards[0].shape[0])

    def numel(self) -> int:
        return sum(s.numel() for s in self.shards)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first block's by default),
        each element from the first block that holds it (replica rows from
        the first)."""
        device = self.shards[0].device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        rows = self.grid[0] if self.axes[0] is not None else 1
        for i in range(rows):
            for j in reversed(range(self.grid[1])):
                dst = out
                if self.axes[0] is not None:
                    n = self.shards[0].shape[self.axes[0]]
                    dst = dst.narrow(self.axes[0], i * n, n)
                if self.axes[1] is not None:
                    start, stop = self.spans[j]
                    dst = dst.narrow(self.axes[1], start, stop - start)
                dst.copy_(self.block(i, j).detach())
        return out

    def like(self, x: torch.Tensor) -> "Sharded":
        """``x`` (the whole tensor) in this one's layout: each block on
        its block's device."""
        devices = np.empty(self.grid, dtype=object)
        for k, s in enumerate(self.shards):
            devices[k // self.grid[1], k % self.grid[1]] = s.device
        return Sharded.split(x, devices, self.axes, self.spans)


class MeshPlan:
    """Where a step's pieces run on a mesh's (data shards, model shards)
    grid of devices (``launch/mesh.py`` ``Mesh.grid``): data shard d's
    stream on its lead device ``grid[d, 0]``, its model shard r on
    ``grid[d, r]``; ``dp_axes`` must cover the grid's rows."""

    def __init__(self, mesh, dp_axes):
        self.grid = grid = mesh.grid()
        self.dp, self.tp = grid.shape
        if math.prod(mesh.shape[a] for a in dp_axes) != self.dp:
            raise ValueError(f"dp_axes {tuple(dp_axes)} do not cover the mesh's batch axes "
                             f"{mesh.shape}")
        self.mesh_lead = mesh.lead

    def lead(self, d: int):
        return self.grid[d, 0]

    def row(self, d: int, cols: int) -> list:
        return list(self.grid[d, :cols])

    def views(self, leaf, cols: int, axis=None, spans=None) -> list:
        """``leaf`` (a tensor, or a ``Sharded`` of blocks on this grid) on
        every (d, r < cols) that uses it, [d][r]: shard r's part,
        ``spans[r]`` along ``axis``, or the whole where ``spans`` is None.
        A leaf kept in model blocks hands column r's blocks to column r
        (split as the step takes it); one kept whole is sliced. FSDP row
        blocks are gathered onto every data shard, and replica rows give
        data shard d its own. Each gather runs once per distinct device
        (once per grid position while a copy record is open:
        :func:`gather_blocks`)."""
        whole = None
        if not isinstance(leaf, Sharded):
            leaf = whole = Sharded([leaf], (1, 1), (None, None))
        split = leaf.grid[1] > 1
        if split and (cols != leaf.grid[1] or axis != leaf.axes[1]
                      or [tuple(s) for s in leaf.spans] != [tuple(s) for s in spans]):
            raise ValueError(f"a leaf in {leaf.grid[1]} model blocks along axis "
                             f"{leaf.axes[1]} where the step takes {cols} along {axis}")
        if leaf.axes[0] is None and leaf.grid[0] > 1:  # replicas: row d serves data shard d
            if leaf.grid[0] != self.dp:
                raise ValueError(f"{leaf.grid[0]} replica rows for {self.dp} data shards")
            groups = [([d], [d]) for d in range(self.dp)]
        else:  # (source rows, the data shards they serve)
            groups = [(list(range(leaf.grid[0])), list(range(self.dp)))]
        out = [[None] * cols for _ in range(self.dp)]
        for rows, shards in groups:
            for j in (range(cols) if split else [0]):
                targets = [(d, r) for d in shards for r in ([j] if split else range(cols))]
                blocks = [leaf.block(i, j) for i in rows]
                homes = [(i, j) for i in rows] if leaf is not whole else [self._home(blocks[0])]
                got = self._gather(blocks, homes, leaf.axes[0], targets)
                for (d, r), t in zip(targets, got):
                    if not split and spans is not None:
                        t = t.narrow(axis, spans[r][0], spans[r][1] - spans[r][0])
                    out[d][r] = t
        return out

    def _home(self, x: torch.Tensor):
        """The grid position of the first shard on ``x``'s device, or None."""
        hits = np.argwhere(np.vectorize(lambda d: d == x.device)(self.grid))
        return tuple(int(i) for i in hits[0]) if len(hits) else None

    def _gather(self, blocks, homes, axis, targets) -> list:
        """The blocks (block i at grid position ``homes[i]``) gathered onto
        each target position: once per distinct device, or, while a copy
        record is open, once per position, as a mesh of distinct devices
        gathers them."""
        moved = [_nbytes(b) for t in targets for b, h in zip(blocks, homes) if h != t]
        devices = [self.grid[t] for t in targets]
        keys = targets if _RECORDS else devices
        uniq = list(dict.fromkeys(keys))
        got = gather_blocks(blocks, 0 if axis is None else axis,
                            [devices[keys.index(k)] for k in uniq], (sum(moved), len(moved)))
        return [got[uniq.index(k)] for k in keys]

    def tree_views(self, tree: dict, cols: int, how: dict) -> list:
        """``views`` of each leaf of a dict -> [d][r] dicts; ``how[name]``
        is (axis, spans in units, unit size) or absent (whole)."""
        per = {}
        for k, v in tree.items():
            if cols > 1 and k in how:
                axis, spans, unit = how[k]
                per[k] = self.views(v, cols, axis, [(a * unit, b * unit) for a, b in spans])
            else:
                per[k] = self.views(v, cols)
        return [[{k: per[k][d][r] for k in per} for r in range(cols)] for d in range(self.dp)]

    def split_batch(self, x) -> list:
        """Data shard d's rows of ``x`` on its lead device."""
        if x.shape[0] % self.dp:
            raise ValueError(f"batch {x.shape[0]} does not split over {self.dp} data shards")
        return [c.to(self.lead(d)) for d, c in enumerate(x.chunk(self.dp))]
