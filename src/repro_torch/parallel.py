"""Collectives of the single-controller mesh's model paths.

The model paths over a mesh (``repro_torch.launch.mesh``: row-sharded
tables, expert parallelism, the edge-sharded EGNN) move tensors between
shards through three ``torch.autograd.Function``s, so that every sum
across shards, forward and backward, is one made in shard order on one
device:

* :func:`replicate` copies a tensor to each shard's device; its backward
  adds the shards' gradients in shard order on the source device;
* :func:`sum_to_lead` copies each shard's partial to the lead device and
  adds them left to right from the first (the ``psum``); its backward
  copies the gradient back to each shard;
* :func:`split_rows` gives shard i the i-th of equal contiguous row
  blocks, on its device; its backward concatenates the blocks' gradients.

Left to plain ``.to(device)`` under autograd, a tensor used on several
distinct devices would get its gradients added by autograd's per-device
threads in whatever order they finish. Where a shard's device is the
source's, each of the three hands out a view and copies nothing.
:class:`ShardedRows` is a parameter kept as such row blocks, one leaf per
shard, so each is differentiated and updated where it lives.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _view_or_copy(x: torch.Tensor, device) -> torch.Tensor:
    return x.view_as(x) if x.device == torch.device(device) else x.to(device)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.source = x.device
        return tuple(_view_or_copy(x, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            g = g.to(ctx.source)
            total = g if total is None else total + g
        return total, None


class _SumToLead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lead, *parts):
        ctx.devices = [p.device for p in parts]
        total = _view_or_copy(parts[0], lead)
        for p in parts[1:]:
            total = total + p.to(lead)
        return total

    @staticmethod
    def backward(ctx, grad):
        return (None, *(grad.to(d) for d in ctx.devices))


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.source = x.device
        return tuple(_view_or_copy(block, d)
                     for block, d in zip(x.chunk(len(devices)), devices))

    @staticmethod
    def backward(ctx, *grads):
        return torch.cat([g.to(ctx.source) for g in grads]), None


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


@dataclass(eq=False)
class ShardedRows:
    """A tensor kept as equal contiguous row blocks, block i on its own
    device: an embedding table row-sharded over the model axis. In a
    parameter tree each block is a leaf (``repro_torch.models.tree_leaves``),
    so each gets its own gradient and optimizer state where it lives."""

    shards: list

    @classmethod
    def of(cls, x: torch.Tensor, devices) -> "ShardedRows":
        """``x``'s rows split over ``devices``: row views of ``x`` where a
        device is ``x``'s (no copy), copies elsewhere."""
        with torch.no_grad():
            return cls(split_rows(x.detach(), devices))

    @property
    def shape(self) -> tuple:
        first = self.shards[0].shape
        return (first[0] * len(self.shards), *first[1:])

    @property
    def rows_per_shard(self) -> int:
        return int(self.shards[0].shape[0])

    def numel(self) -> int:
        return sum(s.numel() for s in self.shards)
