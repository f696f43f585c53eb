"""Dispatch wrapper for the sorted segment sum.

:func:`segment_sum` is ``jax.ops.segment_sum`` over the rows of a float32
tensor: ``out[r] = sum of data[e] over the e with segment_ids[e] == r``,
ids outside ``[0, num_segments)`` adding nothing. It runs where the data
lies: on a card, the port's own CUDA kernel ``csrc/segment_sum.cu`` (the
reference has no Pallas kernel here: XLA lowers its segment sums and the
gradients of its gathers to scatter-adds); on the CPU, the plain version
:func:`segment_sum_plain`, ``index_add_`` in index order. There is no
knob that routes a CUDA tensor to the plain version and no fallback from
a failed kernel to it. ``segment_sum.launches`` counts the entry
point's launches, ``segment_sum.long_launches`` those of them that also
launch the long-segment kernel (a plan whose ids could hold a segment of
more than :data:`LONG_TERMS` terms).

The order of the sums is fixed. :func:`segment_plan` stable-sorts the
ids and searches each segment's offsets, so the kernel adds each row's
terms in their index order from 0.0, as ``index_add_`` does on the CPU:
the card's result equals the CPU's bit for bit and is the same in every
run, where ``index_add_`` on a card adds with atomics in an order that
changes from run to run. The plan also lists, on the device, the segments
of more than :data:`LONG_TERMS` terms, which the kernel sums on a path of
their own (``csrc/segment_sum.cuh``); no step of the plan or the launch
waits for the card. A plan is made once per index vector and reused
(the EGNN makes one for ``src`` and one for ``dst`` per batch, for every
layer and both passes).

Two ``torch.autograd.Function``s keep every scatter of a model on the
kernel: :class:`SegmentSum` (its backward a gather ``grad[ids]``) and
:class:`GatherRows`, ``x[ids]`` (its backward the segment sum by
``ids``). float32 only; other types raise TypeError.

Under a cost count (:mod:`repro_torch.obs.cost`) the entry point reports
its work and returns an uninitialised output, launching nothing: the
rows, the sorted index and the offsets read once and the output written
once (PERF.md's bound in bytes; its chain bound, the longest segment,
depends on the ids' values and is not counted), one add per term and
column. The plan (sort, offsets, long list) is torch ops and counts as
such.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.obs.cost import counting, kernel_work

INT32_MAX = 2**31 - 1
LONG_TERMS = 64  # a segment of more terms goes to the kernel's long path


def long_bound(n: int) -> int:
    """The most segments of more than :data:`LONG_TERMS` terms that ``n``
    terms can make: the length of a plan's ``long_rows``."""
    return n // (LONG_TERMS + 1)


@dataclass(frozen=True)
class SegmentPlan:
    """The fixed order of a segment sum over ``ids``: ``order`` (n,)
    int32, the term indices stable-sorted by id (ids outside ``[0,
    num_segments)`` last), ``offsets`` (num_segments + 1,) int32,
    segment r's terms being ``order[offsets[r]:offsets[r + 1]]``, and
    ``long_rows`` (:func:`long_bound` (n),) int32, the segments of more
    than :data:`LONG_TERMS` terms in increasing order, then -1."""

    ids: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor
    num_segments: int
    long_rows: torch.Tensor


def _check_ids(ids: torch.Tensor, num_segments: int) -> None:
    if ids.dim() != 1:
        raise ValueError(f"segment ids must be 1-D, got shape {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"segment ids must be int32, got {ids.dtype}")
    if not 1 <= num_segments < INT32_MAX:
        raise ValueError(f"num_segments must be in [1, {INT32_MAX}), got {num_segments}")
    if ids.shape[0] >= INT32_MAX:
        raise ValueError(f"{ids.shape[0]} segment ids exceed the kernel's int32 indices")


def segment_plan(segment_ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The plan of a segment sum over ``segment_ids`` (n,) int32, on their
    device: a stable sort of the ids, each out-of-range id keyed past the
    last segment, and each segment's first term found by
    ``torch.searchsorted``, an integer result that no order of work
    changes; then the segments of more than :data:`LONG_TERMS` terms,
    gathered by ``torch.nonzero_static`` into a list as long as
    :func:`long_bound` allows, so nothing waits for the card to count
    them."""
    _check_ids(segment_ids, num_segments)
    ids = segment_ids.contiguous()
    keys = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    sorted_keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32, device=ids.device)
    offsets = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    is_long = (offsets[1:] - offsets[:-1]) > LONG_TERMS
    long_rows = torch.nonzero_static(is_long, size=long_bound(ids.shape[0]), fill_value=-1)
    return SegmentPlan(ids, order.to(torch.int32), offsets, int(num_segments),
                       long_rows[:, 0].to(torch.int32))


def _rows(data: torch.Tensor, n: int) -> torch.Tensor:
    """``data`` (n, ...) float32 as (n, C) rows."""
    if data.dim() < 1 or data.shape[0] != n:
        raise ValueError(f"data of shape {tuple(data.shape)} does not match {n} segment ids")
    if data.dtype != torch.float32:
        raise TypeError(f"the segment sum takes float32 data, got {data.dtype}")
    return data.reshape(n, math.prod(data.shape[1:]))


def segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`segment_sum`, on any device:
    ``index_add_`` into zeros, in index order on the CPU (with atomics on
    a card), ids outside ``[0, num_segments)`` dropped first."""
    _check_ids(segment_ids, num_segments)
    rows = _rows(data, segment_ids.shape[0])
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    out = torch.zeros((num_segments, rows.shape[1]), dtype=torch.float32, device=data.device)
    out.index_add_(0, segment_ids[keep].long(), rows[keep])
    return out.reshape((num_segments,) + tuple(data.shape[1:]))


def _plan(segment_ids, num_segments) -> SegmentPlan:
    if isinstance(segment_ids, SegmentPlan):
        if num_segments is not None and num_segments != segment_ids.num_segments:
            raise ValueError(f"num_segments {num_segments} against the plan's "
                             f"{segment_ids.num_segments}")
        return segment_ids
    if num_segments is None:
        raise ValueError("num_segments is required with segment ids")
    return segment_plan(segment_ids, num_segments)


def _forward(data: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """The checked segment sum: the kernel on a card, the plain version on
    the CPU."""
    rows = _rows(data, plan.ids.shape[0])
    if plan.ids.device != data.device:
        raise ValueError(f"segment ids are on {plan.ids.device}, the data on {data.device}")
    if counting():
        (E, C), n = rows.shape, plan.num_segments
        kernel_work("segment_sum.segment_sum", flops=E * C,
                    bytes_accessed=E * C * 4 + E * 4 + (n + 1) * 4 + n * C * 4)
        return torch.empty((n,) + tuple(data.shape[1:]), dtype=torch.float32,
                           device=data.device)
    if not data.is_cuda:
        return segment_sum_plain(data, plan.ids, plan.num_segments)
    rows = rows.contiguous()
    out = torch.empty((plan.num_segments, rows.shape[1]), dtype=torch.float32, device=data.device)
    launch_segment_sum(rows, plan, out)
    segment_sum.launches += 1
    if plan.long_rows.numel():
        segment_sum.long_launches += 1
    return out.reshape((plan.num_segments,) + tuple(data.shape[1:]))


def segment_sum(data: torch.Tensor, segment_ids, num_segments: int | None = None) -> torch.Tensor:
    """Sum of ``data`` (n, ...) float32 rows per segment -> (num_segments,
    ...) float32. ``segment_ids`` is an (n,) int32 tensor on the data's
    device, or a :class:`SegmentPlan` of one (``num_segments`` then comes
    from it). Differentiable with respect to ``data`` (see
    :class:`SegmentSum`)."""
    plan = _plan(segment_ids, num_segments)
    if torch.is_grad_enabled() and data.requires_grad:
        return SegmentSum.apply(data, plan)
    return _forward(data, plan)


segment_sum.launches = 0
segment_sum.long_launches = 0


def _gather(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    return x[plan.ids.long()]


def gather_rows(x: torch.Tensor, segment_ids) -> torch.Tensor:
    """``x[ids]`` for (n,) int32 ids in ``[0, x.shape[0])``, or a
    :class:`SegmentPlan` over ``x.shape[0]`` segments; differentiable with
    respect to ``x`` through :class:`GatherRows`, whose backward is the
    segment sum by ``ids``."""
    plan = _plan(segment_ids, x.shape[0])
    if torch.is_grad_enabled() and x.requires_grad:
        return GatherRows.apply(x, plan)
    return _gather(x, plan)


class SegmentSum(torch.autograd.Function):
    """:func:`segment_sum` with its gradient: ``grad[ids]``, zero for the
    ids it dropped."""

    @staticmethod
    def forward(ctx, data, plan):
        ctx.plan = plan
        return _forward(data, plan)

    @staticmethod
    def backward(ctx, grad_out):
        plan = ctx.plan
        ids = plan.ids.long()
        keep = (ids >= 0) & (ids < plan.num_segments)
        g = grad_out[ids.clamp(0, plan.num_segments - 1)]
        keep = keep.reshape((-1,) + (1,) * (g.dim() - 1))
        return torch.where(keep, g, torch.zeros((), dtype=g.dtype, device=g.device)), None


class GatherRows(torch.autograd.Function):
    """``x[ids]`` with its gradient, the segment sum of the output's
    gradient by ``ids`` into ``x.shape[0]`` rows (the kernel on a card)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _gather(x, plan)

    @staticmethod
    def backward(ctx, grad_out):
        return _forward(grad_out.contiguous(), ctx.plan), None


def launch_segment_sum(rows: torch.Tensor, plan: SegmentPlan, out: torch.Tensor) -> None:
    """Launch the CUDA kernels into a preallocated ``out`` (every row
    written) on the current stream — no checks and no launch count: the
    wrapper's inner step, exposed for timing the kernel alone."""
    from repro_torch.kernels.build import launch

    launch("segment_sum", "segment_sum",
           [rows, plan.order, plan.offsets, *long_args(plan), out, plan.num_segments,
            rows.shape[1]], rows.device)


def long_args(plan: SegmentPlan) -> list:
    """The long-segment arguments of a C entry point: the list (None when
    it is empty), its length and :data:`LONG_TERMS`."""
    n = plan.long_rows.numel()
    return [plan.long_rows if n else None, n, LONG_TERMS]
