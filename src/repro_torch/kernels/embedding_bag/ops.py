"""Dispatch wrapper for the weighted embedding bag.

:func:`embedding_bag` is the reference package's entry point
(``kernels/embedding_bag/ops.py``) on its kernel path (``use_pallas=True``).
It runs where the table lies: on a card, the hand-written CUDA kernel
``csrc/embedding_bag.cu`` (the port of the Pallas ``embedding_bag_pallas``,
a one-hot matrix product on the TPU, a gather here); on the CPU, the plain
version :func:`embedding_bag_plain`. There is no knob that routes a CUDA
tensor to the plain version and no fallback from a failed kernel to it.
``embedding_bag.launches`` counts the kernel launches.

Both follow the reference kernel's rounding: each float32 weight is
rounded to the table's type (the TPU kernel scales its one-hot rows in
that type), products and their sum over the bag are float32, ``mean``
divides the float32 sum by ``max(#(ids >= 0), 1)``, and the result is cast
to the table's type. Ids outside ``[0, V)`` contribute nothing.

The reference's arguments map as follows. ``ids``, ``table``, ``weights``
and ``combine`` keep their meaning. ``block_b`` and ``block_v`` only tile
the TPU's one-hot product and are not taken. ``use_pallas`` and
``interpret`` are gone: the reference's default ``use_pallas=False``
gather is :func:`repro_torch.kernels.embedding_bag.ref.embedding_bag_ref`,
which rounds in the table's type. An empty batch, bag, vocabulary or row
width raises ValueError (the reference fails on each), and so does a
``combine`` other than "sum" or "mean" (the reference sums then). The
kernel takes float32 and bfloat16 tables. Given numpy arrays, the entry
point runs on ``device``, the card unless the caller names another.

The bag is differentiable with respect to the table (and the weights)
through a ``torch.autograd.Function``: the forward is the path above, the
table's gradient :func:`embedding_bag_backward`, a dense (V, D) float32
buffer with ``w[b, s] * g[b]`` added at row ``ids[b, s]`` for every valid
``(b, s)`` (``g[b]`` divided first by the mean's denominator), as the
reference's gradient of its gather and sum is. On a card that is the
port's own kernel ``embedding_bag_bwd`` in ``csrc/embedding_bag.cu``
(``embedding_bag_backward.launches`` counts it, ``.long_launches`` the
calls that also launch its long-segment kernel), on the CPU its plain
version :func:`embedding_bag_backward_plain`. Departure: the backward
takes float32 tables only; a bfloat16 table that requires a gradient
raises TypeError. The kernel is the sorted segment sum of
``csrc/segment_sum.cuh``: the wrapper stable-sorts the ids
(:func:`repro_torch.kernels.segment_sum.segment_plan`), and each row's
terms are added in ``(b, s)`` order, the plain version's order on the
CPU, so the card's gradient equals the CPU's bit for bit and is the same
in every run. The weights' gradient, ``dot(row, g[b])`` per valid
``(b, s)``, is plain torch ops on both devices.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import as_tensor
from repro_torch.kernels.segment_sum import segment_plan
from repro_torch.kernels.segment_sum.ops import long_args

COMBINES = ("sum", "mean")
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's type codes


def _check(ids: torch.Tensor, table: torch.Tensor, weights, combine: str) -> None:
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got {combine!r}")
    if ids.dim() != 2 or table.dim() != 2:
        raise ValueError(f"ids and table must be 2-D, got {tuple(ids.shape)} "
                         f"and {tuple(table.shape)}")
    if 0 in ids.shape or 0 in table.shape:
        raise ValueError(f"empty input: ids {tuple(ids.shape)}, table {tuple(table.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if not table.is_floating_point():
        raise TypeError(f"table must be floating point, got {table.dtype}")
    if weights is not None and tuple(weights.shape) != tuple(ids.shape):
        raise ValueError(f"weights have shape {tuple(weights.shape)}, "
                         f"ids {tuple(ids.shape)}")
    for name, t in (("ids", ids), ("weights", weights)):
        if t is not None and t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, the table on {table.device}")


def embedding_bag_plain(ids: torch.Tensor, table: torch.Tensor,
                        weights: torch.Tensor | None = None,
                        combine: str = "sum") -> torch.Tensor:
    """The plain PyTorch version of :func:`embedding_bag`, on any device:
    ids (B, S) int32, table (V, D), weights (B, S) float32 or None ->
    (B, D) in the table's type. The products are added in the order
    s = 0..S-1 in float32, as the kernel adds them."""
    _check(ids, table, weights, combine)
    B, S = ids.shape
    V, D = table.shape
    valid = (ids >= 0) & (ids < V)
    rows = table[ids.clamp(0, V - 1).long()].float()  # (B, S, D)
    w = (torch.ones(ids.shape, device=ids.device) if weights is None
         else weights.float())
    w = w.to(table.dtype).float()
    prod = torch.where(valid[..., None], w[..., None] * rows, 0.0)
    out = torch.zeros((B, D), dtype=torch.float32, device=table.device)
    for s in range(S):
        out = out + prod[:, s]
    if combine == "mean":
        out = out / (ids >= 0).sum(dim=1, keepdim=True).clamp(min=1).float()
    return out.to(table.dtype)


def embedding_bag(ids, table, weights=None, combine: str = "sum", *,
                  device=None) -> torch.Tensor:
    """Bag-reduce embedding lookup: ids (B, S) int32 (-1 = padding), table
    (V, D), optional weights (B, S) -> (B, D) in the table's type. A table
    on a card goes through the CUDA kernel, one on the CPU through
    :func:`embedding_bag_plain`; ids and weights follow the table. With a
    table (or weights) that requires a gradient, the result carries one
    (see the module docstring)."""
    dtype = table.dtype if isinstance(table, torch.Tensor) else torch.float32
    table = as_tensor(table, dtype, device)
    ids = as_tensor(ids, torch.int32, table.device)
    if weights is not None:
        weights = as_tensor(weights, torch.float32, table.device)
    _check(ids, table, weights, combine)
    if torch.is_grad_enabled() and (table.requires_grad
                                    or (weights is not None and weights.requires_grad)):
        if table.dtype != torch.float32:
            raise TypeError("the embedding bag's backward kernel takes float32 gradients "
                            f"only; the table is {table.dtype}")
        return _EmbeddingBagFn.apply(ids, table, weights, combine)
    return _forward(ids, table, weights, combine)


def _forward(ids, table, weights, combine: str) -> torch.Tensor:
    """The checked forward: the kernel on a card, the plain version on the CPU."""
    if not table.is_cuda:
        return embedding_bag_plain(ids, table, weights, combine)
    if table.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the kernel takes float32 and bfloat16 tables, got {table.dtype}")
    if table.shape[0] >= 2**31 or table.shape[1] > 2**23:
        raise ValueError(f"table of shape {tuple(table.shape)} exceeds the kernel's limits")
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    launch_embedding_bag(ids, table, weights, out, mean=combine == "mean")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0


class _EmbeddingBagFn(torch.autograd.Function):
    """The bag with its gradients: the table's through
    :func:`embedding_bag_backward`, the weights' in plain torch ops."""

    @staticmethod
    def forward(ctx, ids, table, weights, combine):
        ctx.save_for_backward(ids, table if weights is not None else None, weights)
        ctx.combine, ctx.num_rows = combine, table.shape[0]
        return _forward(ids, table, weights, combine)

    @staticmethod
    def backward(ctx, grad_out):
        ids, table, weights = ctx.saved_tensors
        grad_table = grad_w = None
        if ctx.needs_input_grad[1]:
            grad_table = embedding_bag_backward(ids, grad_out, ctx.num_rows, weights, ctx.combine)
        if ctx.needs_input_grad[2]:
            g = _bag_grad(ids, grad_out, ctx.combine)
            valid = (ids >= 0) & (ids < ctx.num_rows)
            rows = table[ids.clamp(0, ctx.num_rows - 1).long()].float()  # (B, S, D)
            grad_w = torch.where(valid, (rows * g[:, None, :]).sum(dim=-1), 0.0)
        return None, grad_table, grad_w, None


def _bag_grad(ids, grad_out, combine: str) -> torch.Tensor:
    """g', the bag's float32 output gradient, divided for ``mean`` by the
    forward's denominator max(#(ids >= 0), 1)."""
    g = grad_out.float()
    if combine == "mean":
        g = g / (ids >= 0).sum(dim=1, keepdim=True).clamp(min=1).float()
    return g


def _check_backward(ids, grad_out, num_rows: int, weights, combine: str) -> None:
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got {combine!r}")
    if ids.dim() != 2 or grad_out.dim() != 2 or grad_out.shape[0] != ids.shape[0]:
        raise ValueError(f"ids {tuple(ids.shape)} and grad_out {tuple(grad_out.shape)} "
                         "must be (B, S) and (B, D)")
    if 0 in ids.shape or 0 in grad_out.shape or num_rows < 1:
        raise ValueError(f"empty input: ids {tuple(ids.shape)}, grad_out "
                         f"{tuple(grad_out.shape)}, {num_rows} rows")
    if ids.dtype != torch.int32 or grad_out.dtype != torch.float32:
        raise TypeError(f"ids must be int32 and grad_out float32, got {ids.dtype} and "
                        f"{grad_out.dtype}")
    if weights is not None and (tuple(weights.shape) != tuple(ids.shape)
                                or weights.dtype != torch.float32):
        raise ValueError(f"weights must be float32 of shape {tuple(ids.shape)}")
    for name, t in (("ids", ids), ("weights", weights)):
        if t is not None and t.device != grad_out.device:
            raise ValueError(f"{name} is on {t.device}, grad_out on {grad_out.device}")


def embedding_bag_backward_plain(ids: torch.Tensor, grad_out: torch.Tensor, num_rows: int,
                                 weights: torch.Tensor | None = None,
                                 combine: str = "sum") -> torch.Tensor:
    """The plain PyTorch version of :func:`embedding_bag_backward`, on any
    device: ids (B, S) int32, grad_out (B, D) float32 -> the table's
    gradient (num_rows, D) float32, ``w[b, s] * g'[b]`` added at row
    ``ids[b, s]`` for every id in [0, num_rows): in (b, s) order on the
    CPU (``index_add_`` adds with atomics on a card)."""
    _check_backward(ids, grad_out, num_rows, weights, combine)
    g = _bag_grad(ids, grad_out, combine)
    valid = (ids >= 0) & (ids < num_rows)
    w = torch.ones(ids.shape, device=ids.device) if weights is None else weights
    contrib = w[..., None] * g[:, None, :]  # (B, S, D)
    out = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    out.index_add_(0, ids[valid].long(), contrib[valid])  # in (b, s) order on the CPU
    return out


def embedding_bag_backward(ids, grad_out, num_rows: int, weights=None,
                           combine: str = "sum") -> torch.Tensor:
    """The table's gradient of :func:`embedding_bag`: ids (B, S) int32,
    grad_out (B, D) float32, optional weights (B, S) float32 -> (num_rows,
    D) float32. On a card the ids are stable-sorted and the CUDA kernel
    ``embedding_bag_bwd`` sums each row's terms in ``(b, s)`` order, every
    row written; on the CPU :func:`embedding_bag_backward_plain`. The two
    agree bit for bit."""
    _check_backward(ids, grad_out, num_rows, weights, combine)
    if not grad_out.is_cuda:
        return embedding_bag_backward_plain(ids, grad_out, num_rows, weights, combine)
    if num_rows >= 2**31 - 1 or ids.numel() >= 2**31 - 1 or grad_out.shape[1] > 2**23:
        raise ValueError(f"a gradient of {num_rows} x {grad_out.shape[1]} from "
                         f"{ids.numel()} ids exceeds the kernel's limits")
    g = _bag_grad(ids, grad_out, combine).contiguous()
    plan = segment_plan(ids.reshape(-1), num_rows)
    weights = None if weights is None else weights.contiguous().reshape(-1)
    out = torch.empty((num_rows, grad_out.shape[1]), dtype=torch.float32, device=grad_out.device)
    launch_embedding_bag_backward(plan, weights, g, out, ids.shape[1])
    embedding_bag_backward.launches += 1
    if plan.long_rows.numel():
        embedding_bag_backward.long_launches += 1
    return out


embedding_bag_backward.launches = 0
embedding_bag_backward.long_launches = 0


def launch_embedding_bag(ids, table, weights, out, *, mean: bool, csrc=None) -> None:
    """Launch the CUDA kernel into a preallocated output on the current
    stream — no checks and no launch count: the wrapper's inner step,
    exposed for timing the kernel alone (``csrc``: another source
    directory, as in :mod:`repro_torch.kernels.build`)."""
    from repro_torch.kernels.build import CSRC, launch

    B, S = ids.shape
    V, D = table.shape
    launch("embedding_bag", "embedding_bag_fwd",
           [ids, weights, table, out, B, S, V, D, int(mean), KERNEL_DTYPES[table.dtype]],
           table.device, CSRC if csrc is None else csrc)


def launch_embedding_bag_backward(plan, weights, g, grad_table, S: int) -> None:
    """Launch the backward kernel into a preallocated ``grad_table``
    (every row written) on the current stream, from the ids' segment plan
    over the flattened (B * S) positions, the flattened weights (or None)
    and g' (B, D) — no checks and no launch count (for timing the kernel
    alone)."""
    from repro_torch.kernels.build import CSRC, launch

    V, D = grad_table.shape
    launch("embedding_bag", "embedding_bag_bwd",
           [g, plan.order, weights, plan.offsets, *long_args(plan), grad_table, V, D, S],
           g.device, CSRC)
