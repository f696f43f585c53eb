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
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import as_tensor

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
    :func:`embedding_bag_plain`; ids and weights follow the table."""
    dtype = table.dtype if isinstance(table, torch.Tensor) else torch.float32
    table = as_tensor(table, dtype, device)
    ids = as_tensor(ids, torch.int32, table.device)
    if weights is not None:
        weights = as_tensor(weights, torch.float32, table.device)
    _check(ids, table, weights, combine)
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
