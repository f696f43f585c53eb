"""Gather oracle for EmbeddingBag (recsys hot path).

A take of the table rows with a masked sum over the bag axis, in the
table's type; ids == -1 are padding and contribute nothing.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(
    ids: torch.Tensor,  # (B, S) int32, -1 = padding
    table: torch.Tensor,  # (V, D)
    weights: torch.Tensor | None = None,  # (B, S) or None
    combine: str = "sum",
) -> torch.Tensor:
    mask = (ids >= 0).to(table.dtype)  # (B, S)
    rows = table[ids.clamp(min=0).long()]  # (B, S, D)
    w = mask if weights is None else mask * weights.to(table.dtype)
    out = torch.einsum("bs,bsd->bd", w, rows)
    if combine == "mean":
        out = out / mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    return out
