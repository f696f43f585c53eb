"""Searchsorted oracle for sorted posting-list intersection.

Semantics: for each element of sorted tensor ``a``, is it present in
sorted tensor ``b``? (Padding slots hold SENTINEL and never match.) This
is the vectorized Equalize (paper §2.3): aligning posting iterators on
document ids is computing membership of one sorted doc-id list in
another. It searches all of ``b``, with no window.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import SENTINEL


def intersect_mask_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (n,) sorted int32; b: (m,) sorted int32 -> bool (n,) membership."""
    return intersect_idx_ref(a, b)[0]


def intersect_idx_ref(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Also return, per element of a, the index in b of the match (-1 if none)."""
    idx = torch.searchsorted(b, a)
    idx_c = idx.clamp(0, b.shape[0] - 1)
    found = (idx < b.shape[0]) & (b[idx_c] == a) & (a != SENTINEL)
    return found, torch.where(found, idx_c, -1).to(torch.int32)
