"""Searchsorted oracle for the proximity window join.

Given two sorted position tensors (packed global positions: doc * stride +
pos, padding = SENTINEL), for each a_i: does b contain a position within
MaxDistance? Returns (mask, nearest_lo, nearest_hi) where nearest_lo/hi
are the min/max matched b-positions used for fragment bounds [P, E]. It
searches all of ``b``, with no window.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import SENTINEL


def _bounds(a: torch.Tensor, b: torch.Tensor, d: int):
    return (torch.searchsorted(b, a - d, side="left"),
            torch.searchsorted(b, a + d, side="right"))


def proximity_join_ref(a: torch.Tensor, b: torch.Tensor, d: int):
    m = b.shape[0]
    lo_idx, hi_idx = _bounds(a, b, d)
    mask = (hi_idx - lo_idx > 0) & (a != SENTINEL)
    lo_c = lo_idx.clamp(0, m - 1)
    hi_c = (hi_idx - 1).clamp(0, m - 1)
    return mask, torch.where(mask, b[lo_c], a), torch.where(mask, b[hi_c], a)


def proximity_count_ref(a: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """Number of b-positions within distance d of each a (multiplicity
    support for repeated query lemmas)."""
    lo_idx, hi_idx = _bounds(a, b, d)
    return torch.where(a != SENTINEL, hi_idx - lo_idx, 0)
