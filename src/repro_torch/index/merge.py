"""Sorted-array helpers shared by the serving caches."""

from __future__ import annotations

import numpy as np


def isin_sorted(sorted_arr: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Vectorized membership of `values` in sorted `sorted_arr`."""
    if sorted_arr.size == 0:
        return np.zeros(values.shape, bool)
    i = np.searchsorted(sorted_arr, values)
    ic = np.clip(i, 0, sorted_arr.size - 1)
    return (i < sorted_arr.size) & (sorted_arr[ic] == values)
