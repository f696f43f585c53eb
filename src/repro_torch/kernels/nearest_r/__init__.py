"""Batched r-nearest window-membership join (QT3/QT4/QT5 hot loop)."""

from repro_torch.kernels.nearest_r.ops import (  # noqa: F401
    plan_k_tiles,
    window_join,
    window_join_plain,
)
