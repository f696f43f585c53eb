"""Proximity window join |a - b| <= d (fragment bounds of a match)."""

from repro_torch.kernels.proximity.ops import (  # noqa: F401
    plan_k_tiles,
    plan_starts,
    proximity_join,
    proximity_plain,
)
