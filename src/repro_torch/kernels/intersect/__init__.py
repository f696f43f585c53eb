"""Windowed sorted-list intersection (the paper's Equalize), raw and delta16."""

from repro_torch.kernels.intersect.ops import (  # noqa: F401
    intersect_compressed_plain,
    intersect_compressed_streams,
    intersect_plain,
    intersect_sorted,
    intersect_sorted_compressed,
    pack_compressed,
    pack_compressed_torch,
    pack_delta_stream,
    plan_k_tiles,
    plan_starts,
)
