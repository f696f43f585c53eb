"""Segmented incremental indexing (LSM-style) for the paper's composite
index: memtable absorption, immutable sealed segments with on-disk
persistence, tombstone deletes, size-tiered and leveled compaction (inline
or on a background executor), a ``ProximityIndex``-compatible merged read
facade for live-refresh serving, and carrying an index across from the
reference package (``carry_index``).
"""

from repro_torch.index.background import CompactionExecutor, CompactionJob
from repro_torch.index.compaction import leveled_plan, merge_segments, size_tiered_plan
from repro_torch.index.persist import (
    carry_index,
    index_from_arrays,
    index_to_arrays,
    load_index,
    save_index,
    write_json_atomic,
)
from repro_torch.index.segment import MemSegment, Segment
from repro_torch.index.segmented import SegmentedIndex, SegmentedView, snapshot_token

__all__ = [
    "CompactionExecutor",
    "CompactionJob",
    "MemSegment",
    "Segment",
    "SegmentedIndex",
    "SegmentedView",
    "carry_index",
    "index_from_arrays",
    "index_to_arrays",
    "leveled_plan",
    "merge_segments",
    "size_tiered_plan",
    "save_index",
    "load_index",
    "snapshot_token",
    "write_json_atomic",
]
