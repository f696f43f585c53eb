"""Segment sum over sorted segment ids: the GNN's scatter-adds and the
bag's backward, in a fixed order on every device."""

from repro_torch.kernels.segment_sum.ops import (  # noqa: F401
    GatherRows,
    SegmentPlan,
    SegmentSum,
    gather_rows,
    segment_plan,
    segment_sum,
    segment_sum_plain,
    take_rows,
)
