"""Weighted embedding bag: sum or mean of table rows per bag, and its
gradient."""

from repro_torch.kernels.embedding_bag.ops import (  # noqa: F401
    embedding_bag,
    embedding_bag_backward,
    embedding_bag_backward_plain,
    embedding_bag_plain,
)
