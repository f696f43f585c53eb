"""Weighted embedding bag: sum or mean of table rows per bag."""

from repro_torch.kernels.embedding_bag.ops import (  # noqa: F401
    embedding_bag,
    embedding_bag_plain,
)
