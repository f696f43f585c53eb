"""Index state: array (de)serialization and carrying a reference index
across into this package (``carry_index``)."""

from repro_torch.index.persist import carry_index, index_from_arrays, index_to_arrays  # noqa: F401
