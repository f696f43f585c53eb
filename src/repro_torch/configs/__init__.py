"""Architecture and shape registry of the model zoo (the reference's
``configs/``): the LM, GNN and recsys families, the search arch, and
``registry.get_arch`` over all of them."""
