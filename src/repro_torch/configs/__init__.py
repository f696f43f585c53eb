"""Architecture and shape registry of the model zoo (the reference's
``configs/``): the LM and recsys families so far. ``registry``, the GNN
family and the search config come with the training slice."""
