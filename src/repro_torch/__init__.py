"""PyTorch/CUDA port of the proximity-search serving system.

A second package beside the JAX reference ``repro``: it imports
``torch`` and ``numpy`` only, keeps its own copies of the reference's
framework-free modules under the same relative paths, and runs its
entry points on the card unless the caller passes ``device="cpu"``.
"""
