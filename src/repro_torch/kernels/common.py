"""Shared helpers for the port's kernels and device code.

Every hand-written kernel of this package follows one contract:
* its wrapper takes the plain PyTorch version for tensors on the CPU and
  launches the CUDA kernel for tensors on a card — there is no fallback
  from one to the other;
* the plain version sits beside the wrapper, and the tests hold it
  against the JAX reference package on the CPU.
"""

from __future__ import annotations

import torch

# Sentinel for padded posting slots: larger than any real doc id / packed
# (doc, pos) key, still valid int32.
SENTINEL = 2**31 - 1


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to_multiple(x: torch.Tensor, multiple: int, fill) -> torch.Tensor:
    """Pad the last axis of ``x`` with ``fill`` up to a multiple."""
    n = x.shape[-1]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = torch.full(x.shape[:-1] + (rem,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=-1)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. A missing card raises instead of quietly serving on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return dev
