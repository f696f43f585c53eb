"""Shared helpers for the port's kernels and device code.

Every hand-written kernel of this package follows one contract:
* its wrapper takes the plain PyTorch version for tensors on the CPU and
  launches the CUDA kernel for tensors on a card — there is no fallback
  from one to the other;
* the plain version sits beside the wrapper, and the tests hold it
  against the JAX reference package on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

# Sentinel for padded posting slots: larger than any real doc id / packed
# (doc, pos) key, still valid int32.
SENTINEL = 2**31 - 1
MAX_LEN = 2**31 - 2**21  # the windowed kernels index with int32


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


def check_blocks(block_a: int, block_b: int) -> None:
    if block_a < 1 or block_b < 1:
        raise ValueError(f"block sizes must be positive, got {block_a}, {block_b}")


def resolve_k_tiles(n_b_blocks: int, k_tiles) -> int:
    """``k_tiles``, or a full scan of the ``n_b_blocks`` b-blocks for None."""
    if k_tiles is None:
        return n_b_blocks
    if k_tiles < 1:
        raise ValueError(f"k_tiles must be >= 1, got {k_tiles}")
    return int(k_tiles)


def check_sorted_pair(a: torch.Tensor, b: torch.Tensor, block_a: int, block_b: int) -> None:
    """What the windowed kernels take: two non-empty 1-D int32 tensors on
    one device, short enough for int32 indexing. The reference's entry
    points fail on an empty input; the port raises ValueError there."""
    check_blocks(block_a, block_b)
    for name, t in (("a", a), ("b", b)):
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
        if t.shape[0] == 0:
            raise ValueError(f"{name} is empty")
        if t.shape[0] > MAX_LEN:
            raise ValueError(f"{name} has {t.shape[0]} elements, more than {MAX_LEN}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device} and b on {b.device}")


def window_bounds(starts: torch.Tensor, n_a: int, n_b: int, block_a: int,
                  block_b: int, k_tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The b-window ``[w_lo, w_hi)`` (int64, one per element of ``a``) that
    the reference's blocked kernels (intersect, proximity) search: element
    i lies in A-block ``i // block_a``, which visits the b-blocks
    ``min(starts[blk] + k, nb_blocks - 1)`` for k in ``[0, k_tiles)``, b cut
    into ``nb_blocks = cdiv(n_b, block_b)`` blocks; the window ends at the
    ``n_b`` elements of b."""
    last = cdiv(n_b, block_b) - 1
    s = starts.long().repeat_interleave(block_a)[:n_a]
    w_lo = s.clamp(max=last) * block_b
    w_hi = (((s + (k_tiles - 1)).clamp(max=last) + 1) * block_b).clamp(max=n_b)
    return w_lo, w_hi


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


def as_tensor(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``x`` as a contiguous tensor of ``dtype``. A tensor stays on its
    device unless ``device`` names another; anything else (numpy arrays,
    lists) goes to ``resolve_device(device)``, the card by default. A
    tensor that already qualifies comes back as it is, with no copy and no
    call into PyTorch's dispatcher."""
    if isinstance(x, torch.Tensor):
        if x.dtype == dtype and (device is None or x.device == device) and x.is_contiguous():
            return x
        dev = x.device if device is None else resolve_device(device)
    else:
        dev = resolve_device(device)
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=dtype).contiguous()
