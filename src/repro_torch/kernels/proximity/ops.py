"""Dispatch wrapper for the proximity window join ``|a - b| <= d``.

:func:`proximity_join` is the reference package's entry point
(``kernels/proximity/ops.py``). It runs where its tensors lie: on a card,
the hand-written CUDA kernel ``csrc/proximity.cu`` (the port of the Pallas
``proximity_pallas``); on the CPU, the plain version
:func:`proximity_plain`. There is no knob that routes a CUDA tensor to
the plain version and no fallback from a failed kernel to it.
``proximity_join.launches`` counts the kernel launches.

The reference's arguments map as follows. ``d`` is MaxDistance.
``block_a``, ``block_b`` and ``k_tiles`` keep their meaning, and they set
the result, not only the speed: element i of ``a`` is searched for only
inside the b-window of its A-block, whose start is planned at the block's
first element minus ``d`` (:func:`plan_starts`), so a ``k_tiles`` below
:func:`plan_k_tiles` gives the same truncated answer as the Pallas kernel.
``k_tiles=None`` scans all of ``b``. ``use_pallas`` and ``interpret`` are
gone: the reference's ``use_pallas=False`` oracle is
:func:`repro_torch.kernels.proximity.ref.proximity_join_ref`. Distances
are taken in 64 bits, where the Pallas kernel's int32 ``a - b`` can wrap
for values far apart. Entry points given numpy arrays run on ``device``,
the card unless the caller names another.

Under a cost count (:mod:`repro_torch.obs.cost`) :func:`proximity_join`
reports its work and returns uninitialised outputs, launching nothing:
PERF.md's bound, a and b read once, the mask and both bounds written once,
4 operations per element of a and b.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import (
    SENTINEL,
    as_tensor,
    cdiv,
    check_sorted_pair,
    resolve_k_tiles,
    window_bounds,
)
from repro_torch.obs.cost import counting, kernel_work

DEFAULT_BLOCK_A = 512
DEFAULT_BLOCK_B = 1024


def plan_starts(a_padded: torch.Tensor, b_padded: torch.Tensor, d: int, block_a: int,
                block_b: int) -> torch.Tensor:
    """Aligned B-block start per A-block: the b-block holding the lower
    bound of the A-block's first element minus ``d``. Padding ``a`` or
    ``b`` with SENTINEL leaves the result unchanged."""
    a_mins = a_padded[::block_a].long() - d
    return (torch.searchsorted(b_padded.long(), a_mins) // block_b).to(torch.int32)


def plan_k_tiles(a: np.ndarray, b: np.ndarray, d: int, block_a: int = DEFAULT_BLOCK_A,
                 block_b: int = DEFAULT_BLOCK_B) -> int:
    """Exact static bound on B-blocks any A-block's ``d``-widened range can
    span (host-side, concrete arrays). Never < 1."""
    a, b = np.asarray(a), np.asarray(b)
    if a.size == 0 or b.size == 0:
        return 1
    k = 1
    for i in range(cdiv(a.size, block_a)):
        blk = a[i * block_a:(i + 1) * block_a]
        lo = int(np.searchsorted(b, blk[0] - d)) // block_b
        hi = int(np.searchsorted(b, blk[-1] + d, side="right"))
        hi_blk = max(lo, cdiv(max(hi, 1), block_b) - 1)
        k = max(k, hi_blk - lo + 1)
    return int(k)


def proximity_plain(a: torch.Tensor, b: torch.Tensor, d: int, *,
                    block_a: int = DEFAULT_BLOCK_A, block_b: int = DEFAULT_BLOCK_B,
                    k_tiles: int | None = None):
    """The plain PyTorch version of :func:`proximity_join`, on any device.
    Inside an element's window the b-values within ``d`` of it, SENTINEL
    excluded, form one run ``[l, h)``: the global bounds of ``a - d`` and
    ``min(a + d, SENTINEL - 1)`` clamped to the window."""
    check_sorted_pair(a, b, block_a, block_b)
    na, nb = a.shape[0], b.shape[0]
    k = resolve_k_tiles(cdiv(nb, block_b), k_tiles)
    w_lo, w_hi = window_bounds(plan_starts(a, b, d, block_a, block_b), na, nb,
                               block_a, block_b, k)
    a64, b64 = a.long(), b.long()
    top = (a64 + d).clamp(max=SENTINEL - 1)
    lo = torch.minimum(torch.maximum(torch.searchsorted(b64, a64 - d), w_lo), w_hi)
    hi = torch.minimum(torch.maximum(torch.searchsorted(b64, top, right=True), w_lo), w_hi)
    mask = (hi > lo) & (a != SENTINEL)
    b_lo = torch.where(mask, b[lo.clamp(max=nb - 1)], a)
    b_hi = torch.where(mask, b[(hi - 1).clamp(0, nb - 1)], a)
    return mask, b_lo, b_hi


def proximity_join(a, b, d: int, *, block_a: int = DEFAULT_BLOCK_A,
                   block_b: int = DEFAULT_BLOCK_B, k_tiles: int | None = None, device=None):
    """For each a_i: (is there a b within d, min matched b, max matched b),
    searched inside a_i's window; where there is no match, both bounds
    are a_i itself. Tensors on a card go through the CUDA kernel, tensors
    on the CPU through :func:`proximity_plain`; ``a`` and ``b`` must be
    non-empty."""
    a = as_tensor(a, torch.int32, device)
    b = as_tensor(b, torch.int32, a.device)
    check_sorted_pair(a, b, block_a, block_b)
    k = resolve_k_tiles(cdiv(b.shape[0], block_b), k_tiles)
    if abs(int(d)) >= 2**31:
        raise ValueError(f"d out of int32 range: {d}")
    if counting():
        na, nb = a.shape[0], b.shape[0]
        kernel_work("proximity.proximity_join", flops=4 * (na + nb),
                    bytes_accessed=4 * na + 4 * nb + 9 * na)
        return (torch.empty_like(a, dtype=torch.bool), torch.empty_like(a),
                torch.empty_like(a))
    if not a.is_cuda:
        return proximity_plain(a, b, d, block_a=block_a, block_b=block_b, k_tiles=k)
    mask = torch.empty_like(a, dtype=torch.bool)
    lo = torch.empty_like(a)
    hi = torch.empty_like(a)
    launch_proximity(a, b, mask, lo, hi, d=d, block_a=block_a, block_b=block_b, k_tiles=k)
    proximity_join.launches += 1
    return mask, lo, hi


proximity_join.launches = 0


def launch_proximity(a, b, mask, lo, hi, *, d: int, block_a: int, block_b: int,
                     k_tiles: int, csrc=None) -> None:
    """Launch the CUDA kernel into preallocated outputs on the current
    stream — no checks and no launch count: the wrapper's inner step,
    exposed for timing the kernel alone (``csrc``: another source
    directory, as in :mod:`repro_torch.kernels.build`)."""
    from repro_torch.kernels.build import CSRC, launch

    launch("proximity", "proximity_join_raw",
           [a, b, mask, lo, hi, a.shape[0], b.shape[0], d, block_a, block_b, k_tiles],
           a.device, CSRC if csrc is None else csrc)
