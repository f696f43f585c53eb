"""Dispatch wrappers for the windowed sorted-list intersection (Equalize).

Two entry points, as in the reference package's ``kernels/intersect/ops.py``:

- :func:`intersect_sorted` — membership of sorted ``a`` in sorted ``b``
  plus the index of the first match, on int32 tensors;
- :func:`intersect_sorted_compressed` — the same membership (mask only)
  from host arrays that are packed into delta16 streams on the host and
  decoded on the device.

Each runs where its tensors lie: on a card, the hand-written CUDA kernels
of ``csrc/intersect.cu`` (the port of the Pallas ``intersect_pallas`` and
``intersect_pallas_compressed``); on the CPU, the plain versions
:func:`intersect_plain` and :func:`intersect_compressed_plain`. There is
no knob that routes a CUDA tensor to a plain version and no fallback from
a failed kernel to one. ``intersect_sorted.launches`` and
``intersect_sorted_compressed.launches`` count the kernel launches.

The reference's arguments map as follows. ``block_a``, ``block_b`` and
``k_tiles`` keep their meaning, and they set the result, not only the
speed: element i of ``a`` is searched for only inside the b-window of its
A-block (:func:`repro_torch.kernels.common.window_bounds`), so a
``k_tiles`` below :func:`plan_k_tiles` gives the same truncated answer as
the Pallas kernel. ``k_tiles=None`` scans all of ``b``. ``use_pallas`` and
``interpret`` are gone: the reference's ``use_pallas=False`` oracle is
:func:`repro_torch.kernels.intersect.ref.intersect_idx_ref`. Entry points
given numpy arrays run on ``device``, the card unless the caller names
another.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import (
    MAX_LEN,
    SENTINEL,
    as_tensor,
    cdiv,
    check_blocks,
    check_sorted_pair,
    resolve_device,
    resolve_k_tiles,
    window_bounds,
)

DEFAULT_BLOCK_A = 512
DEFAULT_BLOCK_B = 1024
DELTA_BLK = 64  # postings per delta-coding block
PAD_DELTA = 2**16 - 1  # uint16 marker for padding slots
_PAD_KEY = 2**40  # a decoded pad slot: above every int32, so it sorts last


def plan_starts(a_padded: torch.Tensor, b_padded: torch.Tensor, block_a: int,
                block_b: int) -> torch.Tensor:
    """Aligned B-block start per A-block: the b-block holding the lower
    bound of the A-block's first element. Padding ``a`` or ``b`` with
    SENTINEL leaves the result unchanged."""
    a_mins = a_padded[::block_a].contiguous()
    return (torch.searchsorted(b_padded, a_mins) // block_b).to(torch.int32)


def plan_k_tiles(a: np.ndarray, b: np.ndarray, block_a: int = DEFAULT_BLOCK_A,
                 block_b: int = DEFAULT_BLOCK_B) -> int:
    """Exact static bound on B-blocks any A-block can span (host-side,
    concrete arrays): max over blocks of ceil span. Never < 1."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.size == 0 or b.size == 0:
        return 1
    na = cdiv(a.size, block_a)
    k = 1
    for i in range(na):
        blk = a[i * block_a:(i + 1) * block_a]
        lo = int(np.searchsorted(b, blk[0])) // block_b
        hi = int(np.searchsorted(b, blk[-1], side="right"))
        hi_blk = max(lo, cdiv(max(hi, 1), block_b) - 1)
        k = max(k, hi_blk - lo + 1)
    return int(k)


def pack_delta_stream(x: np.ndarray, total_len: int):
    """Host/offline packing: sorted int32 postings -> (base int32 per 64,
    delta uint16, padded to total_len). Raises if an in-block span exceeds
    uint16 (indexing then splits the block)."""
    x = np.asarray(x, np.int64)
    if total_len % DELTA_BLK:
        raise ValueError(f"total_len {total_len} is not a multiple of {DELTA_BLK}")
    nb = total_len // DELTA_BLK
    padded = np.full(total_len, 0, np.int64)
    padded[:x.size] = x
    blocks = padded.reshape(nb, DELTA_BLK)
    base = blocks[:, 0].copy()
    # blocks fully in padding get base 0
    if x.size:
        last_real_block = (x.size - 1) // DELTA_BLK
        base[last_real_block + 1:] = 0
    delta = blocks - base[:, None]
    if x.size and delta[:last_real_block + 1].max() >= PAD_DELTA:
        raise ValueError("in-block span exceeds uint16")
    delta = np.clip(delta, 0, PAD_DELTA).astype(np.uint16)
    flat = delta.reshape(-1)
    flat[x.size:] = PAD_DELTA  # pad marker
    return base.astype(np.int32), flat


# -- raw streams -----------------------------------------------------------------
def intersect_plain(a: torch.Tensor, b: torch.Tensor, *, block_a: int = DEFAULT_BLOCK_A,
                    block_b: int = DEFAULT_BLOCK_B, k_tiles: int | None = None):
    """The plain PyTorch version of :func:`intersect_sorted`, on any
    device: per element of ``a``, whether it lies in its b-window and is
    not SENTINEL, and the first matching position in the window (-1 where
    none). The lower bound inside the window is the global lower bound
    clamped to it."""
    check_sorted_pair(a, b, block_a, block_b)
    na, nb = a.shape[0], b.shape[0]
    k = resolve_k_tiles(cdiv(nb, block_b), k_tiles)
    w_lo, w_hi = window_bounds(plan_starts(a, b, block_a, block_b), na, nb,
                               block_a, block_b, k)
    pos = torch.minimum(torch.maximum(torch.searchsorted(b, a), w_lo), w_hi)
    hit = (pos < w_hi) & (b[pos.clamp(max=nb - 1)] == a) & (a != SENTINEL)
    return hit, torch.where(hit, pos, -1).to(torch.int32)


def intersect_sorted(a, b, *, block_a: int = DEFAULT_BLOCK_A, block_b: int = DEFAULT_BLOCK_B,
                     k_tiles: int | None = None, device=None):
    """Membership of each element of sorted ``a`` in sorted ``b``.

    Returns (mask bool, idx int32) of length len(a): idx is the first
    matching position in ``b`` (the same in the padded b of the
    reference) inside the element's window, -1 where mask is False.
    Tensors on a card go through the CUDA kernel, tensors on the CPU
    through :func:`intersect_plain`; ``a`` and ``b`` must be non-empty."""
    a = as_tensor(a, torch.int32, device)
    b = as_tensor(b, torch.int32, a.device)
    check_sorted_pair(a, b, block_a, block_b)
    k = resolve_k_tiles(cdiv(b.shape[0], block_b), k_tiles)
    if not a.is_cuda:
        return intersect_plain(a, b, block_a=block_a, block_b=block_b, k_tiles=k)
    mask = torch.empty_like(a, dtype=torch.bool)
    idx = torch.empty_like(a)
    launch_intersect(a, b, mask, idx, block_a=block_a, block_b=block_b, k_tiles=k)
    intersect_sorted.launches += 1
    return mask, idx


intersect_sorted.launches = 0


def launch_intersect(a, b, mask, idx, *, block_a: int, block_b: int, k_tiles: int,
                     csrc=None) -> None:
    """Launch the raw kernel into preallocated outputs on the current
    stream — no checks and no launch count: the wrapper's inner step,
    exposed for timing the kernel alone (``csrc``: another source
    directory, as in :mod:`repro_torch.kernels.build`)."""
    from repro_torch.kernels.build import CSRC, launch

    launch("intersect", "intersect_raw",
           [a, b, mask, idx, a.shape[0], b.shape[0], block_a, block_b, k_tiles], a.device,
           CSRC if csrc is None else csrc)


# -- delta16 streams -------------------------------------------------------------
def pack_compressed(a: np.ndarray, b: np.ndarray, *, block_a: int = DEFAULT_BLOCK_A,
                    block_b: int = DEFAULT_BLOCK_B):
    """Host side of :func:`intersect_sorted_compressed`, as the reference
    does it: ``(a_base, a_delta, b_base, b_delta, starts)`` numpy arrays,
    each stream padded to a whole number of blocks (at least one), the
    starts planned by ``np.searchsorted`` on the unpadded ``b`` at each
    A-block's base."""
    check_blocks(block_a, block_b)
    if block_a % DELTA_BLK or block_b % DELTA_BLK:
        raise ValueError(f"block sizes must be multiples of {DELTA_BLK}, "
                         f"got {block_a}, {block_b}")
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    la = cdiv(max(a.size, 1), block_a) * block_a
    lb = cdiv(max(b.size, 1), block_b) * block_b
    if max(la, lb) > MAX_LEN:
        raise ValueError(f"streams of {la} and {lb} elements exceed {MAX_LEN}")
    a_base, a_delta = pack_delta_stream(a, la)
    b_base, b_delta = pack_delta_stream(b, lb)
    starts = (np.searchsorted(b, a_base[::block_a // DELTA_BLK]) // block_b).astype(np.int32)
    return a_base, a_delta, b_base, b_delta, starts


def device_streams(streams, device) -> list[torch.Tensor]:
    """The packed streams of :func:`pack_compressed` as tensors on
    ``device``; the uint16 deltas travel as their raw bits in int16."""
    return [torch.from_numpy(x.view(np.int16) if x.dtype == np.uint16 else x).to(device)
            for x in streams]


def _decode(base: torch.Tensor, delta: torch.Tensor):
    """A delta16 stream as int32 values (wrapping as the reference's do)
    and its pad flags; ``delta`` holds raw uint16 bits as int16 or uint16."""
    d = delta.to(torch.int32) & 0xFFFF
    return base.repeat_interleave(DELTA_BLK) + d, d == PAD_DELTA


def intersect_compressed_plain(a_base, a_delta, b_base, b_delta, starts, n: int, *,
                               block_a: int, block_b: int, k_tiles: int) -> torch.Tensor:
    """The plain PyTorch version of the compressed kernel, on any device:
    the membership mask of the first ``n`` elements of the decoded a
    stream. A pad slot of b reads as +infinity, so the decoded b stays
    sorted and padding never matches."""
    a, a_pad = _decode(a_base, a_delta)
    b, b_pad = _decode(b_base, b_delta)
    b_key = torch.where(b_pad, _PAD_KEY, b.long())
    a, a_pad = a[:n].long(), a_pad[:n]
    lb = b_key.shape[0]
    w_lo, w_hi = window_bounds(starts, n, lb, block_a, block_b, k_tiles)
    pos = torch.minimum(torch.maximum(torch.searchsorted(b_key, a), w_lo), w_hi)
    return ~a_pad & (pos < w_hi) & (b_key[pos.clamp(max=lb - 1)] == a)


def intersect_sorted_compressed(a, b, *, block_a: int = DEFAULT_BLOCK_A,
                                block_b: int = DEFAULT_BLOCK_B, k_tiles: int | None = None,
                                device=None) -> torch.Tensor:
    """Same contract as :func:`intersect_sorted` (mask only), from host
    arrays: packs them on the host (:func:`pack_compressed`), moves the
    delta16 streams to ``device`` (the card by default) and returns the
    mask there, from the CUDA kernel on a card or from
    :func:`intersect_compressed_plain` on the CPU. Block sizes must be
    multiples of 64; an empty ``a`` gives an empty mask and an empty ``b``
    an all-False one, as in the reference."""
    n = int(np.asarray(a).size)
    streams = pack_compressed(a, b, block_a=block_a, block_b=block_b)
    k = resolve_k_tiles(streams[3].size // block_b, k_tiles)
    dev = resolve_device(device)
    a_base, a_delta, b_base, b_delta, starts = device_streams(streams, dev)
    if dev.type != "cuda":
        return intersect_compressed_plain(a_base, a_delta, b_base, b_delta, starts, n,
                                          block_a=block_a, block_b=block_b, k_tiles=k)
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        launch_intersect_compressed(a_base, a_delta, b_base, b_delta, starts, mask,
                                    block_a=block_a, block_b=block_b, k_tiles=k)
        intersect_sorted_compressed.launches += 1
    return mask


intersect_sorted_compressed.launches = 0


def launch_intersect_compressed(a_base, a_delta, b_base, b_delta, starts, mask, *,
                                block_a: int, block_b: int, k_tiles: int) -> None:
    """Launch the compressed kernel into a preallocated mask on the current
    stream — no checks and no launch count: the wrapper's inner step,
    exposed for timing the kernel alone. The deltas are device tensors
    of raw uint16 bits (int16 or uint16)."""
    from repro_torch.kernels.build import launch

    launch("intersect", "intersect_compressed",
           [a_base, a_delta, b_base, b_delta, starts, mask, mask.shape[0],
            b_delta.shape[0], block_a, block_b, k_tiles], mask.device)
