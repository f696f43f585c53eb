"""Dispatch wrappers for the windowed sorted-list intersection (Equalize).

Three entry points, as in the reference package's ``kernels/intersect``:

- :func:`intersect_sorted` — membership of sorted ``a`` in sorted ``b``
  plus the index of the first match, on int32 tensors;
- :func:`intersect_compressed_streams` — the same membership (mask only)
  from delta16 streams already packed, the counterpart of the Pallas
  ``intersect_pallas_compressed``;
- :func:`intersect_sorted_compressed` — that membership from plain
  postings, packed into delta16 streams on the device the call runs on
  (:func:`pack_compressed_torch`) and handed to the previous one.

Each runs where its tensors lie: on a card, the hand-written CUDA kernels
of ``csrc/intersect.cu`` (the port of the Pallas ``intersect_pallas`` and
``intersect_pallas_compressed``); on the CPU, the plain versions
:func:`intersect_plain` and :func:`intersect_compressed_plain`. There is
no knob that routes a CUDA tensor to a plain version and no fallback from
a failed kernel to one. ``intersect_sorted.launches``,
``intersect_compressed_streams.launches`` and
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

Under a cost count (:mod:`repro_torch.obs.cost`) the entry points report
their work and return uninitialised outputs, launching nothing:
PERF.md's bound, each input byte read and each output byte written once
(a and b, or the five streams; the mask and the index), and its
operations, 2 (raw) or 3 (delta16) per element of a and b. The packer
of :func:`intersect_sorted_compressed` then skips its span check, which
reads a value back.
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
from repro_torch.obs.cost import counting, kernel_work

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
    if counting():
        na, nb = a.shape[0], b.shape[0]
        kernel_work("intersect.intersect_sorted", flops=2 * (na + nb),
                    bytes_accessed=4 * na + 4 * nb + 5 * na)
        return torch.empty_like(a, dtype=torch.bool), torch.empty_like(a)
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
def _check_delta_blocks(block_a: int, block_b: int) -> None:
    check_blocks(block_a, block_b)
    if block_a % DELTA_BLK or block_b % DELTA_BLK:
        raise ValueError(f"block sizes must be multiples of {DELTA_BLK}, "
                         f"got {block_a}, {block_b}")


def _stream_lengths(n_a: int, n_b: int, block_a: int, block_b: int) -> tuple[int, int]:
    """Padded stream lengths: whole blocks, at least one."""
    la = cdiv(max(n_a, 1), block_a) * block_a
    lb = cdiv(max(n_b, 1), block_b) * block_b
    if max(la, lb) > MAX_LEN:
        raise ValueError(f"streams of {la} and {lb} elements exceed {MAX_LEN}")
    return la, lb


def pack_compressed(a: np.ndarray, b: np.ndarray, *, block_a: int = DEFAULT_BLOCK_A,
                    block_b: int = DEFAULT_BLOCK_B):
    """The reference's host packing, in numpy: ``(a_base, a_delta, b_base,
    b_delta, starts)`` arrays, each stream padded to a whole number of
    blocks (at least one), the starts planned by ``np.searchsorted`` on the
    unpadded ``b`` at each A-block's base. The host counterpart of
    :func:`pack_compressed_torch`."""
    _check_delta_blocks(block_a, block_b)
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    la, lb = _stream_lengths(a.size, b.size, block_a, block_b)
    a_base, a_delta = pack_delta_stream(a, la)
    b_base, b_delta = pack_delta_stream(b, lb)
    starts = (np.searchsorted(b, a_base[::block_a // DELTA_BLK]) // block_b).astype(np.int32)
    return a_base, a_delta, b_base, b_delta, starts


def _postings(x, device: torch.device) -> torch.Tensor:
    """Postings as an int64 tensor on ``device``: int32 and int64 arrays
    travel as they are and widen there, anything else widens on the host
    first, as the reference's ``np.asarray(x, np.int64)`` does."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype not in (np.int32, np.int64):
            x = x.astype(np.int64)
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device).long()


def _pack_delta(x: torch.Tensor, total_len: int):
    """:func:`pack_delta_stream` of int64 ``x`` on its device: the base per
    64 postings (0 for blocks all padding) as int32, the deltas as raw
    uint16 bits in int16 (``PAD_DELTA`` past ``x``), and the largest
    in-block span of the blocks that hold postings (the pad slots of the
    last one included, as in the reference) as a 0-d tensor, None for an
    empty ``x``."""
    n = x.shape[0]
    padded = torch.zeros(total_len, dtype=torch.int64, device=x.device)
    padded[:n] = x
    blocks = padded.view(-1, DELTA_BLK)
    delta = blocks - blocks[:, :1]
    span = delta[:cdiv(n, DELTA_BLK)].max() if n else None
    delta = delta.clamp_(0, PAD_DELTA).view(-1)
    delta[n:] = PAD_DELTA
    return blocks[:, 0].to(torch.int32), delta.to(torch.int16), span


def pack_compressed_torch(a, b, *, block_a: int = DEFAULT_BLOCK_A,
                          block_b: int = DEFAULT_BLOCK_B, device=None):
    """:func:`pack_compressed` with torch ops on ``device`` (the card
    unless the caller names another; a tensor's own device when ``device``
    is None and ``a`` is a tensor): the same five streams, byte for byte,
    as tensors there, the deltas as raw uint16 bits in int16. The postings
    cross to the device as they are (int32 arrays as int32), and the
    starts are planned there by ``torch.searchsorted`` on the unpadded
    ``b``. It reads one number back to the host, the largest in-block span,
    to raise the reference's ``ValueError`` when a span reaches 65535."""
    _check_delta_blocks(block_a, block_b)
    if device is None and isinstance(a, torch.Tensor):
        device = a.device
    dev = resolve_device(device)
    a, b = _postings(a, dev), _postings(b, dev)
    la, lb = _stream_lengths(a.shape[0], b.shape[0], block_a, block_b)
    a_base, a_delta, a_span = _pack_delta(a, la)
    b_base, b_delta, b_span = _pack_delta(b, lb)
    spans = [s for s in (a_span, b_span) if s is not None]
    if spans and not counting() and int(torch.stack(spans).max()) >= PAD_DELTA:
        raise ValueError("in-block span exceeds uint16")
    firsts = a_base[::block_a // DELTA_BLK].long()
    starts = (torch.searchsorted(b, firsts) // block_b).to(torch.int32)
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


def _check_streams(a_base, a_delta, b_base, b_delta, starts, block_a: int,
                   block_b: int) -> tuple[int, int]:
    """What the compressed kernel takes; returns the stream lengths."""
    _check_delta_blocks(block_a, block_b)
    named = (("a_base", a_base), ("a_delta", a_delta), ("b_base", b_base),
             ("b_delta", b_delta), ("starts", starts))
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D tensor")
        if t.device != a_delta.device:
            raise ValueError(f"{name} is on {t.device} and a_delta on {a_delta.device}")
        want = (torch.int16, torch.uint16) if name.endswith("delta") else (torch.int32,)
        if t.dtype not in want:
            raise TypeError(f"{name} must be {' or '.join(map(str, want))}, got {t.dtype}")
    la, lb = a_delta.shape[0], b_delta.shape[0]
    for name, length, block in (("a", la, block_a), ("b", lb, block_b)):
        if length == 0 or length % block:
            raise ValueError(f"the {name} stream's {length} slots are not a whole, non-zero "
                             f"number of blocks of {block}")
        if length > MAX_LEN:
            raise ValueError(f"the {name} stream's {length} slots exceed {MAX_LEN}")
    for name, t, size in (("a_base", a_base, la // DELTA_BLK), ("b_base", b_base, lb // DELTA_BLK),
                          ("starts", starts, la // block_a)):
        if t.shape[0] != size:
            raise ValueError(f"{name} has {t.shape[0]} elements, expected {size}")
    return la, lb


def intersect_compressed_streams(a_base, a_delta, b_base, b_delta, starts, *,
                                 block_a: int = DEFAULT_BLOCK_A, block_b: int = DEFAULT_BLOCK_B,
                                 k_tiles: int | None = 1) -> torch.Tensor:
    """Membership from delta16 streams already packed: the port's
    counterpart of the reference's ``intersect_pallas_compressed``, with
    its arguments and defaults (``k_tiles=None`` scans all of b).

    ``a_base``/``b_base`` hold one int32 base per 64 slots, ``a_delta``/
    ``b_delta`` the in-block deltas as raw uint16 bits (int16 or
    ``torch.uint16``), ``PAD_DELTA`` marking a pad slot, and ``starts`` the
    int32 first b-block of each A-block's window, as
    :func:`pack_compressed_torch` or the reference's ``pack_delta_stream``
    make them. The decoded b, pads read as +infinity, must be sorted.
    Returns the bool mask of the padded length ``len(a_delta)`` on the
    streams' device: from the CUDA kernel on a card, with no wait on the
    host, or from :func:`intersect_compressed_plain` on the CPU."""
    la, lb = _check_streams(a_base, a_delta, b_base, b_delta, starts, block_a, block_b)
    k = resolve_k_tiles(lb // block_b, k_tiles)
    streams = [t.contiguous() for t in (a_base, a_delta, b_base, b_delta, starts)]
    if counting():
        kernel_work("intersect.intersect_compressed_streams", flops=3 * (la + lb),
                    bytes_accessed=sum(t.numel() * t.element_size() for t in streams) + la)
        return torch.empty_like(a_delta, dtype=torch.bool)
    if not a_delta.is_cuda:
        return intersect_compressed_plain(*streams, la, block_a=block_a, block_b=block_b,
                                          k_tiles=k)
    mask = torch.empty_like(a_delta, dtype=torch.bool)
    launch_intersect_compressed(*streams, mask, block_a=block_a, block_b=block_b, k_tiles=k)
    intersect_compressed_streams.launches += 1
    return mask


intersect_compressed_streams.launches = 0


def intersect_sorted_compressed(a, b, *, block_a: int = DEFAULT_BLOCK_A,
                                block_b: int = DEFAULT_BLOCK_B, k_tiles: int | None = None,
                                device=None) -> torch.Tensor:
    """Same contract as :func:`intersect_sorted` (mask only), from plain
    postings (arrays, or tensors): packs them into delta16 streams on
    ``device`` with :func:`pack_compressed_torch` (the card by default, a
    tensor's own device; one host read), runs
    :func:`intersect_compressed_streams` there and cuts
    its mask to ``len(a)``. Block sizes must be multiples of 64; an empty
    ``a`` gives an empty mask and an empty ``b`` an all-False one, as in
    the reference."""
    streams = pack_compressed_torch(a, b, block_a=block_a, block_b=block_b, device=device)
    mask = intersect_compressed_streams(*streams, block_a=block_a, block_b=block_b,
                                        k_tiles=k_tiles)
    if mask.is_cuda:
        intersect_sorted_compressed.launches += 1
    return mask[:len(a)]


intersect_sorted_compressed.launches = 0


def launch_intersect_compressed(a_base, a_delta, b_base, b_delta, starts, mask, *,
                                block_a: int, block_b: int, k_tiles: int, csrc=None) -> None:
    """Launch the compressed kernel into a preallocated mask on the current
    stream — no checks and no launch count: the wrapper's inner step,
    exposed for timing the kernel alone (``csrc``: another source
    directory, as in :mod:`repro_torch.kernels.build`). The deltas are
    device tensors of raw uint16 bits (int16 or uint16); the mask may be
    shorter than the a stream."""
    from repro_torch.kernels.build import CSRC, launch

    launch("intersect", "intersect_compressed",
           [a_base, a_delta, b_base, b_delta, starts, mask, mask.shape[0],
            b_delta.shape[0], block_a, block_b, k_tiles], mask.device,
           CSRC if csrc is None else csrc)
