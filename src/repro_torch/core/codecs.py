"""Vectorized integer codecs used by the index storage layer.

The paper stores postings as compressed streams on disk and reports the
*data read size per query* (Figs. 7/9). We reproduce that metric with a
classic varbyte (VB) codec plus zigzag/delta transforms, implemented as
vectorized numpy (no per-value Python loops) so that the Idx1 baseline —
which decodes millions of postings per query — runs at C speed.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "varbyte_encode",
    "varbyte_decode",
    "zigzag_encode",
    "zigzag_decode",
    "delta_encode",
    "delta_decode",
]

_MAX_VB_BYTES = 10  # enough for uint64


def varbyte_encode(values: np.ndarray) -> bytes:
    """Encode an array of unsigned integers with MSB-continuation varbyte.

    Big-endian 7-bit groups; every byte except the last of a value has the
    high bit set. Fully vectorized.
    """
    v = np.ascontiguousarray(values, dtype=np.uint64)
    if v.size == 0:
        return b""
    nb = np.ones(v.size, np.int64)
    for k in range(1, _MAX_VB_BYTES):
        nb += (v >= np.uint64(1) << np.uint64(7 * k)).astype(np.int64)
    ends = np.cumsum(nb)
    total = int(ends[-1])
    starts = ends - nb
    owner = np.repeat(np.arange(v.size, dtype=np.int64), nb)
    offset_in = np.arange(total, dtype=np.int64) - starts[owner]
    shift = ((nb[owner] - 1 - offset_in) * 7).astype(np.uint64)
    byte = ((v[owner] >> shift) & np.uint64(0x7F)).astype(np.uint8)
    cont = (offset_in < nb[owner] - 1).astype(np.uint8) << 7
    return (byte | cont).tobytes()


def varbyte_decode(buf: bytes | np.ndarray) -> np.ndarray:
    """Decode a varbyte stream back to uint64 values. Vectorized by
    grouping values by their byte count (<= _MAX_VB_BYTES passes)."""
    b = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
    if b.size == 0:
        return np.zeros(0, np.uint64)
    is_last = (b & 0x80) == 0
    ends = np.nonzero(is_last)[0]
    n = ends.size
    starts = np.empty(n, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    nb = ends - starts + 1
    vals = np.zeros(n, np.uint64)
    payload = (b & 0x7F).astype(np.uint64)
    max_nb = int(nb.max())
    for k in range(1, max_nb + 1):
        sel = np.nonzero(nb == k)[0]
        if sel.size == 0:
            continue
        s = starts[sel]
        acc = np.zeros(sel.size, np.uint64)
        for j in range(k):
            acc = (acc << np.uint64(7)) | payload[s + j]
        vals[sel] = acc
    return vals


def zigzag_encode(values: np.ndarray) -> np.ndarray:
    """Map signed -> unsigned: 0,-1,1,-2,... -> 0,1,2,3,..."""
    v = np.asarray(values, dtype=np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def zigzag_decode(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values, dtype=np.uint64)
    return ((v >> np.uint64(1)).astype(np.int64)) ^ -((v & np.uint64(1)).astype(np.int64))


def delta_encode(values: np.ndarray) -> np.ndarray:
    """First-order delta; first element kept absolute. Input must be
    non-decreasing for unsigned round-trip (use zigzag otherwise)."""
    v = np.asarray(values, dtype=np.int64)
    out = np.empty_like(v)
    if v.size == 0:
        return out.astype(np.uint64)
    out[0] = v[0]
    np.subtract(v[1:], v[:-1], out=out[1:])
    return out.astype(np.uint64)


def delta_decode(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values, dtype=np.uint64).astype(np.int64)
    return np.cumsum(v)
