"""The table of peaks and the roofline arithmetic of the benchmark.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full
700 W): 3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores.
``window_bound`` is a copy of ``chip_smoke.py``'s: each input byte read
once and each output byte written once over the memory rate, against the
operations over the 32-bit rate."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12


def window_bound(n_in_bytes: int, n_out_bytes: int, ops: float) -> dict:
    """Least time on the card for the bytes and operations given."""
    bytes_ms = (n_in_bytes + n_out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    return {"bytes": int(n_in_bytes + n_out_bytes), "ops": int(ops), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def window_join_bytes(B: int, L: int, r_bytes: int) -> tuple[int, int]:
    """(read, written) bytes that any window join of these argument shapes
    must move: every anchor lane (int32) read once, the multiplicity
    vectors read once, and every lane's (valid, lo, hi) written once. How
    much of the key rows and stop aggregates a launch needs depends on
    the values, which the shapes do not give, so they are not counted:
    this is a floor, and the share it gives cannot pass 100%."""
    return 4 * B * L + r_bytes, B * L * (1 + 4 + 4)


def share(read: int, written: int, seconds: float) -> float:
    """Percent of the roofline: ``window_bound``'s least time for the bytes
    over the time measured."""
    return 100.0 * window_bound(read, written, 0)["bound_ms"] / 1e3 / seconds


def qt1_step_bytes(B: int, L: int, top_k: int) -> tuple[int, int]:
    """(read, written) bytes that any QT1 step of B queries at L-bucket L
    must move: the anchor key's g row read once (every lane is looked at to
    find the live ones), the per-query idf sum and span adjustment read
    once, the top-k (score, g, lo, hi) written once. The other keys' rows
    are probed only where the anchor has a live lane, which the shapes do
    not give: this is a floor."""
    return 4 * B * L + 8 * B, 16 * B * top_k
