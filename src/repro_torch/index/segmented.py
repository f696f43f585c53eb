"""Snapshot identity for external caches (DESIGN.md §11).

The segmented, incrementally built index itself arrives with a later
slice of the port; the serving caches already key their entries on
``snapshot_token`` so that slice plugs in without touching them."""

from __future__ import annotations


def snapshot_token(index) -> int:
    """Stable identity of an immutable searcher view, for external caches
    (e.g. the serving layer's packed-posting cache, DESIGN.md §11).

    A segmented view carries a process-unique ``snapshot_id`` minted at
    construction — two distinct snapshots never share a token, even if one
    is garbage-collected and the other reuses its memory. Static
    ``ProximityIndex`` objects are immutable for their lifetime, so their
    ``id()`` is a valid token as long as the caller keeps a reference
    (serving engines do). A mutable segmented index delegates to its
    current published snapshot."""
    tok = getattr(index, "snapshot_id", None)
    if tok is not None:
        return tok
    if hasattr(index, "snapshot"):
        return index.snapshot().snapshot_id
    return id(index)
