"""Dispatch wrapper for the fused nearest-r window join.

One signature, two versions, chosen by where the tensors lie:

- on a card, the hand-written CUDA kernel ``csrc/nearest_r.cu`` (the
  port of the reference package's Pallas ``window_join_pallas``): a block
  per tile of anchor lanes, the stop fold, then per active key the key-row
  window that the tile's anchors can reach, staged in shared memory when
  it fits, a search per lane inside it, the counting rank below, and a
  stop once no lane of the tile is valid;
- on the CPU, :func:`window_join_plain`: the sort-free *counting*
  formulation. One ``searchsorted`` per flattened (query, key) row, then
  the p-th nearest predecessor / q-th nearest successor distances are
  ranked by counting comparisons across the 2·r_max candidate lanes
  instead of sorting a (B, L, 2·r_max) distance tensor per key.

Both reproduce ``ref.window_join_ref`` (and therefore the CPU engine's
``search._nearest_r``) bit-for-bit on valid lanes, including stable
tie-breaking at equal distances: pred_p wins over succ_q iff p <= q,
the column order [idx-1, idx, idx-2, idx+1, ...] of the CPU oracle.
There is no knob that routes a CUDA tensor to the plain version and no
fallback from a failed kernel to it.

Preconditions shared with the rest of the serve path: rows are sorted
ascending, strictly increasing on real values, SENTINEL-padded; ns_r
multiplicities are <= r_max (the packers guarantee both). Anchors need
not be sorted.

Under a cost count (:mod:`repro_torch.obs.cost`) :func:`window_join`
reports its work and returns uninitialised outputs, launching nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import SENTINEL, cdiv
from repro_torch.obs.cost import counting, kernel_work

BIG_DIST = 2**30
R_MAX_LIMIT = 8  # the kernel is instantiated for r_max in 1..8
TILE = 1024  # anchor lanes per block of the kernel (kTile)


def _nearest_r_counting(b_rows, centers, max_sep: int, r, r_max: int):
    """Sort-free twin of ``search._nearest_r``.

    b_rows (N, L) sorted asc (SENTINEL pad), centers (N, L), r (N,).
    Returns (matched, mn, mx) with mn/mx = min/max over (r nearest
    values + center) — identical to the argsort formulation at the
    join level, where lo/hi already bracket the center.
    """
    Lb = b_rows.shape[-1]
    idx = torch.searchsorted(b_rows, centers)
    r1 = r[:, None]
    dp, ds = [], []
    for j in range(1, r_max + 1):
        ip = idx - j
        vp = torch.gather(b_rows, 1, ip.clamp(0, Lb - 1))
        okp = (ip >= 0) & (vp != SENTINEL) & (j <= r1)
        d = centers - vp
        dp.append(torch.where(okp & (d <= max_sep), d, BIG_DIST))
        iq = idx + (j - 1)
        vq = torch.gather(b_rows, 1, iq.clamp(0, Lb - 1))
        okq = (iq < Lb) & (vq != SENTINEL) & (j <= r1)
        d = vq - centers
        ds.append(torch.where(okq & (d <= max_sep), d, BIG_DIST))
    cnt = sum((d != BIG_DIST).to(torch.int32) for d in dp + ds)
    matched = cnt >= r1
    # pred_p is kept iff p + #{succs strictly before it} <= r;
    # tie at equal distance: pred_p before succ_q iff p <= q.
    mn_d = torch.zeros_like(centers)
    mx_d = torch.zeros_like(centers)
    for p in range(1, r_max + 1):
        s_before = sum(
            ((ds[q - 1] < dp[p - 1])
             | ((ds[q - 1] == dp[p - 1]) & (q < p))).to(torch.int32)
            for q in range(1, r_max + 1)
        )
        keep = (dp[p - 1] != BIG_DIST) & (p + s_before <= r1)
        mn_d = torch.maximum(mn_d, torch.where(keep, dp[p - 1], 0))
    for q in range(1, r_max + 1):
        p_before = sum(
            ((dp[p - 1] < ds[q - 1])
             | ((dp[p - 1] == ds[q - 1]) & (p <= q))).to(torch.int32)
            for p in range(1, r_max + 1)
        )
        keep = (ds[q - 1] != BIG_DIST) & (q + p_before <= r1)
        mx_d = torch.maximum(mx_d, torch.where(keep, ds[q - 1], 0))
    return matched, centers - mn_d, centers + mx_d


def _fold_stops(valid, lo, hi, a_g, st_cnt, st_ext, st_r):
    """Elementwise NSW stop-row constraints of ``qt5_join``."""
    for k in range(st_cnt.shape[1]):
        r = st_r[:, k][:, None]
        active = r > 0
        valid = valid & ((st_cnt[:, k] >= r) | ~active)
        ext = torch.where(active, st_ext[:, k], 0)
        lo = torch.minimum(lo, a_g + torch.clamp_max(ext, 0))
        hi = torch.maximum(hi, a_g + torch.clamp_min(ext, 0))
    return valid, lo, hi


def window_join_plain(a_g, ns_g, ns_r, st_cnt=None, st_ext=None, st_r=None, *,
                      max_sep: int, r_max: int):
    """The plain PyTorch version of the fused join, on any device.

    a_g: (B, L) anchor rows; ns_g: (B, Kn, L) non-stop rows; ns_r:
    (B, Kn) multiplicities (0 = inactive key). Optional stop aggregates
    st_cnt/st_ext (B, Ks, L) + st_r (B, Ks). Returns (valid, lo, hi)
    aligned with the anchor, SENTINEL lanes invalid.
    """
    B, Kn, L = ns_g.shape
    valid = a_g != SENTINEL
    lo = a_g
    hi = a_g
    if Kn:
        b_flat = ns_g.reshape(B * Kn, L).contiguous()
        c_flat = a_g[:, None, :].expand(B, Kn, L).reshape(B * Kn, L).contiguous()
        r_flat = ns_r.reshape(B * Kn)
        m, mn, mx = _nearest_r_counting(b_flat, c_flat, max_sep, r_flat, r_max)
        m = m.reshape(B, Kn, L)
        mn = mn.reshape(B, Kn, L)
        mx = mx.reshape(B, Kn, L)
        active = (ns_r > 0)[:, :, None]
        valid = valid & torch.all(m | ~active, dim=1)
        upd = active & m
        lo = torch.minimum(lo, torch.where(upd, mn, lo[:, None, :]).amin(dim=1))
        hi = torch.maximum(hi, torch.where(upd, mx, hi[:, None, :]).amax(dim=1))
    if st_cnt is not None:
        valid, lo, hi = _fold_stops(valid, lo, hi, a_g, st_cnt, st_ext, st_r)
    return valid, lo, hi


def window_join(a_g, ns_g, ns_r, st_cnt=None, st_ext=None, st_r=None, *,
                max_sep: int, r_max: int):
    """Fused ordinary-window + NSW join over all keys at once.

    Same arguments and result as :func:`window_join_plain`. Tensors on a
    card go through the CUDA kernel (``window_join.launches`` counts each
    launch); tensors on the CPU go through the plain version. On invalid
    lanes the kernel's lo/hi may differ from the plain version's: callers
    read only ``(valid, lo[valid], hi[valid])``.

    A multiplicity above ``r_max`` raises ValueError where ``ns_r`` lies
    on the CPU. On a card it is not checked, because reading ``ns_r``
    back would stall the host until the card catches up; the call then
    makes no host synchronisation, and such a lane reads at most
    ``r_max`` candidates per side.
    """
    if counting():
        return _counted(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, r_max)
    if not ns_r.is_cuda and ns_r.numel() and int(ns_r.max()) > r_max:
        raise ValueError(f"ns_r holds a multiplicity above r_max={r_max}")
    if a_g.is_cuda:
        return _window_join_cuda(a_g, ns_g, ns_r, st_cnt, st_ext, st_r,
                                 max_sep=max_sep, r_max=r_max)
    return window_join_plain(a_g, ns_g, ns_r, st_cnt, st_ext, st_r,
                             max_sep=max_sep, r_max=r_max)


window_join.launches = 0


def _counted(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, r_max: int):
    """The join's work under a cost count, with uninitialised outputs and
    no launch (and no multiplicity check, which reads ``ns_r``): every
    input byte read once and the (valid, lo, hi) lanes written once, since
    the bound's count of what the inputs need depends on their values;
    the operations of every (lane, key) pair, as if each were reached."""
    B, Kn, L = ns_g.shape
    Ks = 0 if st_cnt is None else st_cnt.shape[1]
    read = sum(t.numel() * t.element_size()
               for t in (a_g, ns_g, ns_r, st_cnt, st_ext, st_r) if t is not None)
    kernel_work("nearest_r.window_join", flops=B * (Kn + Ks) * L * (2 + 4 * r_max + 4 * r_max**2),
                bytes_accessed=read + B * L * (1 + 4 + 4))
    dev = a_g.device
    return (torch.empty((B, L), dtype=torch.bool, device=dev),
            torch.empty((B, L), dtype=torch.int32, device=dev),
            torch.empty((B, L), dtype=torch.int32, device=dev))


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _window_join_cuda(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, *, max_sep: int,
                      r_max: int):
    dev = a_g.device
    B, L = a_g.shape
    Kn = ns_g.shape[1]
    _check("a_g", a_g, (B, L), dev)
    _check("ns_g", ns_g, (B, Kn, L), dev)
    _check("ns_r", ns_r, (B, Kn), dev)
    if st_cnt is not None:
        Ks = st_cnt.shape[1]
        _check("st_cnt", st_cnt, (B, Ks, L), dev)
        _check("st_ext", st_ext, (B, Ks, L), dev)
        _check("st_r", st_r, (B, Ks), dev)
    if not 1 <= r_max <= R_MAX_LIMIT:
        raise ValueError(f"r_max must be in 1..{R_MAX_LIMIT}, got {r_max}")
    if not 0 <= max_sep < BIG_DIST:
        raise ValueError(f"max_sep out of range: {max_sep}")
    if cdiv(L, TILE) > 65535:
        raise ValueError(f"row length {L} exceeds the kernel's grid limit of "
                         f"{65535 * TILE}")
    valid = torch.empty((B, L), dtype=torch.bool, device=dev)
    lo = torch.empty((B, L), dtype=torch.int32, device=dev)
    hi = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        return valid, lo, hi
    launch_kernel(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, valid, lo, hi,
                  max_sep=max_sep, r_max=r_max)
    window_join.launches += 1
    return valid, lo, hi


def launch_kernel(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, valid, lo, hi, *,
                  max_sep: int, r_max: int, csrc=None) -> None:
    """Launch the CUDA kernel into preallocated outputs on the current
    stream — no checks and no launch count: the wrapper's inner step,
    exposed for timing the kernel alone (``csrc``: another source
    directory, as in :mod:`repro_torch.kernels.build`)."""
    from repro_torch.kernels.build import CSRC, launch

    B, Kn, L = ns_g.shape
    Ks = 0 if st_cnt is None else st_cnt.shape[1]
    stops = (st_cnt, st_ext, st_r) if Ks else (None,) * 3
    launch("nearest_r", "nearest_r_window_join",
           [a_g, ns_g, ns_r, *stops, valid, lo, hi, B, Kn, Ks, L, max_sep, r_max],
           a_g.device, CSRC if csrc is None else csrc)


def plan_k_tiles(a_g, ns_g, max_sep: int, block_l: int, block_k: int) -> int:
    """Host-side exact bound on b-tiles any (anchor-block, key) pair
    needs so every candidate within ``max_sep`` of a block's anchors is
    visited — the tiling planner of the reference package's blocked
    kernel, kept for tools that size blocked variants."""
    a = np.asarray(a_g)
    ns = np.asarray(ns_g)
    B, Kn, L = ns.shape
    n_l = cdiv(L, block_l)
    nk = cdiv(L, block_k)
    worst = 1
    for b in range(B):
        for i in range(n_l):
            blk = a[b, i * block_l:(i + 1) * block_l]
            blk = blk[blk != SENTINEL]
            if blk.size == 0:
                continue
            for key in range(Kn):
                row = ns[b, key]
                s = np.searchsorted(row, blk.min() - max_sep) // block_k
                e = np.searchsorted(row, blk.max() + max_sep, "right")
                e = min(nk - 1, e // block_k)
                worst = max(worst, int(e - s) + 1)
    return worst
