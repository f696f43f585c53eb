"""Argsort oracle for the fused ordinary-window + NSW join.

``window_join_ref`` is the pre-kernel serve path verbatim: one
argsort-based r-nearest membership pass per non-stop key (the device
twin of ``search._nearest_r``), folded with the elementwise stop-row
constraints of ``qt5_join``. It is the tie-breaking oracle the tests pin
the plain version and the kernel to: candidate columns in CPU order
[idx-1, idx, idx-2, idx+1, ...], stable sort, so ties at equal distance
resolve pred_p before succ_q iff p <= q.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import SENTINEL

BIG_DIST = 2**30


def nearest_r_ref(b_rows, centers, max_sep: int, r, r_max: int):
    """Batched r-nearest membership, argsort formulation: for each
    center, whether sorted row b holds r distinct values within
    ``max_sep``, plus the min/max of the r nearest (center included —
    the join folds via min/max against bounds that already bracket the
    center, so this equals the CPU contract wherever it is consumed).
    b_rows/centers: (N, L); r: (N,) multiplicity."""
    Lb = b_rows.shape[-1]
    idx = torch.searchsorted(b_rows.contiguous(), centers.contiguous())
    cols = []
    for j in range(1, r_max + 1):
        cols.append(idx - j)
        cols.append(idx + (j - 1))
    ci = torch.stack(cols, dim=2)  # (N, L, 2*r_max)
    ok = (ci >= 0) & (ci < Lb)
    gathered = torch.gather(b_rows[:, None, :].expand(-1, ci.shape[1], -1), 2,
                            ci.clamp(0, Lb - 1))
    cand = torch.where(ok, gathered, 0)
    ok &= cand != SENTINEL
    dist = (cand - centers[:, :, None]).abs()
    ok &= dist <= max_sep
    jcol = torch.arange(2 * r_max, device=b_rows.device) // 2
    r1 = r[:, None, None]
    ok &= jcol[None, None, :] < r1
    dist = torch.where(ok, dist, BIG_DIST)
    order = torch.argsort(dist, dim=2, stable=True)
    d_sorted = torch.gather(dist, 2, order)
    c_sorted = torch.gather(cand, 2, order)
    r_col = (r1 - 1).clamp(0, 2 * r_max - 1).expand(-1, ci.shape[1], 1)
    matched = torch.gather(d_sorted, 2, r_col)[:, :, 0] <= max_sep
    keep = (torch.arange(2 * r_max, device=b_rows.device)[None, None, :] < r1) \
        & (d_sorted <= max_sep)
    chosen = torch.where(keep, c_sorted, centers[:, :, None])
    return matched, chosen.amin(dim=2), chosen.amax(dim=2)


def window_join_ref(a_g, ns_g, ns_r, st_cnt=None, st_ext=None, st_r=None, *,
                    max_sep: int, r_max: int):
    """Fused-join oracle: per-key argsort r-nearest loop + stop fold.

    a_g: (B, L) sorted anchor rows; ns_g: (B, Kn, L) sorted non-stop
    rows; ns_r: (B, Kn) multiplicities (0 = padding key). Optional
    st_cnt/st_ext: (B, Ks, L) NSW aggregates aligned with the anchor,
    st_r: (B, Ks). Returns (valid, lo, hi) aligned with the anchor."""
    valid = a_g != SENTINEL
    lo = a_g
    hi = a_g
    for k in range(ns_g.shape[1]):
        r = ns_r[:, k]
        m, mn, mx = nearest_r_ref(ns_g[:, k], a_g, max_sep, r, r_max)
        active = (r > 0)[:, None]
        valid = valid & (m | ~active)
        upd = active & m
        lo = torch.where(upd, torch.minimum(lo, mn), lo)
        hi = torch.where(upd, torch.maximum(hi, mx), hi)
    if st_cnt is not None:
        for k in range(st_cnt.shape[1]):
            r = st_r[:, k][:, None]
            active = r > 0
            valid = valid & ((st_cnt[:, k] >= r) | ~active)
            ext = torch.where(active, st_ext[:, k], 0)
            lo = torch.minimum(lo, a_g + torch.clamp_max(ext, 0))
            hi = torch.maximum(hi, a_g + torch.clamp_min(ext, 0))
    return valid, lo, hi
