"""The port's nearest-r window join against the reference package.

The plain PyTorch version (what ``window_join`` runs on CPU tensors)
and the port's argsort oracle replay the case families of
``test_nearest_r_kernel.py`` — equal-distance ties, r = 0..r_max, empty
rows, SENTINEL anchors, the QT5 stop fold, block-boundary straddles —
against the JAX lax counting join, a subset also against the Pallas
kernel in interpret mode. The contract every consumer reads is
``(valid, lo[valid], hi[valid])``; the plain version is also held to the
lax join on every lane, since the serve step's top-k can surface an
invalid lane's bounds. The CUDA kernel is held to the plain version on
a card (``-k cuda``; skipped without one).

The reference imports are optional so that the card test can run on a
host without JAX; here they are always present."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import SENTINEL
from repro_torch.kernels.nearest_r import window_join, window_join_plain
from repro_torch.kernels.nearest_r.ref import window_join_ref

try:
    import jax.numpy as jnp
    from repro.kernels.nearest_r import window_join as jax_window_join
    from repro.kernels.nearest_r.nearest_r import window_join_pallas
except ImportError:  # a card host without JAX runs only the card test
    jnp = None

R_MAX = 4
SEEDS = [11, 2024, 77, 31337, 5, 900, 4242, 123456]


@pytest.fixture
def ref():
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(rng, b, kn, l, stride, p_empty=0.15):
    """Strictly increasing SENTINEL-padded rows. Small ``stride`` makes
    equal pred/succ distances common — the tie-breaking cases."""
    out = np.full((b, kn, l), SENTINEL, np.int32)
    for i in range(b):
        for k in range(kn):
            if rng.random() < p_empty:
                continue
            n = int(rng.integers(1, l + 1))
            out[i, k, :n] = np.cumsum(rng.integers(1, stride + 1, n))
    return out


def _stops(rng, b, ks, l, max_sep):
    st_cnt = rng.integers(0, 4, (b, ks, l)).astype(np.int32)
    st_ext = rng.integers(-max_sep, max_sep + 1, (b, ks, l)).astype(np.int32)
    st_r = rng.integers(0, 3, (b, ks)).astype(np.int32)
    return st_cnt, st_ext, st_r


def _case(seed, b=3, kn=3, l=48, stride=3, stops=False, max_sep=5,
          r=None, p_empty=0.15):
    rng = np.random.default_rng(seed)
    a = _rows(rng, b, 1, l, stride, p_empty)[:, 0]
    ns = _rows(rng, b, kn, l, stride, p_empty)
    ns_r = (rng.integers(0, R_MAX + 1, (b, kn)) if r is None
            else np.full((b, kn), r)).astype(np.int32)
    arrays = [a, ns, ns_r]
    if stops:
        arrays += list(_stops(rng, b, 2, l, max_sep))
    return arrays, max_sep


def _np3(out):
    return tuple(np.asarray(x) for x in out)


def _port(fn, arrays, max_sep, device="cpu"):
    ts = [torch.from_numpy(x).to(device) for x in arrays]
    return tuple(x.cpu().numpy() for x in fn(*ts, max_sep=max_sep, r_max=R_MAX))


def _jax(fn, arrays, max_sep, **kw):
    return _np3(fn(*[jnp.asarray(x) for x in arrays], max_sep=max_sep,
                   r_max=R_MAX, **kw))


def _assert_same(got, want):
    gv, gl, gh = got
    wv, wl, wh = want
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl[wv], wl[wv])
    np.testing.assert_array_equal(gh[wv], wh[wv])


def _assert_all_lanes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------- plain version and oracle vs the lax join ------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stride", [1, 3, 6])
def test_plain_matches_lax_join(ref, seed, stride):
    arrays, max_sep = _case(seed, stride=stride, max_sep=1 + seed % 7)
    want = _jax(jax_window_join, arrays, max_sep)
    got = _port(window_join, arrays, max_sep)
    _assert_all_lanes(got, want)
    _assert_same(_port(window_join_ref, arrays, max_sep), want)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_plain_stop_fold_matches_lax_join(ref, seed):
    arrays, max_sep = _case(seed, b=2, kn=2, l=32, stops=True)
    want = _jax(jax_window_join, arrays, max_sep)
    _assert_all_lanes(_port(window_join, arrays, max_sep), want)
    _assert_same(_port(window_join_ref, arrays, max_sep), want)


@pytest.mark.parametrize("r", range(R_MAX + 1))
def test_every_multiplicity(ref, r):
    arrays, max_sep = _case(100 + r, b=2, kn=3, l=40, stride=2, r=r)
    want = _jax(jax_window_join, arrays, max_sep)
    _assert_all_lanes(_port(window_join, arrays, max_sep), want)


def test_empty_rows_and_sentinel_anchors(ref):
    a = np.full((2, 8), SENTINEL, np.int32)
    a[0, :3] = [10, 20, 30]  # row 1 is all-SENTINEL anchors
    ns = np.full((2, 2, 8), SENTINEL, np.int32)
    ns[0, 1, :4] = [8, 12, 19, 33]  # key 0 stays empty
    for r0 in (0, 1):
        ns_r = np.array([[r0, 1], [1, 1]], np.int32)
        arrays = [a, ns, ns_r]
        want = _jax(jax_window_join, arrays, 3)
        got = _port(window_join, arrays, 3)
        _assert_all_lanes(got, want)
        assert not got[0][1].any()
        assert got[0][0, :3].tolist() == ([True] * 3 if r0 == 0
                                          else [False] * 3)


def test_tie_pred_before_succ(ref):
    a = np.array([[100, SENTINEL]], np.int32)
    ns = np.array([[[98, 102]]], np.int32)  # pred and succ both at dist 2
    for r, want_lo, want_hi in ((1, 98, 100), (2, 98, 102)):
        arrays = [a, ns, np.array([[r]], np.int32)]
        for fn in (window_join, window_join_ref):
            valid, lo, hi = _port(fn, arrays, 5)
            assert valid[0, 0] and not valid[0, 1]
            assert lo[0, 0] == want_lo and hi[0, 0] == want_hi
        _assert_same(_port(window_join, arrays, 5),
                     _jax(jax_window_join, arrays, 5))


# ---------------- against the Pallas kernel in interpret mode --------------
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_plain_matches_pallas_interpret(ref, seed):
    arrays, max_sep = _case(seed, b=2, kn=2, l=48, stride=1 + seed % 4,
                            max_sep=4, p_empty=0.0)
    want = _jax(window_join_pallas, arrays, max_sep, interpret=True,
                block_l=16, block_k=16)
    _assert_same(_port(window_join, arrays, max_sep), want)


def test_stop_fold_matches_pallas_interpret(ref):
    arrays, max_sep = _case(7, b=2, kn=2, l=32, stops=True, max_sep=4, p_empty=0.0)
    want = _jax(window_join_pallas, arrays, max_sep, interpret=True,
                block_l=16, block_k=16)
    _assert_same(_port(window_join, arrays, max_sep), want)


def test_block_boundary_straddle_matches_pallas_interpret(ref):
    """Anchors right at the Pallas kernel's b-tile edges of a dense key
    row: its r nearest predecessors and successors sit in two tiles."""
    l, block, max_sep = 32, 8, 6
    ns = np.arange(2, 2 + 2 * l, 2, dtype=np.int32)[None, None, :]
    a = np.full((1, l), SENTINEL, np.int32)
    a[0, :6] = [15, 17, 31, 33, 47, 49]
    arrays = [a, ns, np.full((1, 1), 3, np.int32)]
    want = _jax(window_join_pallas, arrays, max_sep, interpret=True,
                block_l=block, block_k=block)
    got = _port(window_join, arrays, max_sep)
    _assert_same(got, want)
    assert got[0][0, :6].all() and not got[0][0, 6:].any()


# ---------------- the CUDA kernel vs the plain version, on a card ----------
@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_kernel_matches_plain_cuda(cuda, seed):
    for stops in (False, True):
        arrays, max_sep = _case(seed, b=4, kn=3, l=300, stride=2, stops=stops)
        want = _port(window_join_plain, arrays, max_sep)
        before = window_join.launches
        got = _port(window_join, arrays, max_sep, device=cuda)
        torch.cuda.synchronize()
        assert window_join.launches == before + 1
        _assert_same(got, want)


# ---------------- unsorted anchors, multiplicities above r_max -------------
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_plain_matches_lax_join_shuffled_anchors(ref, seed):
    """Anchors need not be sorted: each lane is its own query, so a row
    of anchors shuffled among its SENTINEL lanes gives the same lanes,
    permuted alike."""
    arrays, max_sep = _case(seed, b=3, kn=3, l=64, stride=2, stops=seed % 2 == 1)
    rng = np.random.default_rng(seed)
    perm = np.stack([rng.permutation(arrays[0].shape[1]) for _ in range(arrays[0].shape[0])])
    shuffled = [np.take_along_axis(arrays[0], perm, 1), *arrays[1:3]]
    if len(arrays) > 3:
        shuffled += [np.take_along_axis(x, perm[:, None, :], 2) for x in arrays[3:5]]
        shuffled.append(arrays[5])
    got = _port(window_join, shuffled, max_sep)
    _assert_all_lanes(got, _jax(jax_window_join, shuffled, max_sep))
    want = _port(window_join, arrays, max_sep)
    _assert_all_lanes(got, tuple(np.take_along_axis(x, perm, 1) for x in want))


def test_host_multiplicity_above_r_max_raises():
    arrays, max_sep = _case(3)
    arrays[2][0, 0] = R_MAX + 1
    with pytest.raises(ValueError, match="r_max"):
        _port(window_join, arrays, max_sep)


# ---------------- the redesigned kernel's cases, on a card -----------------
def _gap_rows(rng, n, l, gaps, fill):
    vals = np.cumsum(rng.integers(gaps[0], gaps[1] + 1, (n, l)), axis=1) + 1000
    vals[np.arange(l)[None, :] >= rng.integers(fill[0], fill[1] + 1, n)[:, None]] = SENTINEL
    return vals.astype(np.int32)


def _kernel_cases():
    """Shapes the block-window kernel treats apart: L off its 256-thread
    and 1024-lane multiples, shuffled anchors, windows wider than its
    4096-value shared-memory buffer (sparse anchors over dense keys,
    searched in global memory), a few anchors over a wide dense window,
    and tiles whose lanes all fail the first key."""
    cases = []
    for l in (1, 255, 1025, 3071):
        rng = np.random.default_rng(l)
        cases.append(("L", [_gap_rows(rng, 2, l, (1, 6), (max(1, l // 2), l)),
                            _gap_rows(rng, 6, l, (1, 6), (max(1, l // 2), l)).reshape(2, 3, l),
                            rng.integers(0, R_MAX + 1, (2, 3)).astype(np.int32)]))
    rng = np.random.default_rng(1)
    a = _gap_rows(rng, 2, 6000, (1, 6), (5980, 5980))
    for row in a:
        rng.shuffle(row)
    cases.append(("shuffled", [a, _gap_rows(rng, 6, 6000, (1, 6), (3000, 6000)).reshape(2, 3, 6000),
                               rng.integers(0, R_MAX + 1, (2, 3)).astype(np.int32)]))
    dense = _gap_rows(rng, 6, 6000, (1, 2), (3000, 6000)).reshape(2, 3, 6000)
    cases.append(("wide windows", [_gap_rows(rng, 2, 6000, (4, 12), (1100, 3000)), dense,
                                   rng.integers(0, R_MAX + 1, (2, 3)).astype(np.int32),
                                   *_stops(rng, 2, 2, 6000, 5)]))
    a = np.full((2, 30000), SENTINEL, np.int32)
    a[:, :12] = np.sort(rng.choice(np.arange(2000, 100_000), (2, 12), replace=False), axis=1)
    dense = _gap_rows(rng, 6, 30000, (1, 6), (29900, 30000)).reshape(2, 3, 30000)
    cases.append(("few anchors", [a, dense, rng.integers(0, R_MAX + 1, (2, 3)).astype(np.int32)]))
    a = _gap_rows(rng, 2, 3000, (20, 30), (3000, 3000))
    ns = np.stack([a + 10, _gap_rows(rng, 2, 3000, (1, 6), (3000, 3000)),
                   _gap_rows(rng, 2, 3000, (1, 6), (3000, 3000))], axis=1)
    cases.append(("all fail key 0", [a, ns, np.ones((2, 3), np.int32)]))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(8))
def test_kernel_block_windows_match_plain_cuda(cuda, case):
    name, arrays = _kernel_cases()[case]
    want = _port(window_join_plain, arrays, 5)
    got = _port(window_join, arrays, 5, device=cuda)
    _assert_same(got, want)
    if name == "all fail key 0":
        assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("r_max", range(1, 9))
def test_kernel_every_multiplicity_cuda(cuda, r_max):
    for r in range(r_max + 1):
        arrays, max_sep = _case(200 + r, b=2, kn=3, l=200, stride=2, r=r)
        ts = [torch.from_numpy(x) for x in arrays]
        want = window_join_plain(*ts, max_sep=max_sep, r_max=r_max)
        got = window_join(*[t.to(cuda) for t in ts], max_sep=max_sep, r_max=r_max)
        _assert_same(tuple(x.cpu().numpy() for x in got), tuple(x.numpy() for x in want))


@pytest.mark.cuda
def test_kernel_call_makes_no_host_sync_cuda(cuda):
    """The card path reads nothing back: no check of ns_r against r_max,
    no sizes from the device. Sync debug mode raises on any host sync."""
    arrays, max_sep = _case(5, b=4, kn=3, l=300, stride=2, stops=True)
    ts = [torch.from_numpy(x).to(cuda) for x in arrays]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = window_join(*ts, max_sep=max_sep, r_max=R_MAX)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_same(tuple(x.cpu().numpy() for x in got),
                 _port(window_join_plain, arrays, max_sep))
