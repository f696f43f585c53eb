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
