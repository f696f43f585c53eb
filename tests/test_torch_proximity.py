"""The port's proximity window join against the reference package.

Seeded numpy inputs go through the JAX entry point on its Pallas path
(``use_pallas=True``, interpret mode on the CPU, as ``test_kernels.py``
runs it) and through the port on the CPU, where the wrapper takes its
plain version. Mask, lo and hi must be equal on every lane (the reference
sets both bounds to ``a`` where there is no match), truncated ``k_tiles``
and small blocks included. The CUDA kernel is held to the plain version
on a card (``-k cuda``; skipped without one).

The reference imports are optional so that the card test can run on a
host without JAX; here they are always present."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import SENTINEL, pad_to_multiple
from repro_torch.kernels.proximity import (
    plan_k_tiles,
    plan_starts,
    proximity_join,
    proximity_plain,
)
from repro_torch.kernels.proximity.ref import proximity_count_ref, proximity_join_ref

try:
    import jax.numpy as jnp
    from repro.kernels.common import pad_to_multiple as jax_pad
    from repro.kernels.proximity import ops as jops
    from repro.kernels.proximity import ref as jref
except ImportError:  # a card host without JAX runs only the card test
    jnp = None


@pytest.fixture
def ref():
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sorted_unique(rng, n, hi):
    return np.unique(rng.integers(0, hi, n).astype(np.int32))


def _dups_and_sentinel(seed):
    """Sorted with repeats, a SENTINEL tail in both: with block_a=8 the 20
    SENTINELs of a fill two whole A-blocks, and a value within d of
    SENTINEL must not match the b tail."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.sort(rng.integers(0, 200, 101)), [SENTINEL - 3],
                        np.full(20, SENTINEL)])
    b = np.concatenate([np.sort(rng.integers(0, 200, 70)), np.full(5, SENTINEL)])
    return a.astype(np.int32), b.astype(np.int32)


def _port(a, b, d, **kw):
    return tuple(x.numpy() for x in proximity_join(a, b, d, device="cpu", **kw))


def _jax(a, b, d, **kw):
    out = jops.proximity_join(jnp.asarray(a), jnp.asarray(b), d, use_pallas=True, **kw)
    return tuple(np.asarray(x) for x in out)


def _assert_lanes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("d", [1, 5, 7, 9])
@pytest.mark.parametrize("na,nb", [(200, 300), (1100, 600)])
def test_proximity_matches_pallas(ref, d, na, nb):
    rng = np.random.default_rng(d * 101 + na)
    a = _sorted_unique(rng, na, 8000)
    b = _sorted_unique(rng, nb, 8000)
    k = plan_k_tiles(a, b, d)
    got = _port(a, b, d, k_tiles=k)
    _assert_lanes(got, _jax(a, b, d, k_tiles=k))
    _assert_lanes(got, [x.numpy() for x in proximity_join_ref(
        torch.from_numpy(a), torch.from_numpy(b), d)])


def test_proximity_full_scan_default_k(ref):
    rng = np.random.default_rng(4)
    a = _sorted_unique(rng, 700, 6000)
    b = _sorted_unique(rng, 2100, 6000)
    _assert_lanes(_port(a, b, 5), _jax(a, b, 5))


@pytest.mark.parametrize("d", [1, 5, 9])
@pytest.mark.parametrize("k_case", ["one", "below_plan", "plan"])
def test_proximity_small_blocks_and_truncated_k(ref, d, k_case):
    rng = np.random.default_rng(d)
    a = _sorted_unique(rng, 150, 1200)
    b = _sorted_unique(rng, 300, 1200)
    plan = plan_k_tiles(a, b, d, 8, 16)
    k = {"one": 1, "below_plan": max(1, plan - 1), "plan": plan}[k_case]
    kw = dict(block_a=8, block_b=16, k_tiles=k)
    _assert_lanes(_port(a, b, d, **kw), _jax(a, b, d, **kw))


@pytest.mark.parametrize("k_tiles", [1, None])
def test_proximity_duplicates_sentinel_all_pad_blocks(ref, k_tiles):
    a, b = _dups_and_sentinel(12)
    kw = dict(block_a=8, block_b=16, k_tiles=k_tiles)
    got = _port(a, b, 5, **kw)
    _assert_lanes(got, _jax(a, b, 5, **kw))
    assert not got[0][a >= SENTINEL - 3].any()


@pytest.mark.parametrize("a,b", [([5], [5]), ([5], [6]), ([5], [7]), ([SENTINEL], [SENTINEL]),
                                 ([0], [SENTINEL - 1])])
def test_proximity_one_element(ref, a, b):
    a = np.array(a, np.int32)
    b = np.array(b, np.int32)
    _assert_lanes(_port(a, b, 1), _jax(a, b, 1))


@pytest.mark.parametrize("d", [-1, -3])
def test_proximity_negative_d_matches_pallas(ref, d):
    """A negative MaxDistance matches nothing; the kernel skips its search."""
    rng = np.random.default_rng(-d)
    a = _sorted_unique(rng, 300, 3000)
    b = _sorted_unique(rng, 500, 3000)
    got = _port(a, b, d)
    _assert_lanes(got, _jax(a, b, d))
    assert not got[0].any()


def _true_distance(a, b, d):
    """(mask, lo, hi) with distances in Python integers: the matched b
    within d of each a (both bounds a where none matches)."""
    out = [[], [], []]
    for x in a.tolist():
        near = [y for y in b.tolist() if abs(x - y) <= d]
        out[0].append(bool(near))
        out[1].append(min(near) if near else x)
        out[2].append(max(near) if near else x)
    return np.array(out[0]), np.array(out[1], np.int32), np.array(out[2], np.int32)


@pytest.mark.parametrize("case", ["opposite signs, no match", "near the bottom, a match"])
def test_proximity_takes_64_bit_distances(ref, case):
    """The port's one stated departure: it takes |a - b| in 64 bits, where
    the Pallas kernel subtracts in int32 (``proximity.py:40``). Inputs of
    opposite signs more than 2**31 - d apart wrap there: on the first case
    the Pallas path reports a match 4,294,964,000 apart. The port holds to
    the true distance on both cases; on the second it agrees with Pallas."""
    a, b, d = {"opposite signs, no match": ([-2147483000], [2147481000], 4000),
               "near the bottom, a match": ([-2147483640], [-2147483641, 7], 20)}[case]
    a, b = np.array(a, np.int32), np.array(b, np.int32)
    kw = dict(block_a=8, block_b=8)
    got = _port(a, b, d, **kw)
    want = _true_distance(a, b, d)
    _assert_lanes(got, want)
    pallas = _jax(a, b, d, **kw)
    if case == "opposite signs, no match":
        assert not want[0][0] and pallas[0][0] and pallas[1][0] == pallas[2][0] == b[0]
    else:
        assert want[0][0]
        _assert_lanes(got, pallas)


@pytest.mark.parametrize("a,b", [([], []), ([], [5]), ([5], [])])
def test_proximity_empty_raises_as_reference(ref, a, b):
    a = np.array(a, np.int32)
    b = np.array(b, np.int32)
    with pytest.raises(TypeError):
        _jax(a, b, 1)
    with pytest.raises(ValueError):
        _port(a, b, 1)


@pytest.mark.parametrize("d", [1, 5, 9])
def test_plan_starts_and_k_tiles_equal_reference(ref, d):
    for block_a, block_b in ((8, 16), (512, 1024), (64, 64)):
        rng = np.random.default_rng(d + block_a)
        a = _sorted_unique(rng, 700, 5000)
        b = _sorted_unique(rng, 1300, 5000)
        a_p = pad_to_multiple(torch.from_numpy(a), block_a, SENTINEL)
        b_p = pad_to_multiple(torch.from_numpy(b), block_b, SENTINEL)
        want = np.asarray(jops.plan_starts(jax_pad(jnp.asarray(a), block_a, SENTINEL),
                                           jax_pad(jnp.asarray(b), block_b, SENTINEL),
                                           d, block_a, block_b))
        np.testing.assert_array_equal(plan_starts(a_p, b_p, d, block_a, block_b).numpy(), want)
        assert plan_k_tiles(a, b, d, block_a, block_b) == jops.plan_k_tiles(
            a, b, d, block_a, block_b)


def test_oracles_equal_reference(ref):
    rng = np.random.default_rng(1)
    a = np.concatenate([_sorted_unique(rng, 80, 400), [SENTINEL]]).astype(np.int32)
    b = _sorted_unique(rng, 60, 400)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    _assert_lanes([x.numpy() for x in proximity_join_ref(ta, tb, 5)],
                  [np.asarray(x) for x in jref.proximity_join_ref(ja, jb, 5)])
    np.testing.assert_array_equal(proximity_count_ref(ta, tb, 5).numpy(),
                                  np.asarray(jref.proximity_count_ref(ja, jb, 5)))


def _block_layouts(case):
    """As in test_torch_intersect.py: ``a`` shuffled inside each A-block,
    an A-block of SENTINEL alone in the middle of ``a``, and a sparse ``a``
    over a dense ``b`` at full scan (a needed b-range longer than the
    kernel's 4,096-value buffer). Default blocks. Returns ``(a, b, kwargs)``."""
    rng = np.random.default_rng({"shuffled": 71, "sentinel_block": 72, "sparse_full_scan": 73}[case])
    if case == "sparse_full_scan":
        return _sorted_unique(rng, 600, 250_000), _sorted_unique(rng, 50_000, 250_000), {}
    a = _sorted_unique(rng, 1800, 12_000)
    b = _sorted_unique(rng, 4000, 12_000)
    k = plan_k_tiles(a, b, 5)  # planned on the sorted a, as a caller would
    if case == "shuffled":
        for s in range(0, a.size, 512):
            rng.shuffle(a[s:s + 512])
    else:
        a[512:1024] = SENTINEL
    return a, b, dict(k_tiles=k)


@pytest.mark.parametrize("case", ["shuffled", "sentinel_block", "sparse_full_scan"])
def test_proximity_block_layouts_match_pallas(ref, case):
    a, b, kw = _block_layouts(case)
    got = _port(a, b, 5, **kw)
    _assert_lanes(got, _jax(a, b, 5, **kw))
    if case == "sparse_full_scan":
        _assert_lanes(got, [x.numpy() for x in proximity_join_ref(
            torch.from_numpy(a), torch.from_numpy(b), 5)])


@pytest.mark.cuda
def test_kernel_matches_plain_cuda(cuda):
    rng = np.random.default_rng(31)
    cases = [(_sorted_unique(rng, 5000, 30000), _sorted_unique(rng, 3000, 30000), 5, {}),
             (*_dups_and_sentinel(2), 5, dict(block_a=8, block_b=16, k_tiles=1)),
             (_sorted_unique(rng, 700, 4000), _sorted_unique(rng, 1100, 4000), 9,
              dict(block_a=8, block_b=16, k_tiles=2))]
    for case in ("shuffled", "sentinel_block", "sparse_full_scan"):
        a, b, kw = _block_layouts(case)
        cases += [(a, b, d, kw) for d in (1, 5, -2)]
    cases.append((_sorted_unique(rng, 600, 10**6), _sorted_unique(rng, 200_000, 10**6), 5, {}))
    for a, b, d, kw in cases:
        want = proximity_plain(torch.from_numpy(a), torch.from_numpy(b), d, **kw)
        before = proximity_join.launches
        got = proximity_join(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda), d, **kw)
        torch.cuda.synchronize()
        assert proximity_join.launches == before + 1
        _assert_lanes([g.cpu().numpy() for g in got], [w.numpy() for w in want])
