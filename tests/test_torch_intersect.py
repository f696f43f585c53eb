"""The port's intersect kernels against the reference package.

Seeded numpy inputs go through the JAX entry points on their Pallas path
(``use_pallas=True``, interpret mode on the CPU, as ``test_kernels.py``
runs them) and through the port on the CPU, where the wrappers take their
plain versions. Every lane must be equal: mask and idx, truncated
``k_tiles`` and small blocks included. The CUDA kernels are held to the
plain versions on a card (``-k cuda``; skipped without one).

The reference imports are optional so that the card tests can run on a
host without JAX; here they are always present."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import SENTINEL, pad_to_multiple
from repro_torch.kernels.intersect import (
    intersect_compressed_plain,
    intersect_plain,
    intersect_sorted,
    intersect_sorted_compressed,
    pack_delta_stream,
    plan_k_tiles,
    plan_starts,
)
from repro_torch.kernels.intersect.ops import pack_compressed
from repro_torch.kernels.intersect.ref import intersect_idx_ref, intersect_mask_ref

try:
    import jax.numpy as jnp
    from repro.kernels.common import pad_to_multiple as jax_pad
    from repro.kernels.intersect import ops as jops
    from repro.kernels.intersect import ref as jref
except ImportError:  # a card host without JAX runs only the card tests
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
    SENTINELs of a fill two whole A-blocks."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.sort(rng.integers(0, 60, 101)), np.full(20, SENTINEL)])
    b = np.concatenate([np.sort(rng.integers(0, 60, 70)), np.full(5, SENTINEL)])
    return a.astype(np.int32), b.astype(np.int32)


def _port(a, b, **kw):
    mask, idx = intersect_sorted(a, b, device="cpu", **kw)
    return mask.numpy(), idx.numpy()


def _jax(a, b, **kw):
    mask, idx = jops.intersect_sorted(jnp.asarray(a), jnp.asarray(b), use_pallas=True, **kw)
    return np.asarray(mask), np.asarray(idx)


def _assert_lanes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------- raw streams vs the Pallas kernel ---------------------------
@pytest.mark.parametrize("na,nb,hi", [
    (100, 100, 500),       # dense overlap
    (1000, 5000, 20000),   # skewed sizes
    (5000, 700, 100000),   # sparse overlap
    (513, 1025, 4000),     # non-multiple-of-block sizes
    (3, 2, 10),            # tiny
])
def test_intersect_matches_pallas_shapes(ref, na, nb, hi):
    rng = np.random.default_rng(na * 7 + nb)
    a = _sorted_unique(rng, na, hi)
    b = _sorted_unique(rng, nb, hi)
    k = plan_k_tiles(a, b)
    got = _port(a, b, k_tiles=k)
    _assert_lanes(got, _jax(a, b, k_tiles=k))
    np.testing.assert_array_equal(got[0], np.isin(a, b))


def test_intersect_full_scan_default_k(ref):
    rng = np.random.default_rng(3)
    a = _sorted_unique(rng, 600, 3000)
    b = _sorted_unique(rng, 2100, 3000)
    _assert_lanes(_port(a, b), _jax(a, b))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k_case", ["one", "below_plan", "plan", "full"])
def test_intersect_small_blocks_and_truncated_k(ref, seed, k_case):
    """Blocks 8/16 as ``test_kernels.py`` uses them: a k_tiles below the
    plan truncates the answer, the same way in both."""
    rng = np.random.default_rng(seed)
    a = _sorted_unique(rng, 150, 900)
    b = _sorted_unique(rng, 300, 900)
    plan = plan_k_tiles(a, b, 8, 16)
    k = {"one": 1, "below_plan": max(1, plan - 1), "plan": plan, "full": None}[k_case]
    kw = dict(block_a=8, block_b=16, k_tiles=k)
    got = _port(a, b, **kw)
    _assert_lanes(got, _jax(a, b, **kw))
    if k_case in ("plan", "full"):
        np.testing.assert_array_equal(got[0], np.isin(a, b))


@pytest.mark.parametrize("k_tiles", [1, 2, None])
def test_intersect_duplicates_sentinel_all_pad_blocks(ref, k_tiles):
    a, b = _dups_and_sentinel(11)
    kw = dict(block_a=8, block_b=16, k_tiles=k_tiles)
    got = _port(a, b, **kw)
    _assert_lanes(got, _jax(a, b, **kw))
    assert not got[0][a == SENTINEL].any()
    assert (got[1][a == SENTINEL] == -1).all()


@pytest.mark.parametrize("a,b", [([5], [5]), ([5], [6]), ([SENTINEL], [SENTINEL]),
                                 ([1, 2], [2]), ([7], [1, 7, 7])])
def test_intersect_one_element(ref, a, b):
    a = np.array(a, np.int32)
    b = np.array(b, np.int32)
    _assert_lanes(_port(a, b), _jax(a, b))


@pytest.mark.parametrize("a,b", [([], []), ([], [5]), ([5], [])])
def test_intersect_empty_raises_as_reference(ref, a, b):
    a = np.array(a, np.int32)
    b = np.array(b, np.int32)
    with pytest.raises(TypeError):
        _jax(a, b)
    with pytest.raises(ValueError):
        _port(a, b)


@pytest.mark.parametrize("blocks", [(8, 16), (512, 1024), (64, 64)])
def test_plan_starts_and_k_tiles_equal_reference(ref, blocks):
    block_a, block_b = blocks
    for seed in range(3):
        rng = np.random.default_rng(seed + 40)
        a = _sorted_unique(rng, 700, 5000)
        b = _sorted_unique(rng, 1300, 5000)
        a_p = pad_to_multiple(torch.from_numpy(a), block_a, SENTINEL)
        b_p = pad_to_multiple(torch.from_numpy(b), block_b, SENTINEL)
        want = np.asarray(jops.plan_starts(jax_pad(jnp.asarray(a), block_a, SENTINEL),
                                           jax_pad(jnp.asarray(b), block_b, SENTINEL),
                                           block_a, block_b))
        np.testing.assert_array_equal(plan_starts(a_p, b_p, block_a, block_b).numpy(), want)
        np.testing.assert_array_equal(
            plan_starts(torch.from_numpy(a), torch.from_numpy(b), block_a, block_b).numpy(), want)
        assert plan_k_tiles(a, b, block_a, block_b) == jops.plan_k_tiles(a, b, block_a, block_b)
    assert plan_k_tiles(np.zeros(0, np.int32), b) == jops.plan_k_tiles(np.zeros(0, np.int32), b)


def test_oracles_equal_reference(ref):
    rng = np.random.default_rng(0)
    a = np.concatenate([_sorted_unique(rng, 400, 2000), [SENTINEL]]).astype(np.int32)
    b = _sorted_unique(rng, 300, 2000)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(intersect_mask_ref(ta, tb).numpy(),
                                  np.asarray(jref.intersect_mask_ref(jnp.asarray(a), jnp.asarray(b))))
    for g, w in zip(intersect_idx_ref(ta, tb), jref.intersect_idx_ref(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask, idx = _port(a, b)  # the full scan finds the oracle's first match
    np.testing.assert_array_equal(mask, intersect_mask_ref(ta, tb).numpy())
    np.testing.assert_array_equal(idx, intersect_idx_ref(ta, tb)[1].numpy())


def _block_layouts(case):
    """Inputs that the block-per-A-block kernel must answer as the
    reference does: ``a`` shuffled inside each A-block (the window still
    comes from the block's first element), an A-block of SENTINEL alone in
    the middle of ``a``, and a sparse ``a`` over a dense ``b`` at full scan,
    whose needed b-range is longer than the kernel's shared-memory buffer
    (4,096 values). Default blocks. Returns ``(a, b, kwargs)``."""
    rng = np.random.default_rng({"shuffled": 61, "sentinel_block": 62, "sparse_full_scan": 63}[case])
    if case == "sparse_full_scan":
        return _sorted_unique(rng, 600, 250_000), _sorted_unique(rng, 50_000, 250_000), {}
    a = _sorted_unique(rng, 1800, 12_000)
    b = _sorted_unique(rng, 4000, 12_000)
    k = plan_k_tiles(a, b)  # planned on the sorted a, as a caller would
    if case == "shuffled":
        for s in range(0, a.size, 512):
            rng.shuffle(a[s:s + 512])
    else:
        a[512:1024] = SENTINEL
    return a, b, dict(k_tiles=k)


@pytest.mark.parametrize("case", ["shuffled", "sentinel_block", "sparse_full_scan"])
def test_intersect_block_layouts_match_pallas(ref, case):
    a, b, kw = _block_layouts(case)
    got = _port(a, b, **kw)
    _assert_lanes(got, _jax(a, b, **kw))
    if case == "sparse_full_scan":
        np.testing.assert_array_equal(got[0], np.isin(a, b))


def test_library_path_follows_the_headers(tmp_path):
    """A build is keyed by the headers beside a source, not only by the
    source: editing csrc/sorted_window.cuh must rebuild intersect.cu."""
    from repro_torch.kernels.build import CSRC, library_path

    for src in CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    before = library_path("intersect", tmp_path)
    assert before == library_path("intersect", CSRC)
    header = tmp_path / "sorted_window.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert library_path("intersect", tmp_path) != before


# ---------------- delta16 streams vs the Pallas kernel ----------------------
def _port_c(a, b, **kw):
    return intersect_sorted_compressed(a, b, device="cpu", **kw).numpy()


def _jax_c(a, b, **kw):
    return np.asarray(jops.intersect_sorted_compressed(a, b, **kw))


@pytest.mark.parametrize("na,nb,hi", [
    (300, 500, 4000),
    (1000, 2000, 30000),
    (70, 1500, 9000),
])
def test_compressed_matches_pallas_shapes(ref, na, nb, hi):
    rng = np.random.default_rng(na + nb)
    a = _sorted_unique(rng, na, hi)
    b = _sorted_unique(rng, nb, hi)
    got = _port_c(a, b, block_a=128, block_b=256)
    np.testing.assert_array_equal(got, _jax_c(a, b, block_a=128, block_b=256))
    np.testing.assert_array_equal(got, np.isin(a, b))


@pytest.mark.parametrize("k_tiles", [1, 2, None])
def test_compressed_truncated_k(ref, k_tiles):
    rng = np.random.default_rng(5)
    a = _sorted_unique(rng, 400, 3000)
    b = _sorted_unique(rng, 900, 3000)
    kw = dict(block_a=64, block_b=64, k_tiles=k_tiles)
    np.testing.assert_array_equal(_port_c(a, b, **kw), _jax_c(a, b, **kw))


def test_compressed_all_pad_blocks_and_duplicates(ref):
    """70 postings in a 512-block: seven of its eight 64-blocks are all
    padding (base 0, pads decode to 65535, below the real values)."""
    rng = np.random.default_rng(8)
    a = np.sort(rng.integers(60_000, 70_000, 70)).astype(np.int32)
    b = np.sort(rng.integers(60_000, 70_000, 1500)).astype(np.int32)
    got = _port_c(a, b)
    np.testing.assert_array_equal(got, _jax_c(a, b))
    np.testing.assert_array_equal(got, np.isin(a, b))


@pytest.mark.parametrize("a,b", [([], []), ([], [5]), ([5], []), ([5], [5]), ([5], [6]),
                                 ([65535], [65535])])
def test_compressed_empty_and_one_element(ref, a, b):
    a = np.array(a, np.int32)
    b = np.array(b, np.int32)
    got = _port_c(a, b)
    np.testing.assert_array_equal(got, _jax_c(a, b))
    assert got.shape == a.shape and got.dtype == np.bool_


def test_compressed_rejects_what_the_reference_rejects(ref):
    x = np.arange(10, dtype=np.int32)
    with pytest.raises(AssertionError):
        _jax_c(x, x, block_a=32)
    with pytest.raises(ValueError):
        _port_c(x, x, block_a=32)
    wide = np.array([0, 70_000], np.int32)
    for fn in (_jax_c, _port_c):
        with pytest.raises(ValueError, match="uint16"):
            fn(wide, x)


@pytest.mark.parametrize("n,total", [(0, 64), (1, 64), (64, 64), (500, 1024), (130, 256)])
def test_pack_delta_stream_byte_identical(ref, n, total):
    rng = np.random.default_rng(n)
    x = np.sort(rng.integers(0, 20 * max(n, 1), n)).astype(np.int32)  # repeats allowed
    for g, w in zip(pack_delta_stream(x, total), jops.pack_delta_stream(x, total)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_compressed_plain_decodes_raw_uint16_bits(ref):
    """The deltas reach the plain version as raw bits, int16 or uint16."""
    rng = np.random.default_rng(9)
    b = _sorted_unique(rng, 900, 540_000)  # 64-block spans above 32767
    a = np.unique(np.concatenate([b[::2], b[1::2] + 1]))
    a_base, a_delta, b_base, b_delta, starts = pack_compressed(a, b, block_a=128, block_b=256)
    assert a_delta.max() == 65535 and (b_delta > 32767).any()
    want = np.isin(a, b)
    for view in (np.int16, np.uint16):
        got = intersect_compressed_plain(
            torch.from_numpy(a_base), torch.from_numpy(a_delta.view(view)),
            torch.from_numpy(b_base), torch.from_numpy(b_delta.view(view)),
            torch.from_numpy(starts), a.size, block_a=128, block_b=256,
            k_tiles=b_delta.size // 256)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------- the CUDA kernels vs the plain versions, on a card ---------
def _card_cases():
    rng = np.random.default_rng(21)
    yield _sorted_unique(rng, 5000, 20000), _sorted_unique(rng, 3000, 20000), {}
    a, b = _dups_and_sentinel(3)
    yield a, b, dict(block_a=8, block_b=16, k_tiles=1)
    yield _sorted_unique(rng, 700, 4000), _sorted_unique(rng, 1100, 4000), dict(
        block_a=8, block_b=16, k_tiles=2)
    for case in ("shuffled", "sentinel_block", "sparse_full_scan"):
        yield _block_layouts(case)
    yield _sorted_unique(rng, 600, 10**6), _sorted_unique(rng, 200_000, 10**6), {}


@pytest.mark.cuda
def test_kernel_matches_plain_cuda(cuda):
    for a, b, kw in _card_cases():
        want = intersect_plain(torch.from_numpy(a), torch.from_numpy(b), **kw)
        before = intersect_sorted.launches
        got = intersect_sorted(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda), **kw)
        torch.cuda.synchronize()
        assert intersect_sorted.launches == before + 1
        _assert_lanes([g.cpu().numpy() for g in got], [w.numpy() for w in want])


@pytest.mark.cuda
def test_compressed_kernel_matches_plain_cuda(cuda):
    rng = np.random.default_rng(22)
    for a, b, kw in [(_sorted_unique(rng, 5000, 20000), _sorted_unique(rng, 3000, 20000), {}),
                     (_sorted_unique(rng, 70, 9000), _sorted_unique(rng, 1500, 9000),
                      dict(block_a=64, block_b=64, k_tiles=1))]:
        want = intersect_sorted_compressed(a, b, device="cpu", **kw)
        before = intersect_sorted_compressed.launches
        got = intersect_sorted_compressed(a, b, device=cuda, **kw)
        torch.cuda.synchronize()
        assert intersect_sorted_compressed.launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_wrappers_make_no_host_sync_cuda(cuda):
    """Neither the intersect nor the proximity wrapper waits for the card:
    both calls run under ``set_sync_debug_mode("error")``."""
    from repro_torch.kernels.proximity import proximity_join, proximity_plain

    rng = np.random.default_rng(23)
    a, b = _sorted_unique(rng, 5000, 20000), _sorted_unique(rng, 3000, 20000)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_i = intersect_sorted(ta, tb, k_tiles=2)
        got_p = proximity_join(ta, tb, 5, k_tiles=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ca, cb = torch.from_numpy(a), torch.from_numpy(b)
    _assert_lanes([g.cpu().numpy() for g in got_i],
                  [w.numpy() for w in intersect_plain(ca, cb, k_tiles=2)])
    _assert_lanes([g.cpu().numpy() for g in got_p],
                  [w.numpy() for w in proximity_plain(ca, cb, 5, k_tiles=2)])
