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
    intersect_compressed_streams,
    intersect_plain,
    intersect_sorted,
    intersect_sorted_compressed,
    pack_compressed,
    pack_compressed_torch,
    pack_delta_stream,
    plan_k_tiles,
    plan_starts,
)
from repro_torch.kernels.intersect.ops import device_streams
from repro_torch.kernels.intersect.ref import intersect_idx_ref, intersect_mask_ref

try:
    import jax.numpy as jnp
    from repro.kernels.common import pad_to_multiple as jax_pad
    from repro.kernels.intersect import ops as jops
    from repro.kernels.intersect import ref as jref
    from repro.kernels.intersect.intersect import intersect_pallas_compressed
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


# ---------------- packed delta16 streams vs the Pallas kernel ---------------
def _ref_streams(a, b, block_a, block_b):
    """The reference's packing, as its ``intersect_sorted_compressed``
    does it: its own ``pack_delta_stream`` and starts planned by
    ``np.searchsorted`` on the unpadded b."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    la = -(-max(a.size, 1) // block_a) * block_a
    lb = -(-max(b.size, 1) // block_b) * block_b
    a_base, a_delta = jops.pack_delta_stream(a, la)
    b_base, b_delta = jops.pack_delta_stream(b, lb)
    starts = (np.searchsorted(b, a_base[::block_a // 64]) // block_b).astype(np.int32)
    return a_base, a_delta, b_base, b_delta, starts


def _stream_case(case):
    """(a, b, block_a, block_b, k_tiles) of the packed-stream parity cases:
    blocks 64/64 at truncated and full k_tiles, 128/256 and the defaults
    (short inputs leave 64-blocks all padding, base 0), repeats whose
    all-pad blocks decode below the real values, and one-element inputs."""
    rng = np.random.default_rng(70)
    a, b = _sorted_unique(rng, 400, 3000), _sorted_unique(rng, 900, 3000)
    if case.startswith("64/64"):
        return a, b, 64, 64, {"k1": 1, "k2": 2, "full": None}[case.split()[1]]
    if case == "128/256":
        return _sorted_unique(rng, 1000, 30000), _sorted_unique(rng, 2000, 30000), 128, 256, None
    if case == "defaults":
        return _sorted_unique(rng, 300, 4000), _sorted_unique(rng, 500, 4000), 512, 1024, 1
    if case == "all-pad blocks, duplicates":
        a = np.sort(rng.integers(60_000, 70_000, 70)).astype(np.int32)
        b = np.sort(rng.integers(60_000, 70_000, 1500)).astype(np.int32)
        return a, b, 512, 1024, None
    x, y = {"one element, a hit": ([5], [5]), "one element, a miss": ([5], [6])}[case]
    return np.array(x, np.int32), np.array(y, np.int32), 512, 1024, None


@pytest.mark.parametrize("view", [np.int16, np.uint16])
@pytest.mark.parametrize("case", ["64/64 k1", "64/64 k2", "64/64 full", "128/256", "defaults",
                                  "all-pad blocks, duplicates", "one element, a hit",
                                  "one element, a miss"])
def test_compressed_streams_match_pallas(ref, case, view):
    """The packed-stream entry point against ``intersect_pallas_compressed``
    in interpret mode, on the reference's own streams: equal masks of the
    padded length, from int16 and uint16 deltas."""
    a, b, block_a, block_b, k = _stream_case(case)
    streams = _ref_streams(a, b, block_a, block_b)
    k_ref = streams[3].size // block_b if k is None else k
    want = np.asarray(intersect_pallas_compressed(
        *map(jnp.asarray, streams), block_a=block_a, block_b=block_b, k_tiles=k_ref,
        interpret=True))
    ts = [torch.from_numpy(x.view(view) if x.dtype == np.uint16 else x) for x in streams]
    got = intersect_compressed_streams(*ts, block_a=block_a, block_b=block_b, k_tiles=k)
    assert got.dtype == torch.bool and got.shape == want.shape == (streams[1].size,)
    np.testing.assert_array_equal(got.numpy(), want)
    if k is None:
        np.testing.assert_array_equal(got.numpy()[:a.size], np.isin(a, b))


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 5), (5, 0), (130, 700), (512, 1024),
                                   (1 << 20, 1 << 20)])
def test_pack_compressed_torch_byte_identical(ref, na, nb):
    """The torch packer's streams against the reference's
    ``pack_delta_stream`` and the port's host ``pack_compressed``, byte for
    byte: empty inputs, lengths off the block multiples and on them, and
    1M postings; repeats and negative values included."""
    rng = np.random.default_rng(na + nb)
    a = np.sort(rng.integers(-5000, 20 * max(na, 1), na)).astype(np.int32)
    b = np.sort(rng.integers(-5000, 20 * max(nb, 1), nb)).astype(np.int32)
    for blocks in ((512, 1024), (64, 192)):
        got = pack_compressed_torch(a, b, block_a=blocks[0], block_b=blocks[1], device="cpu")
        for want in (_ref_streams(a, b, *blocks), pack_compressed(a, b, block_a=blocks[0],
                                                                   block_b=blocks[1])):
            for g, w in zip(got, want):
                g = g.numpy().view(w.dtype)
                assert g.shape == w.shape and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("x", [[0, 70_000], [-70_000], [5, 5 + 65_535], list(range(0, 640_000, 10_001))])
def test_pack_compressed_torch_raises_as_reference(ref, x):
    """An in-block span of 65535 or more raises in both packers, the pad
    slots of the last block counted as the reference counts them."""
    x = np.array(x, np.int64)
    with pytest.raises(ValueError, match="uint16"):
        jops.pack_delta_stream(x, 64 * (-(-x.size // 64)))
    for a, b in ((x, [1]), ([1], x)):
        with pytest.raises(ValueError, match="uint16"):
            pack_compressed_torch(a, b, device="cpu")


def _spoil(bad, ts, kw):
    """Make one argument of a good call of the packed-stream entry point
    wrong (streams of 384 and 2048 slots, blocks 128/256)."""
    a_base, a_delta, b_base, b_delta, starts = ts
    if bad == "a_base int64":
        ts[0] = a_base.long()
    elif bad == "b_delta int32":
        ts[3] = b_delta.int()
    elif bad == "starts int64":
        ts[4] = starts.long()
    elif bad == "a_delta 2-D":
        ts[1] = a_delta.view(-1, 64)
    elif bad == "a not whole blocks":
        ts[0], ts[1] = a_base[:-1], a_delta[:-64]
    elif bad == "b not whole blocks":
        ts[2], ts[3] = b_base[:-1], b_delta[:-64]
    elif bad == "a_base length":
        ts[0] = a_base[:-1]
    elif bad == "b_base length":
        ts[2] = torch.cat([b_base, b_base[:1]])
    elif bad == "starts length":
        ts[4] = starts[:-1]
    elif bad == "block_a 96":
        kw["block_a"] = 96
    elif bad == "empty streams":
        ts[:] = [t[:0] for t in ts]
    elif bad == "b_base on another device":
        ts[2] = b_base.to("meta")


@pytest.mark.parametrize("bad", ["a_base int64", "b_delta int32", "starts int64", "a_delta 2-D",
                                 "a not whole blocks", "b not whole blocks", "a_base length",
                                 "b_base length", "starts length", "block_a 96", "empty streams",
                                 "b_base on another device"])
def test_compressed_streams_checks_raise(bad):
    ts = device_streams(pack_compressed(np.arange(0, 900, 3), np.arange(0, 2000, 2),
                                        block_a=128, block_b=256), "cpu")
    kw = dict(block_a=128, block_b=256, k_tiles=None)
    assert intersect_compressed_streams(*ts, **kw).shape == (384,)
    _spoil(bad, ts, kw)
    with pytest.raises((ValueError, TypeError)):
        intersect_compressed_streams(*ts, **kw)


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


def _compressed_families():
    """The compressed kernel's hazards as (name, a, b, kwargs): a full scan
    at 1M (ranges past the shared-memory buffer), b's all-pad tail blocks
    (base 0, pads decoding to 65535, which a holds) after high values,
    runs of repeats in b (one longer than a 64-block), a sparse a over a
    dense b, and 64-blocks at both ends of the int32 range."""
    rng = np.random.default_rng(24)
    yield "full scan at 1M", _sorted_unique(rng, 100_000, 4 << 20), _sorted_unique(
        rng, 1 << 20, 4 << 20), {}
    b = (2**31 - 2_000_000 + np.cumsum(rng.integers(1, 40, 3000))).astype(np.int32)
    a = np.concatenate([np.arange(1, 64), [65535], np.sort(rng.choice(b, 400, replace=False)),
                        b[-1] + np.arange(1, 50)]).astype(np.int32)
    yield "all-pad tail blocks", a, b, {}
    yield "all-pad tail blocks, k_tiles=1", a, b, dict(k_tiles=1)
    vals = _sorted_unique(rng, 3000, 40_000)
    b = np.sort(np.concatenate([np.repeat(vals, rng.integers(1, 40, vals.size)),
                                np.full(200, vals[1500])])).astype(np.int32)
    a = np.unique(np.concatenate([rng.choice(vals, 1500, replace=False),
                                  rng.integers(0, 40_000, 500)])).astype(np.int32)
    yield "runs of repeats", a, b, dict(block_a=64, block_b=192, k_tiles=2)
    yield "runs of repeats, full scan", a, b, {}
    yield "sparse a over dense b", _sorted_unique(rng, 3000, 10**6), _sorted_unique(
        rng, 200_000, 10**6), {}
    low, top = -(2**31), 2**31 - 1
    b = np.concatenate([low + np.arange(0, 192, 3), top - np.arange(254, -1, -2)]).astype(np.int32)
    a = np.concatenate([low + np.arange(64), top - np.arange(63, -1, -1)]).astype(np.int32)
    yield "int32 extremes", a, b, dict(block_a=64, block_b=64)
    yield "INT_MAX, then pads", a, np.delete(b, np.s_[64:74]), dict(block_a=64, block_b=64)
    yield "pads after values below INT_MAX", a, b[:-10], dict(block_a=64, block_b=64)


def _misaligned(t):
    big = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    big[1:] = t
    assert big[1:].data_ptr() % 16
    return big[1:]


@pytest.mark.cuda
def test_compressed_streams_kernel_matches_plain_cuda(cuda):
    """The packed-stream entry point's kernel against the plain version on
    the hazard families, from int16, uint16 and misaligned deltas; the
    card's packer against the host's, byte for byte."""
    for name, a, b, kw in _compressed_families():
        blocks = {k: v for k, v in kw.items() if k != "k_tiles"}
        host = device_streams(pack_compressed(a, b, **blocks), "cpu")
        for g, w in zip(pack_compressed_torch(a, b, device=cuda, **blocks), host):
            assert torch.equal(g.cpu(), w), name
        k = kw.get("k_tiles")
        want = intersect_compressed_streams(*host, k_tiles=k, **blocks)
        if k is None:
            np.testing.assert_array_equal(want[:a.size].numpy(), np.isin(a, b), err_msg=name)
        a_base, a_delta, b_base, b_delta, starts = (t.to(cuda) for t in host)
        for deltas in ((a_delta, b_delta), (a_delta.view(torch.uint16), b_delta.view(torch.uint16)),
                       (_misaligned(a_delta), _misaligned(b_delta))):
            before = intersect_compressed_streams.launches
            got = intersect_compressed_streams(a_base, deltas[0], b_base, deltas[1], starts,
                                               k_tiles=k, **blocks)
            torch.cuda.synchronize()
            assert intersect_compressed_streams.launches == before + 1
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=name)


@pytest.mark.cuda
def test_wrappers_make_no_host_sync_cuda(cuda):
    """Neither the intersect, the packed-stream compressed intersect nor
    the proximity wrapper waits for the card: the calls run under
    ``set_sync_debug_mode("error")``."""
    from repro_torch.kernels.proximity import proximity_join, proximity_plain

    rng = np.random.default_rng(23)
    a, b = _sorted_unique(rng, 5000, 20000), _sorted_unique(rng, 3000, 20000)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    streams = pack_compressed_torch(a, b, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_i = intersect_sorted(ta, tb, k_tiles=2)
        got_c = intersect_compressed_streams(*streams, k_tiles=2)
        got_p = proximity_join(ta, tb, 5, k_tiles=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ca, cb = torch.from_numpy(a), torch.from_numpy(b)
    _assert_lanes([g.cpu().numpy() for g in got_i],
                  [w.numpy() for w in intersect_plain(ca, cb, k_tiles=2)])
    np.testing.assert_array_equal(
        got_c.cpu().numpy(), intersect_compressed_streams(*(t.cpu() for t in streams),
                                                          k_tiles=2).numpy())
    _assert_lanes([g.cpu().numpy() for g in got_p],
                  [w.numpy() for w in proximity_plain(ca, cb, 5, k_tiles=2)])
