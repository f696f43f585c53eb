"""The port's embedding bag against the reference package.

Seeded numpy inputs go through the JAX entry point on its Pallas path
(``use_pallas=True``, interpret mode on the CPU, as ``test_kernels.py``
runs it) and through the port on the CPU, where the wrapper takes its
plain version. Tolerances are those of ``test_kernels.py``: rtol 1e-6,
atol 1e-5 in float32 (the two add the bag in different orders) and 2e-2
in bfloat16. The CUDA kernel is held to the plain version on a card
(``-k cuda``; skipped without one): both add in the same order, so they
must agree to the bit.

The reference imports are optional so that the card test can run on a
host without JAX; here they are always present."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_plain
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

try:
    import jax.numpy as jnp
    from repro.kernels.embedding_bag import ops as jops
    from repro.kernels.embedding_bag import ref as jref
except ImportError:  # a card host without JAX runs only the card test
    jnp = None

DTYPES = {"float32": (torch.float32, 1e-6, 1e-5), "bfloat16": (torch.bfloat16, 2e-2, 2e-2)}


@pytest.fixture
def ref():
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, B, S, V, D, lo=-1, hi=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(lo, V if hi is None else hi, (B, S)).astype(np.int32)
    w = rng.normal(size=(B, S)).astype(np.float32)
    table = rng.normal(size=(V, D)).astype(np.float32)
    return ids, w, table


def _port(ids, table, w, combine, dtype):
    t = torch.from_numpy(table).to(dtype)
    tw = None if w is None else torch.from_numpy(w)
    return embedding_bag(torch.from_numpy(ids), t, tw, combine).float().numpy()


def _jax(ids, table, w, combine, dtype, **kw):
    jt = jnp.asarray(table, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jw = None if w is None else jnp.asarray(w)
    out = jops.embedding_bag(jnp.asarray(ids), jt, jw, combine, use_pallas=True, **kw)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("B,S,V,D", [
    (32, 8, 100, 16),
    (130, 5, 513, 32),   # non-multiples
    (8, 1, 2000, 64),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bag_matches_pallas_shapes(ref, B, S, V, D, dtype):
    torch_dtype, rtol, atol = DTYPES[dtype]
    ids, _, table = _inputs(B + V, B, S, V, D)
    got = _port(ids, table, None, "sum", torch_dtype)
    want = _jax(ids, table, None, "sum", torch_dtype, block_b=32, block_v=128)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bag_weights_and_mean(ref, combine, weighted, dtype):
    torch_dtype, rtol, atol = DTYPES[dtype]
    ids, w, table = _inputs(7, 16, 6, 50, 8)
    w = w if weighted else None
    got = _port(ids, table, w, combine, torch_dtype)
    want = _jax(ids, table, w, combine, torch_dtype, block_b=8, block_v=16)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_bag_ids_outside_vocabulary(ref, combine):
    """Ids >= V contribute nothing but count in mean's denominator."""
    ids, w, table = _inputs(3, 12, 7, 40, 16, lo=-1, hi=60)
    assert (ids >= 40).any()
    got = _port(ids, table, w, combine, torch.float32)
    want = _jax(ids, table, w, combine, torch.float32, block_b=8, block_v=16)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("ids", [[[1]], [[-1]], [[7, 2]], [[-1, -1]]])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_bag_one_element(ref, ids, combine):
    ids = np.array(ids, np.int32)
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = _port(ids, table, None, combine, torch.float32)
    np.testing.assert_array_equal(got, _jax(ids, table, None, combine, torch.float32))


@pytest.mark.parametrize("shape", ["batch", "bag", "vocab", "width"])
def test_bag_empty_raises_as_reference(ref, shape):
    ids = np.zeros({"batch": (0, 3), "bag": (2, 0)}.get(shape, (1, 1)), np.int32)
    table = np.ones({"vocab": (0, 3), "width": (4, 0)}.get(shape, (4, 3)), np.float32)
    with pytest.raises((TypeError, ZeroDivisionError)):
        _jax(ids, table, None, "sum", torch.float32)
    with pytest.raises(ValueError):
        _port(ids, table, None, "sum", torch.float32)


def test_bag_unknown_combine_raises():
    ids, _, table = _inputs(0, 2, 2, 4, 3)
    with pytest.raises(ValueError, match="combine"):
        _port(ids, table, None, "max", torch.float32)


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_oracle_equals_reference(ref, combine):
    ids, w, table = _inputs(5, 16, 6, 50, 8)
    got = embedding_bag_ref(torch.from_numpy(ids), torch.from_numpy(table),
                            torch.from_numpy(w), combine).numpy()
    want = np.asarray(jref.embedding_bag_ref(jnp.asarray(ids), jnp.asarray(table),
                                             jnp.asarray(w), combine))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
def test_kernel_matches_plain_cuda(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        for combine in ("sum", "mean"):
            for weighted in (False, True):
                ids, w, table = _inputs(9, 33, 17, 3000, 200, lo=-1, hi=3100)
                t = torch.from_numpy(table).to(dtype)
                tw = torch.from_numpy(w) if weighted else None
                want = embedding_bag_plain(torch.from_numpy(ids), t, tw, combine)
                before = embedding_bag.launches
                got = embedding_bag(torch.from_numpy(ids).to(cuda), t.to(cuda),
                                    None if tw is None else tw.to(cuda), combine)
                torch.cuda.synchronize()
                assert embedding_bag.launches == before + 1
                assert torch.equal(got.cpu(), want)


def _shifted(table: torch.Tensor) -> torch.Tensor:
    """A contiguous view of ``table`` one element into a larger buffer:
    its base is 4 or 2 bytes off 16-byte alignment."""
    big = torch.empty(table.numel() + 1, dtype=table.dtype, device=table.device)
    big[1:] = table.flatten()
    return big[1:].view(table.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["D1", "D3", "D12", "D129", "shifted", "repeats", "all-pad",
                                  "S7", "S33", "S65"])
def test_kernel_edges_match_plain_cuda(cuda, case):
    """Row widths off the kernel's 16-byte loads, a misaligned table,
    repeated ids, all-pad bags and bag lengths off its 8-row and 32-id
    steps: float32 equal to the plain version to the bit, bfloat16 too
    (the same float32 sums, one rounding)."""
    D = int(case[1:]) if case.startswith("D") else 64
    S = int(case[1:]) if case.startswith("S") else 13
    ids, w, table = _inputs(len(case), 40, S, 300, D, lo=-1, hi=330)
    if case == "repeats":
        ids = np.random.default_rng(0).integers(0, 3, ids.shape).astype(np.int32)
    if case == "all-pad":
        ids[::2] = -1
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(table).to(dtype)
        tc = _shifted(t.to(cuda)) if case == "shifted" else t.to(cuda)
        assert (tc.data_ptr() % 16 != 0) == (case == "shifted")
        for combine in ("sum", "mean"):
            for tw in (None, torch.from_numpy(w)):
                want = embedding_bag_plain(torch.from_numpy(ids), t, tw, combine)
                got = embedding_bag(torch.from_numpy(ids).to(cuda), tc,
                                    None if tw is None else tw.to(cuda), combine)
                assert torch.equal(got.cpu(), want), (dtype, combine, tw is None)
