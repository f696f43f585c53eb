"""The port's compressed payloads against the reference package: the host
encoding (``_delta16_blocks``, ``compress_*_batch``, ``compress_*_rows``)
byte for byte and dtype for dtype, the per-batch assembly from the
compressed-row cache (kind and arrays), and the delta and offsets serve
steps, whose four outputs must equal the reference step's on a (1, 1)
mesh, scores bitwise. The deltas reach the port's steps both as uint16
and as their int16 bits. The card tests (``-m cuda``) hold the steps on a
card to their CPU run and check the uint16 widening there.

The reference imports are optional so that the card tests can run on a
host without JAX; here they are always present."""

import numpy as np
import pytest
import torch

from repro_torch.core import torch_search as port
from repro_torch.index import carry_index
from repro_torch.kernels.common import SENTINEL
from repro_torch.kernels.nearest_r import window_join
from repro_torch.serving.pack_cache import PackedPostingCache

try:
    import jax.numpy as jnp
    from repro.core import jax_search as ref
    from repro.core.index_builder import build_index as jax_build_index
    from repro.core.lexicon import Lexicon
    from repro.data.corpus import TokenTable
    from repro.data.corpus import generate_corpus as jax_generate_corpus
    from repro.data.corpus import sample_typed_queries
    from repro.launch.mesh import make_mesh
    from repro.serving.pack_cache import PackedPostingCache as JaxCache
except ImportError:  # a card host without JAX runs only the card tests
    jnp = None

D = 5
L = 512
TOP_K = 16
PAYLOADS = ("delta", "offsets")
FAMILIES = {
    # family: (query kinds, packer, compressor, assembler, K kwargs, qtype)
    "qt1": (("qt1",), "pack_qt1_batch", "compress_qt1_batch",
            "assemble_qt1_compressed", {"K": 2}, None),
    "qt2": (("qt2",), "pack_qt2_batch", "compress_qt2_batch",
            "assemble_qt2_compressed", {"K": 3}, "qt2"),
    "qt34": (("qt3", "qt4"), "pack_qt34_batch", "compress_qt34_batch",
             "assemble_qt34_compressed", {"Kn": 4}, "qt34"),
    "qt5": (("qt5",), "pack_qt5_batch", "compress_qt5_batch",
            "assemble_qt5_compressed", {"Kn": 3, "Ks": 3}, "qt5"),
}


@pytest.fixture(scope="module")
def ref_pkg():
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture(scope="module")
def world(ref_pkg):
    table, lex = jax_generate_corpus(n_docs=300, mean_doc_len=70, vocab_size=800, seed=13)
    lex.sw_count = 14
    lex.fu_count = 30
    jidx = jax_build_index(table, lex, max_distance=D)
    queries = {k: sample_typed_queries(table, lex, 10, k, window=D, seed=3)
               for k in ("qt1", "qt2", "qt3", "qt4", "qt5")}
    return jidx, carry_index(jidx), make_mesh((1, 1), ("data", "model")), queries


def _overflow_world():
    """A copy of ``tests/test_wv_serve.py``'s far-apart corpus: its hot
    keys recur in documents so far apart that one 64-posting delta block
    spans more than uint16, so compressed serving falls back to the
    offsets format on every path."""
    sw_count, fu_count = 6, 6
    fu = sw_count  # first frequently-used lemma
    ordinary = sw_count + fu_count
    pattern = [0, 1, 2, fu, fu + 1, ordinary, ordinary + 1]
    filler = [[ordinary + 2] for _ in range(5200)]  # 5200 * stride(14) > 2**16
    docs = [np.array(pattern)] + [np.array(f) for f in filler] + [np.array(pattern)]
    table = TokenTable.from_docs(docs)
    n = ordinary + 3
    counts = np.arange(n, 0, -1) * 100
    dfs = np.minimum(counts, len(docs))
    lex = Lexicon.from_rank_counts(counts=counts, doc_freqs=dfs, n_docs=len(docs),
                                   sw_count=sw_count, fu_count=fu_count)
    idx = jax_build_index(table, lex, max_distance=D)
    return idx, [[0, 1, 2], [fu, fu + 1], [0, fu, fu + 1]]


@pytest.fixture(scope="module")
def overflow(ref_pkg):
    jidx, queries = _overflow_world()
    return jidx, carry_index(jidx), queries


def _queries(world, family):
    kinds = FAMILIES[family][0]
    return [q for k in kinds for q in world[3][k]] + [[]]  # + one padding slot


def _batches(world, family):
    jidx, pidx, _, _ = world
    _, packer, _, _, kw, _ = FAMILIES[family]
    qs = _queries(world, family)
    return getattr(ref, packer)(jidx, qs, L=L, **kw), getattr(port, packer)(pidx, qs, L=L, **kw)


def _assert_same_arrays(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, (what, i)
            continue
        w = np.asarray(w)
        assert isinstance(g, np.ndarray), (what, i, type(g))
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} [{i}]")


# -- host encoding ---------------------------------------------------------------
def _delta_rows():
    """(3, 4, 256) int64 rows of 64-blocks: live keys then pads, a block
    that straddles pads (pads first, live keys after, as a shard segment
    boundary leaves them), an all-pad block, and a row whose block span
    is exactly 65535 (the widest that fits)."""
    rng = np.random.default_rng(5)
    g = np.cumsum(rng.integers(1, 300, (3, 4, 256)), axis=-1) + 10_000
    g[0, 1, 100:] = SENTINEL
    g[0, 2, 128:160] = SENTINEL  # pads at the head of block 2, live keys after
    g[1, :, 192:] = SENTINEL  # an all-pad block in every row
    g[2, 0, :] = SENTINEL
    g[2, 3, 0] = g[2, 3, 63] - 65535
    return g


def test_delta16_blocks_match_reference(ref_pkg):
    g = _delta_rows()
    want = ref._delta16_blocks(g)
    got = port._delta16_blocks(g)
    assert want[2] and got[2]
    _assert_same_arrays(got[:2], want[:2], "delta16")
    assert (got[0][1, :, 3] == 0).all()  # an all-pad block's base is 0
    assert got[0][0, 2, 2] == g[0, 2, 160]  # base = min over live postings
    g[2, 3, 0] -= 1  # span 65536: one past uint16
    assert ref._delta16_blocks(g)[2] is False
    assert port._delta16_blocks(g) == (None, None, False)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_compress_batch_matches_reference(world, family, payload):
    want_b, got_b = _batches(world, family)
    fn = FAMILIES[family][2]
    want = getattr(ref, fn)(want_b, delta_g=(payload == "delta"))
    got = getattr(port, fn)(got_b, delta_g=(payload == "delta"))
    _assert_same_arrays(got, want, f"{family} {payload}")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_compress_batch_overflow_raises(overflow, family):
    jidx, pidx, queries = overflow
    _, packer, fn, _, kw, _ = FAMILIES[family]
    qs = {"qt1": queries[:1], "qt2": queries[1:2]}.get(family, queries[2:])
    if family == "qt34":
        qs = [[6, 7, 12]]  # two frequently-used lemmas and an ordinary one
    want_b = getattr(ref, packer)(jidx, qs, L=256, **kw)
    got_b = getattr(port, packer)(pidx, qs, L=256, **kw)
    with pytest.raises(ValueError, match="uint16"):
        getattr(ref, fn)(want_b)
    with pytest.raises(ValueError, match="uint16"):
        getattr(port, fn)(got_b)
    _assert_same_arrays(getattr(port, fn)(got_b, delta_g=False),
                        getattr(ref, fn)(want_b, delta_g=False), f"{family} offsets")


ROWS = {  # kind: (row packer, row compressor)
    "fst": ("pack_fst_key_rows", "compress_fst_rows"),
    "wv": ("pack_wv_key_rows", "compress_wv_rows"),
    "ord": ("pack_ord_key_rows", "compress_ord_rows"),
    "nsw": ("pack_nsw_key_rows", "compress_nsw_rows"),
}


def _row_keys(jidx, queries):
    from repro.core.query import qt2_plan, qt5_plan, select_fst_keys

    keys = {"fst": [k for q in queries["qt1"][:4] for k in select_fst_keys(q)[1]],
            "wv": [k for q in queries["qt2"][:4] for k in qt2_plan(jidx, q)[0]],
            "ord": [], "nsw": []}
    for q in queries["qt5"][:4]:
        anchor, others, stops, _ = qt5_plan(jidx, q)
        keys["ord"] += [anchor] + [lemma for lemma, _ in others]
        keys["nsw"] += [(anchor, sid) for sid, _ in stops]
    return keys


@pytest.mark.parametrize("width", [L, 200])  # 200: off the 64-block grid
@pytest.mark.parametrize("kind", list(ROWS))
def test_compress_rows_match_reference(world, overflow, kind, width):
    jidx, pidx, _, queries = world
    packer, fn = ROWS[kind]
    keys = _row_keys(jidx, queries)[kind]
    assert keys
    cases = [(jidx, pidx, k) for k in keys]
    if kind in ("fst", "wv", "ord"):  # the far-apart corpus's keys overflow uint16
        ojidx, opidx, oq = overflow
        okey = {"fst": _row_keys(ojidx, {"qt1": oq[:1], "qt2": [], "qt5": []})["fst"][0],
                "wv": _row_keys(ojidx, {"qt1": [], "qt2": oq[1:2], "qt5": []})["wv"][0],
                "ord": 6}[kind]
        cases.append((ojidx, opidx, okey))
    oks = []
    for j, p, key in cases:
        want = getattr(ref, fn)(getattr(ref, packer)(j, key, width))
        got = getattr(port, fn)(getattr(port, packer)(p, key, width))
        assert got[-2:] == want[-2:], (kind, key)  # (delta_ok, present)
        _assert_same_arrays(got[:-2], want[:-2], f"{kind} {key}")
        oks.append(got[-2])
    if kind != "nsw" and width == L:
        assert oks[-1] is False and True in oks[:-1]


# -- assembly from the compressed-row cache ------------------------------------
def _assemble(world_j, world_p, family, qs, bucket, use_cache=True):
    fn, kw = FAMILIES[family][3], FAMILIES[family][4]
    jraw, praw = (JaxCache(), PackedPostingCache()) if use_cache else (None, None)
    jc, pc = JaxCache(source=jraw), PackedPostingCache(source=praw)
    want = getattr(ref, fn)(world_j, qs, bucket, ccache=jc, cache=jraw, **kw)
    got = getattr(port, fn)(world_p, qs, bucket, ccache=pc, cache=praw, **kw)
    return got, want


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_assemble_matches_reference(world, overflow, family, use_cache):
    jidx, pidx, _, _ = world
    got, want = _assemble(jidx, pidx, family, _queries(world, family), L, use_cache)
    prefix = "" if family == "qt1" else f"{family}_"
    assert got[0] == want[0] == prefix + "delta"
    _assert_same_arrays(got[1], want[1], family)
    for name, w in vars(want[2]).items():  # the decode stub
        g = getattr(got[2], name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w, name
    # the far-apart corpus: every family falls back to offsets
    ojidx, opidx, oq = overflow
    qs = {"qt1": oq[:1], "qt2": oq[1:2], "qt34": [[6, 7, 12]], "qt5": oq[2:]}[family]
    got, want = _assemble(ojidx, opidx, family, qs + [[]], 256, use_cache)
    assert got[0] == want[0] == prefix + "offsets"
    _assert_same_arrays(got[1], want[1], f"{family} offsets")
    # a bucket off the 64-block grid is served as offsets too
    got, want = _assemble(jidx, pidx, family, _queries(world, family), 200, use_cache)
    assert got[0] == want[0] == prefix + "offsets"


# -- the compressed steps --------------------------------------------------------
def _jax_step(mesh, family, payload):
    qtype = FAMILIES[family][5]
    if qtype is None:
        return ref.make_qt1_serve_step_compressed(mesh, top_k=TOP_K,
                                                  delta_g=(payload == "delta"))
    return ref.make_wv_serve_step(mesh, qtype, top_k=TOP_K, payload=payload,
                                  max_distance=D, r_max=4)


def _port_step(family, payload):
    qtype = FAMILIES[family][5]
    if qtype is None:
        return port.make_qt1_serve_step_compressed(top_k=TOP_K, delta_g=(payload == "delta"))
    return port.make_wv_serve_step(qtype, top_k=TOP_K, payload=payload, max_distance=D, r_max=4)


def _as_tensors(args, int16_bits=False, device="cpu"):
    out = []
    for a in args:
        if int16_bits and a.dtype == np.uint16:
            a = a.view(np.int16)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return out


def _bitwise(got, want, what):
    for name, g, w in zip(("s", "g", "lo", "hi"), got, want):
        assert g.dtype == w.dtype, (what, name)
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=f"{what} {name}")


@pytest.mark.parametrize("int16_bits", [False, True])
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_compressed_step_matches_reference(world, family, payload, int16_bits):
    _, _, mesh, _ = world
    want_b, got_b = _batches(world, family)
    fn = FAMILIES[family][2]
    jargs = getattr(ref, fn)(want_b, delta_g=(payload == "delta"))
    pargs = getattr(port, fn)(got_b, delta_g=(payload == "delta"))
    want = [np.asarray(x) for x in _jax_step(mesh, family, payload)(*jargs)]
    got = [x.numpy() for x in _port_step(family, payload)(*_as_tensors(pargs, int16_bits))]
    _bitwise(got, want, f"{family} {payload}")
    assert (want[0] > -1e29).any(), "no hits to compare"
    # the records equal the raw step's
    raw = [x.numpy() for x in (port.make_qt1_serve_step(top_k=TOP_K) if family == "qt1"
                               else _port_step(family, "raw"))(*got_b.device_args("cpu"))]
    for g, w in zip(port.decode_results(got_b, *map(torch.from_numpy, got)),
                    port.decode_results(got_b, *map(torch.from_numpy, raw))):
        for col in ("doc", "start", "end", "score"):
            np.testing.assert_array_equal(g[col], w[col])


def test_widen_u16_values():
    vals = np.array([0, 1, 32767, 32768, 65534, 65535], np.uint16)
    want = vals.astype(np.int32)
    for t in (torch.from_numpy(vals), torch.from_numpy(vals.view(np.int16))):
        got = port._widen_u16(t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_delta_decode_repeats_each_base_over_its_block(ref_pkg):
    base = np.array([[[7, 1 << 30]]], np.int32)
    delta = np.arange(128, dtype=np.uint16).reshape(1, 1, 128) * 500
    got = port._delta_decode(torch.from_numpy(base), torch.from_numpy(delta)).numpy()
    want = np.asarray(jnp.repeat(jnp.asarray(base), 64, axis=2) + jnp.asarray(delta).astype(jnp.int32))
    np.testing.assert_array_equal(got, want)


def test_wv_step_rejects_an_unknown_payload():
    with pytest.raises(AssertionError):
        port.make_wv_serve_step("qt5", payload="zstd")


# -- on a card -------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_widen_u16_cuda(cuda):
    vals = np.array([0, 32767, 32768, 65535], np.uint16)
    for t in (torch.from_numpy(vals).to(cuda), torch.from_numpy(vals.view(np.int16)).to(cuda)):
        got = port._widen_u16(t)
        assert got.device.type == "cuda" and got.dtype == torch.int32
        np.testing.assert_array_equal(got.cpu().numpy(), vals.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("int16_bits", [False, True])
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_compressed_step_cuda_equals_cpu(cuda, family, payload, int16_bits):
    """Synthetic rows (no JAX needed): the step on the card equals its CPU
    run bitwise; qt34 and qt5 launch the window-join kernel."""
    rng = np.random.default_rng(list(FAMILIES).index(family) * 2 + PAYLOADS.index(payload))
    B, K, L_ = 8, 3, 1024
    rows = np.cumsum(rng.integers(1, 6, (B * K + B, L_)), axis=1).astype(np.int32) + 100
    rows[rng.random(rows.shape[0]) < 0.2, L_ // 2:] = SENTINEL
    idf = rng.random(B).astype(np.float32) + 1
    adj = rng.integers(1, 4, B).astype(np.float32)
    if family == "qt1":
        g = rows[:B * 2].reshape(B, 2, L_)
        batch = port.QT1Batch(g, np.where(g == SENTINEL, SENTINEL, g - 2),
                              np.where(g == SENTINEL, SENTINEL, g + 3), idf, adj, 1000)
    elif family == "qt2":
        lo = rows[:B * K].reshape(B, K, L_)
        batch = port.QT2Batch(lo, np.where(lo == SENTINEL, SENTINEL, lo + 4),
                              np.full(B, K, np.int32), idf, adj, 1000)
    elif family == "qt34":
        batch = port.QT34Batch(rows[B * K:], rows[:B * K].reshape(B, K, L_),
                               np.ones((B, K), np.int32), idf, adj, 1000)
    else:
        batch = port.QT5Batch(rows[B * K:], rows[:B * K].reshape(B, K, L_),
                              np.ones((B, K), np.int32),
                              rng.integers(0, 4, (B, 2, L_)).astype(np.int32),
                              rng.integers(-D, D + 1, (B, 2, L_)).astype(np.int32),
                              np.ones((B, 2), np.int32), idf, adj, 1000)
    args = getattr(port, FAMILIES[family][2])(batch, delta_g=(payload == "delta"))
    step = _port_step(family, payload)
    want = [x.numpy() for x in step(*_as_tensors(args))]
    before = window_join.launches
    got = [x.cpu().numpy() for x in step(*_as_tensors(args, int16_bits, cuda))]
    _bitwise(got, want, f"{family} {payload}")
    if family in ("qt34", "qt5"):
        assert window_join.launches == before + 1
