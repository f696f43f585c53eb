"""The port's packers, serve steps and decode against the reference
package, family by family (qt1, qt2, qt34, qt5, raw payload): the same
packed arrays, the same step outputs on a (1, 1) mesh — scores bitwise,
both sides run the same float32 division — and the same decoded
records. Also pins the top-k tie order: among equal scores the lower
lane comes first, as in ``jax.lax.top_k``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import jax_search as ref
from repro.core.index_builder import build_index as jax_build_index
from repro.data.corpus import generate_corpus as jax_generate_corpus
from repro.data.corpus import sample_typed_queries
from repro.launch.mesh import make_mesh

from repro_torch.core import torch_search as port
from repro_torch.index import carry_index

D = 5
L = 512
TOP_K = 16
FAMILIES = {
    # family: (query kinds, packer name, packer kwargs, step factory args)
    "qt1": (("qt1",), "pack_qt1_batch", {"K": 2}, None),
    "qt2": (("qt2",), "pack_qt2_batch", {"K": 3}, "qt2"),
    "qt34": (("qt3", "qt4"), "pack_qt34_batch", {"Kn": 4}, "qt34"),
    "qt5": (("qt5",), "pack_qt5_batch", {"Kn": 3, "Ks": 3}, "qt5"),
}


@pytest.fixture(scope="module")
def world():
    table, lex = jax_generate_corpus(n_docs=300, mean_doc_len=70, vocab_size=800, seed=13)
    lex.sw_count = 14
    lex.fu_count = 30
    jidx = jax_build_index(table, lex, max_distance=D)
    pidx = carry_index(jidx)
    mesh = make_mesh((1, 1), ("data", "model"))
    queries = {k: sample_typed_queries(table, lex, 10, k, window=D, seed=3)
               for k in ("qt1", "qt2", "qt3", "qt4", "qt5")}
    return jidx, pidx, mesh, queries


def _batches(world, family):
    jidx, pidx, _, queries = world
    kinds, packer, kw, _ = FAMILIES[family]
    qs = [q for k in kinds for q in queries[k]] + [[]]  # + one padding slot
    want = getattr(ref, packer)(jidx, qs, L=L, **kw)
    got = getattr(port, packer)(pidx, qs, L=L, **kw)
    return qs, want, got


def _jax_step(mesh, family):
    qtype = FAMILIES[family][3]
    if qtype is None:
        return ref.make_qt1_serve_step(mesh, top_k=TOP_K)
    return ref.make_wv_serve_step(mesh, qtype, top_k=TOP_K, payload="raw",
                                  max_distance=D, r_max=4)


def _port_step(family):
    qtype = FAMILIES[family][3]
    if qtype is None:
        return port.make_qt1_serve_step(top_k=TOP_K)
    return port.make_wv_serve_step(qtype, top_k=TOP_K, max_distance=D, r_max=4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_packers_match_reference(world, family):
    _, want, got = _batches(world, family)
    assert type(got).__name__ == type(want).__name__
    for name, w in vars(want).items():
        g = getattr(got, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=f"{family}.{name}")
        else:
            assert g == w, name
    for a, w in zip(got.device_args("cpu"), want.device_args()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_outputs_and_records_match_reference(world, family):
    qs, want_b, got_b = _batches(world, family)
    _, _, mesh, _ = world
    want = [np.asarray(x) for x in _jax_step(mesh, family)(*want_b.device_args())]
    got = [x.numpy() for x in _port_step(family)(*got_b.device_args("cpu"))]
    for name, g, w in zip(("s", "g", "lo", "hi"), got, want):
        assert g.dtype == w.dtype, name
        # exact, scores included: bitwise-equal float32
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=f"{family} {name}")
    want_rec = ref.decode_results(want_b, *want)
    got_rec = port.decode_results(got_b, *[torch.from_numpy(x) for x in got])
    assert len(got_rec) == len(qs)
    assert sum(r["doc"].size for r in want_rec) > 0, "no hits to compare"
    for g, w in zip(got_rec, want_rec):
        for col in ("doc", "start", "end", "score"):
            np.testing.assert_array_equal(g[col], w[col])


@pytest.mark.parametrize("k", [4, TOP_K])
def test_topk_ties_keep_lower_lane_first(k):
    """More than k lanes tie: the chosen *set* and order must match
    ``lax.top_k`` (lower index first among equal scores)."""
    rng = np.random.default_rng(k)
    score = rng.choice(np.array([0.5, 1.0, -1e30], np.float32), (6, 40))
    score[:, 5:5 + 2 * k] = 2.0  # 2k tied maxima per row
    lanes = np.tile(np.arange(40, dtype=np.int32), (6, 1))
    want = jax.lax.top_k(jnp.asarray(score), k)
    s, g, lo, hi = port.qt1_topk(torch.from_numpy(score), torch.from_numpy(lanes),
                                 torch.from_numpy(lanes), torch.from_numpy(lanes), k)
    np.testing.assert_array_equal(g.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(g.numpy()[:, :k], np.arange(5, 5 + k)[None].repeat(6, 0))


def test_compressed_payload_not_in_this_slice():
    with pytest.raises(NotImplementedError, match="compressed"):
        port.make_wv_serve_step("qt5", payload="delta")
