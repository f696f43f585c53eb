"""The port's index state against the reference package: the same seeded
corpus, the same index arrays (built by the port, and carried across
with ``carry_index``), and the same scalar-engine records."""

import numpy as np
import pytest

from repro.core.index_builder import build_index as jax_build_index
from repro.core.search import ProximitySearchEngine as JaxEngine
from repro.data.corpus import generate_corpus as jax_generate_corpus
from repro.data.corpus import sample_typed_queries as jax_sample_typed
from repro.index.persist import index_to_arrays as jax_index_to_arrays

from repro_torch.core.index_builder import build_index
from repro_torch.core.search import ProximitySearchEngine
from repro_torch.data.corpus import generate_corpus, sample_typed_queries
from repro_torch.index import carry_index, index_to_arrays

D = 5
KINDS = ("qt1", "qt2", "qt3", "qt4", "qt5")


def _corpus(gen):
    table, lex = gen(n_docs=400, mean_doc_len=70, vocab_size=1500, seed=21)
    lex.sw_count = 20
    lex.fu_count = 40
    return table, lex


@pytest.fixture(scope="module")
def world():
    jt, jl = _corpus(jax_generate_corpus)
    pt, pl = _corpus(generate_corpus)
    jidx = jax_build_index(jt, jl, max_distance=D)
    pidx = build_index(pt, pl, max_distance=D)
    return jt, jl, jidx, pt, pl, pidx


def _assert_arrays_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_same_seeded_corpus(world):
    jt, jl, _, pt, pl, _ = world
    for col in ("doc_ids", "positions", "lemma_ids", "doc_lengths"):
        np.testing.assert_array_equal(getattr(pt, col), getattr(jt, col))
    assert pl.lemmas == jl.lemmas
    np.testing.assert_array_equal(pl.counts, jl.counts)
    np.testing.assert_array_equal(pl.doc_freqs, jl.doc_freqs)


def test_port_build_equals_reference_build(world):
    _, _, jidx, _, _, pidx = world
    _assert_arrays_equal(index_to_arrays(pidx), jax_index_to_arrays(jidx))
    assert pidx.max_distance == jidx.max_distance
    np.testing.assert_array_equal(pidx.doc_lengths, jidx.doc_lengths)


def test_carry_index_equals_port_build(world):
    _, jl, jidx, _, _, pidx = world
    carried = carry_index(jidx)
    _assert_arrays_equal(index_to_arrays(carried), index_to_arrays(pidx))
    assert carried.lexicon.lemmas == jl.lemmas
    assert (carried.lexicon.sw_count, carried.lexicon.fu_count,
            carried.lexicon.n_docs) == (jl.sw_count, jl.fu_count, jl.n_docs)
    # reads through the carried (blob-backed) stores equal the built ones
    for lemma in range(jl.sw_count, jl.sw_count + 10):
        for a, b in zip(carried.read_ordinary(lemma), pidx.read_ordinary(lemma)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_scalar_engine_records_match_reference(world, kind):
    jt, jl, jidx, pt, pl, pidx = world
    qs = sample_typed_queries(pt, pl, 8, kind, window=D, seed=4)
    assert qs == jax_sample_typed(jt, jl, 8, kind, window=D, seed=4)
    mine = ProximitySearchEngine(pidx, top_k=50, equalize_mode="bulk")
    ref = JaxEngine(jidx, top_k=50, equalize_mode="bulk")
    for q in qs:
        got, _ = mine.search_ids(q)
        want, _ = ref.search_ids(q)
        for col in ("doc", "start", "end", "score"):
            np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                          err_msg=f"{kind} {q} {col}")
