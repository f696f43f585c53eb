"""The plain reference against the port's CPU ``SearchService``: on small
corpora at MaxDistance 5 and 9, of many short documents and of a few long
ones (the configurations' shape), every record of every query type, on the
compiled routes and on the scalar route, equals the reference's records
for the route the response names."""

import numpy as np
import pytest

from harness.corpus import generate_corpus, mixed_queries, stopword_flood
from harness.sut import build_index, make_service
from reference.search import Reference

KINDS = ("qt1", "qt2", "qt3", "qt4", "qt5")
COLS = ("doc", "start", "end", "score")


SHAPES = {"short": (300, 70), "long": (6, 3500)}  # (documents, mean length)


def _world(d: int, seed: int, shape: str = "short"):
    n_docs, mean_len = SHAPES[shape]
    corpus = generate_corpus(n_docs=n_docs, mean_doc_len=mean_len, vocab_size=1500, alpha=1.1,
                             seed=seed)
    corpus.sw_count, corpus.fu_count = 20, 40
    index = build_index(corpus, d)
    ref = Reference(corpus.doc_ids, corpus.positions, corpus.lemma_ids, corpus.doc_lengths,
                    corpus.doc_freqs, max_distance=d, sw_count=corpus.sw_count,
                    fu_count=corpus.fu_count)
    return corpus, index, ref


def _serve(index, queries, **knobs):
    svc = make_service(index, dict(knobs), device="cpu")
    for q in queries:
        svc.submit(q)
    return svc.drain()


def _mismatches(ref, queries, responses, k):
    bad = []
    for q, r in zip(queries, responses):
        want = ref.answer(q, r.path, k)
        got = r.results
        if not all(np.array_equal(np.asarray(got[c]), want[c]) for c in COLS):
            bad.append((q, r.path))
    return bad


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", [5, 9])
@pytest.mark.parametrize("kind", KINDS)
def test_compiled_routes_match_reference(d, kind, shape):
    corpus, index, ref = _world(d, seed=3 + d, shape=shape)
    queries = mixed_queries(corpus, 60, {kind: 1.0}, 3, 5, 9, seed=11)
    responses = _serve(index, queries, buckets=(256, 1024, 4096), max_batch=16, top_k=16)
    compiled = [r for r in responses if r.path in ("qt1", "qt2", "qt34", "qt5")]
    assert len(compiled) > len(responses) // 2
    assert sum(r.results["doc"].size for r in responses) > 0
    assert _mismatches(ref, queries, responses, 16) == []


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", [5, 9])
def test_scalar_route_matches_reference(d, shape):
    """A ladder too short for the hot rows sends them to the scalar route."""
    corpus, index, ref = _world(d, seed=5 + d, shape=shape)
    queries = mixed_queries(corpus, 80, {k: 1.0 for k in KINDS}, 3, 5, 9, seed=13)
    queries += stopword_flood(corpus, 40, hottest=12, min_len=3, max_len=5, seed=17)
    responses = _serve(index, queries, buckets=(64, 128), max_batch=16, top_k=16)
    paths = {r.path for r in responses}
    assert "cpu" in paths and paths & {"qt1", "qt2", "qt34", "qt5"}
    assert _mismatches(ref, queries, responses, 16) == []


def test_long_and_short_qt1_on_the_scalar_route():
    """QT1 queries of two lemmas and of more than MaxDistance lemmas are
    served by the scalar route; the reference serves them the same way."""
    corpus, index, ref = _world(5, seed=21)
    rng = np.random.default_rng(0)
    queries = [[int(x) for x in rng.choice(10, size=n, replace=False)]
               for n in (2, 2, 2, 7, 7, 8)]
    responses = _serve(index, queries, buckets=(256, 1024, 4096), max_batch=16, top_k=16)
    assert {r.path for r in responses} == {"cpu"}
    assert _mismatches(ref, queries, responses, 16) == []


def test_control_precision_changes_records():
    """bfloat16 scores in the reference's place change served records."""
    corpus, index, ref = _world(5, seed=23)
    queries = mixed_queries(corpus, 40, {k: 1.0 for k in KINDS}, 3, 5, 9, seed=29)
    differ = hits = 0
    for q in queries:
        a = ref.answer(q, "qt1", 16)
        b = ref.answer(q, "qt1", 16, precision="bfloat16")
        hits += a["doc"].size > 0
        differ += not all(np.array_equal(a[c], b[c]) for c in COLS)
    assert hits > 10 and differ == hits
