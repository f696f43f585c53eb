"""The port's SearchService on the CPU against the JAX SearchService on
the same corpus: the same plans from ``explain()``, identical records
over a cold and a warm drain of mixed QT1-QT5 traffic, the same routes,
phases that tile end-to-end latency, and the device/slice guards."""

import numpy as np
import pytest
import torch

from repro.core.index_builder import build_index as jax_build_index
from repro.data.corpus import generate_corpus as jax_generate_corpus
from repro.data.corpus import sample_mixed_queries
from repro.index import SegmentedIndex
from repro.launch.mesh import make_mesh
from repro.serving import SearchService as JaxService
from repro.serving import ServeConfig as JaxConfig

from repro_torch.index import carry_index
from repro_torch.serving import SearchService, ServeConfig

D = 5
KNOBS = dict(buckets=(256, 1024, 4096), max_batch=16, top_k=16)
PHASES = ("queue", "plan", "pack", "compress", "compile", "dispatch",
          "execute", "decode")
EXPLAINED = ("qtype", "route", "step_family", "bucket", "payload",
             "fallback_reason", "est_step_cost", "selection")


@pytest.fixture(scope="module")
def world():
    table, lex = jax_generate_corpus(n_docs=600, mean_doc_len=70, vocab_size=1500, seed=7)
    lex.sw_count = 20
    lex.fu_count = 40
    jidx = jax_build_index(table, lex, max_distance=D)
    queries = sample_mixed_queries(table, lex, 128, window=D, seed=5)
    return jidx, carry_index(jidx), queries


@pytest.fixture(scope="module")
def served(world):
    """Both services, each drained cold then warm over the same traffic."""
    jidx, pidx, queries = world
    jsvc = JaxService(jidx, make_mesh((1, 1), ("data", "model")), JaxConfig(**KNOBS))
    psvc = SearchService(pidx, ServeConfig(**KNOBS), device="cpu")
    rounds = {"jax": [], "port": []}
    for _ in range(2):
        for name, svc in (("jax", jsvc), ("port", psvc)):
            for q in queries:
                svc.submit(q)
            rounds[name].append(svc.drain())
    return jsvc, psvc, rounds


def test_explain_matches_reference(world, served):
    _, _, queries = world
    jsvc, psvc, _ = served
    routes = set()
    for q in queries:
        want, got = jsvc.explain(q), psvc.explain(q)
        for f in EXPLAINED:
            assert getattr(got, f) == getattr(want, f), (f, q)
        routes.add(got.route)
    assert {"qt1", "qt2", "qt34", "qt5"} <= routes


@pytest.mark.parametrize("drain", ["cold", "warm"])
def test_records_match_reference(served, drain):
    _, _, rounds = served
    i = 0 if drain == "cold" else 1
    want, got = rounds["jax"][i], rounds["port"][i]
    assert len(got) == len(want)
    hits = 0
    for g, w in zip(got, want):
        assert g.path == w.path and g.bucket == w.bucket
        for col in ("doc", "start", "end", "score"):
            np.testing.assert_array_equal(g.results[col], w.results[col])
        hits += int(g.results["doc"].size)
    assert hits > 0


def test_phases_tile_e2e_latency(served):
    _, psvc, rounds = served
    for responses in rounds["port"]:
        for r in responses:
            assert set(r.phases) == set(PHASES)
            assert all(v >= 0.0 for v in r.phases.values())
            assert sum(r.phases.values()) == pytest.approx(r.e2e_s, rel=0.10)
    # each (kind, B, L) step warmed up exactly once, on its first batch
    ex = psvc.compiled
    assert ex.stats["compiles"] == len(ex.executables) < ex.stats["batches"]
    assert psvc.metrics_snapshot("serve.phase.")["serve.phase.execute"]["count"] \
        == 2 * len(rounds["port"][0])


def test_stats_routes_match_reference(served):
    jsvc, psvc, _ = served
    js, ps = jsvc.stats_snapshot(), psvc.stats_snapshot()
    assert ps["plans"]["routes"] == js["plans"]["routes"]
    assert ps["plans"]["fallbacks"] == js["plans"]["fallbacks"]
    assert ps["paths"] == js["paths"]
    assert ps["requests"] == js["requests"]
    assert ps["plans"]["shared_batches"] == js["plans"]["shared_batches"]
    assert ps["pack_cache"]["hits"] > 0


def test_default_device_is_the_card(world):
    _, pidx, _ = world
    if torch.cuda.is_available():
        assert SearchService(pidx, ServeConfig(**KNOBS)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SearchService(pidx, ServeConfig(**KNOBS))


@pytest.mark.parametrize("knob", [{"compressed": True}, {"doc_shards": 2}])
def test_later_slices_raise(world, knob):
    _, pidx, _ = world
    with pytest.raises(NotImplementedError, match="slice"):
        SearchService(pidx, ServeConfig(**KNOBS, **knob), device="cpu")


def test_segmented_source_raises(world):
    jidx, _, _ = world
    seg = SegmentedIndex(jidx.lexicon, max_distance=D)
    with pytest.raises(NotImplementedError, match="SegmentedIndex"):
        SearchService(seg, ServeConfig(**KNOBS), device="cpu")
