"""The port's SearchService on the CPU against the JAX SearchService on
the same corpus: the same plans from ``explain()``, identical records
over a cold and a warm drain of mixed QT1-QT5 traffic, the same routes,
phases that tile end-to-end latency, and the device guard. The
compressed service (delta16 and offsets payloads, with and without the
compressed-row cache and the measured payload arbitration) serves the
reference's records, payloads and compressed stats, on the mixed traffic
and on a corpus whose block spans overflow uint16. Also the load harness
(arrival schedules equal to the reference's, closed- and open-loop runs)
and the serve CLI."""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.index_builder import build_index as jax_build_index
from repro.core.lexicon import Lexicon
from repro.data.corpus import TokenTable
from repro.data.corpus import generate_corpus as jax_generate_corpus
from repro.data.corpus import sample_mixed_queries
from repro.launch.mesh import make_mesh
from repro.serving import SearchService as JaxService
from repro.serving import ServeConfig as JaxConfig
from repro.serving import load as jax_load

from repro_torch.index import carry_index
from repro_torch.launch import serve as cli
from repro_torch.serving import (
    LoadReport,
    SearchService,
    ServeConfig,
    bursty_arrivals,
    poisson_arrivals,
    run_closed_loop,
    run_open_loop,
    warm_service,
)

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


# -- compressed payloads ----------------------------------------------------------
MESH = make_mesh((1, 1), ("data", "model"))
COMPRESSED = {  # (use_compressed_cache, payload_cost_driven)
    "cache+costs": (True, True),
    "cache": (True, False),
    "no-cache+costs": (False, True),
    "no-cache": (False, False),
}
# the payload arbitration explores the compressed arm, then the raw arm,
# in an order fixed by the batch counts, then serves each group's
# measured-cheaper arm. Both packages' cost models are fed the same
# per-query times (MEASURED_US), so the measured choices are the same in
# both: raw for the RAW_CHEAPER families, the compressed format for the rest
DRAINS = 5
RAW_CHEAPER = ("qt5",)
MEASURED_US = {"cheaper": 1.0, "dearer": 2.0}


def _payload(r):
    return None if r.plan is None else r.plan.payload


def _assert_same_responses(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.path == w.path and g.bucket == w.bucket
        assert _payload(g) == _payload(w)
        for col in ("doc", "start", "end", "score"):
            np.testing.assert_array_equal(g.results[col], w.results[col])


def _fix_measured_times(svc) -> None:
    """Make the service's payload cost model observe MEASURED_US instead
    of its own wall-clock batch times."""
    costs = svc.payload_costs
    if costs is None:
        return
    observe = costs.observe

    def fixed(family, bucket, payload, us_per_query):
        cheaper = (payload == "raw") == (family in RAW_CHEAPER)
        observe(family, bucket, payload, MEASURED_US["cheaper" if cheaper else "dearer"])

    costs.observe = fixed


@pytest.fixture(scope="module", params=list(COMPRESSED))
def compressed(request, world):
    """Both compressed services, each drained DRAINS times over the same
    traffic, and the port's raw service's records for the same queries."""
    jidx, pidx, queries = world
    use_cache, cost_driven = COMPRESSED[request.param]
    knobs = dict(KNOBS, compressed=True, use_compressed_cache=use_cache,
                 payload_cost_driven=cost_driven)
    jsvc = JaxService(jidx, MESH, JaxConfig(**knobs))
    psvc = SearchService(pidx, ServeConfig(**knobs), device="cpu")
    rounds = {"jax": [], "port": []}
    for svc in (jsvc, psvc):
        _fix_measured_times(svc)
    for _ in range(DRAINS):
        for name, svc in (("jax", jsvc), ("port", psvc)):
            for q in queries:
                svc.submit(q)
            rounds[name].append(svc.drain())
    return request.param, jsvc, psvc, rounds


@pytest.mark.parametrize("drain", range(DRAINS))
def test_compressed_records_and_payloads_match_reference(compressed, drain):
    _, _, _, rounds = compressed
    _assert_same_responses(rounds["port"][drain], rounds["jax"][drain])
    assert sum(int(r.results["doc"].size) for r in rounds["port"][drain]) > 0


def test_compressed_records_equal_raw_service(compressed, served):
    _, _, _, rounds = compressed
    raw = served[2]["port"][1]
    for responses in rounds["port"]:
        for g, w in zip(responses, raw):
            for col in ("doc", "start", "end", "score"):
                np.testing.assert_array_equal(g.results[col], w.results[col])


def test_compressed_stats_match_reference(compressed):
    name, jsvc, psvc, rounds = compressed
    js, ps = jsvc.stats_snapshot(), psvc.stats_snapshot()
    for key in ("compressed_batches", "offset_fallbacks", "batches", "paths"):
        assert ps[key] == js[key], key
    assert ps["compressed_batches"] > 0
    payloads = {_payload(r) for rs in rounds["port"] for r in rs}
    assert "delta16" in payloads
    if COMPRESSED[name][1]:  # the raw arm was explored from the second drain on
        assert "raw" in payloads
        n = lambda t: {k: {arm: v[arm]["n"] for arm in v if arm != "chosen"}  # noqa: E731
                       for k, v in t.items()}
        assert n(ps["plans"]["payload_costs"]) == n(js["plans"]["payload_costs"])
        chosen = lambda t: {k: v.get("chosen") for k, v in t.items()}  # noqa: E731
        assert chosen(ps["plans"]["payload_costs"]) == chosen(js["plans"]["payload_costs"])
    else:
        assert "payload_costs" not in ps["plans"]
    if COMPRESSED[name][0]:
        assert ps["compressed_cache"]["hits"] > 0
        for key in ("hits", "misses", "entries"):
            assert ps["compressed_cache"][key] == js["compressed_cache"][key], key
    else:
        assert psvc.compressed_cache is None and not ps["compressed_cache"]


def test_compressed_phases_tile_e2e_latency(compressed):
    _, _, psvc, rounds = compressed
    compress = 0.0
    for responses in rounds["port"]:
        for r in responses:
            assert set(r.phases) == set(PHASES)
            assert sum(r.phases.values()) == pytest.approx(r.e2e_s, rel=0.10)
            compress += r.phases["compress"]
    # only the cache-less path encodes in a compress phase of its own
    assert (compress > 0) == (psvc.compressed_cache is None)


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
def overflow():
    jidx, queries = _overflow_world()
    return jidx, carry_index(jidx), queries


@pytest.mark.parametrize("use_cache", [True, False])
def test_uint16_overflow_served_as_offsets(overflow, use_cache):
    jidx, pidx, queries = overflow
    knobs = dict(buckets=(256,), max_batch=4, top_k=64)
    comp = dict(knobs, compressed=True, use_compressed_cache=use_cache)
    jsvc = JaxService(jidx, MESH, JaxConfig(**comp))
    psvc = SearchService(pidx, ServeConfig(**comp), device="cpu")
    raw = SearchService(pidx, ServeConfig(**knobs), device="cpu")
    for _ in range(2):
        out = {}
        for name, svc in (("jax", jsvc), ("port", psvc), ("raw", raw)):
            for q in queries:
                svc.submit(q)
            out[name] = svc.drain()
        _assert_same_responses(out["port"], out["jax"])
        assert {_payload(r) for r in out["port"]} == {"offsets"}
        for g, w in zip(out["port"], out["raw"]):
            assert g.results["doc"].size > 0
            for col in ("doc", "start", "end", "score"):
                np.testing.assert_array_equal(g.results[col], w.results[col])
    ps, js = psvc.stats_snapshot(), jsvc.stats_snapshot()
    assert ps["offset_fallbacks"] == ps["compressed_batches"] == js["offset_fallbacks"] >= 3


def test_compressed_max_distance_over_254_raises(world):
    jidx, pidx, _ = world
    jidx, pidx = copy.copy(jidx), copy.copy(pidx)
    jidx.max_distance = pidx.max_distance = 255
    with pytest.raises(ValueError, match="254"):
        JaxService(jidx, MESH, JaxConfig(**KNOBS, compressed=True))
    with pytest.raises(ValueError, match="254"):
        SearchService(pidx, ServeConfig(**KNOBS, compressed=True), device="cpu")


# -- the load harness -------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_arrival_schedules_match_reference(seed):
    assert poisson_arrivals(500.0, 0.5, seed=seed) == jax_load.poisson_arrivals(500.0, 0.5, seed=seed)
    for kw in ({}, {"burst_factor": 4.0}, {"burst_factor": 1.5, "mean_on_s": 0.1}):
        assert (bursty_arrivals(400.0, 1.0, seed=seed, **kw)
                == jax_load.bursty_arrivals(400.0, 1.0, seed=seed, **kw))


@pytest.mark.parametrize("call", [
    lambda m: m.poisson_arrivals(0.0, 1.0),
    lambda m: m.bursty_arrivals(-1.0, 1.0),
    lambda m: m.bursty_arrivals(10.0, 1.0, burst_factor=0.5),
])
def test_arrival_schedules_reject_bad_rates(call):
    import repro_torch.serving.load as port_load

    for mod in (port_load, jax_load):
        with pytest.raises(ValueError):
            call(mod)


def test_closed_and_open_loop_reports(world):
    _, pidx, queries = world
    svc = SearchService(pidx, ServeConfig(**KNOBS, compressed=True, admission=True,
                                          default_deadline_s=0.5, max_queue=64),
                        device="cpu")
    n = warm_service(svc, queries[:24])
    assert n == svc.compiled.n_executables > 0
    closed = run_closed_loop(svc, queries, 48, batch=16, deadline_s=0.5)
    assert isinstance(closed, LoadReport) and closed.mode == "closed"
    assert closed.n_offered == closed.n_served + closed.n_rejected + closed.n_shed == 48
    assert closed.achieved_qps > 0 and 0.0 <= closed.met_rate <= 1.0
    arrivals = poisson_arrivals(0.5 * closed.achieved_qps, 0.4, seed=3)
    opened = run_open_loop(svc, queries, arrivals, deadline_s=0.5)
    assert opened.mode == "open" and opened.process == "poisson"
    assert opened.n_offered == len(arrivals)
    assert opened.n_served + opened.n_rejected + opened.n_shed == len(arrivals)
    assert set(opened.phase_us) == set(PHASES)
    assert opened.as_dict()["e2e_p95_us"] >= opened.e2e_p50_us > 0
    assert not svc._queue  # every ticket resolved


# -- the serve CLI ----------------------------------------------------------------
REPO = Path(__file__).resolve().parent.parent


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--n-docs", "200", "--requests", "48", *args],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_cli_serves_on_cpu(tmp_path):
    trace = tmp_path / "trace.json"
    out = _cli("--deadline-ms", "50", "--trace-out", str(trace))
    assert "served 48 requests" in out and "phase p50:" in out
    assert "deadline 50ms: met" in out and trace.exists()


def test_cli_open_loop_on_cpu():
    out = _cli("--deadline-ms", "200", "--admission", "--load-qps", "100",
               "--load-duration-s", "0.3")
    assert "open loop: offered" in out and "met=" in out and "admission:" in out


def test_cli_default_device_is_the_card():
    args = cli.build_parser().parse_args([])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--n-docs", "20", "--requests", "4"])
