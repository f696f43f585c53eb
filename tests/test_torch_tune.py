"""The port's ``tune/`` package against the reference's ``repro.tune`` on
its deterministic parts: the grid, seeded workloads and arrival
schedules, successive halving on a rigged cost table, the objective, the
sensitivity table, the estimate rung and the config artifact. Artifacts
cross both ways: the reference's (which carries ``use_pallas``) loads in
the port with that one field dropped and reported, any other unknown
field is refused, and the port's loads in the reference. A tiny port
sweep on the CPU emits an artifact that ``python -m
repro_torch.launch.serve --device cpu --config`` serves."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.tune as ref_tune
from repro.core.index_builder import build_index as jax_build_index
from repro.data.corpus import generate_corpus as jax_generate_corpus
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.serving import SearchService as JaxService
from repro.serving import ServeConfig as JaxConfig

import repro_torch.tune as tune
from repro_torch.core.index_builder import build_index
from repro_torch.data.corpus import generate_corpus
from repro_torch.launch import serve as cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving import SearchService, ServeConfig

D = 5
BUCKETS = (64, 256, 1024)
KNOBS = dict(buckets=BUCKETS, max_batch=8, top_k=BUCKETS[0])
REPO = Path(__file__).resolve().parent.parent
AXES = {"r_max": [2, 4], "k": [{"k_ns": 2, "k_st": 2}, {"k_ns": 3, "k_st": 3}],
        "buckets": [(64, 256), (64, 256, 1024)]}
# the one default the port sets apart from the reference: its span ring
# holds a whole window of a busy card's spans
PORT_DEFAULTS = {"trace_capacity": ServeConfig().trace_capacity}


def _corpus(gen):
    table, lex = gen(n_docs=60, mean_doc_len=60, vocab_size=400, seed=7)
    lex.sw_count = 14
    lex.fu_count = 30
    return table, lex


@pytest.fixture(scope="module")
def corpora():
    return _corpus(jax_generate_corpus), _corpus(generate_corpus)


# -- workloads, grid, halving, objective, sensitivity -------------------------
@pytest.mark.parametrize("name", sorted(tune.WORKLOAD_GENERATORS))
def test_workloads_match_reference(corpora, name):
    (jt, jl), (pt, pl) = corpora
    kw = {"window": D} if name == "mixed" else {}
    want = ref_tune.make_workload(name, jt, jl, 24, seed=5, **kw)
    got = tune.make_workload(name, pt, pl, 24, seed=5, **kw)
    assert (got.name, got.queries, got.meta) == (want.name, want.queries, want.meta)
    want = ref_tune.attach_arrivals(want, "bursty", qps=80.0, duration_s=0.5, seed=3,
                                    burst_factor=3.0)
    got = tune.attach_arrivals(got, "bursty", qps=80.0, duration_s=0.5, seed=3,
                               burst_factor=3.0)
    assert got.arrivals == want.arrivals and got.meta == want.meta


def test_recorded_workload_crosses_packages(corpora, tmp_path):
    (jt, jl), _ = corpora
    wl = ref_tune.attach_arrivals(ref_tune.make_workload("zipfian", jt, jl, 12, seed=2),
                                  "poisson", qps=50.0, duration_s=0.2, seed=3)
    ref_tune.record_workload(wl, str(tmp_path / "ref.json"))
    back = tune.load_workload(str(tmp_path / "ref.json"))
    assert (back.queries, back.arrivals, back.meta) == (wl.queries, wl.arrivals, wl.meta)
    tune.record_workload(back, str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()


def _cands(pkg):
    return pkg.grid((3, 5), AXES)


def test_grid_matches_reference():
    got, want = _cands(tune), _cands(ref_tune)
    assert [(c.max_distance, c.overrides, c.axis_values, c.config_id) for c in got] == \
        [(c.max_distance, c.overrides, c.axis_values, c.config_id) for c in want]
    assert got[5].serve_config().to_json_dict().items() <= \
        {**want[5].serve_config().to_json_dict(), **PORT_DEFAULTS}.items()


def _rigged(c, r):
    # the candidate "d=5|buckets=64-256|k=k_ns3+k_st3|r_max=2" is the best
    # at every rung; every other cost permutes per rung
    if c.config_id == "d=5|buckets=64-256|k=k_ns3+k_st3|r_max=2":
        return 0.0
    return float(sum(map(ord, c.config_id)) * (r + 3) % 97) + 1.0


def test_successive_halving_matches_reference():
    hist = {}
    for name, pkg in (("port", tune), ("ref", ref_tune)):
        rungs = [lambda c, r=r: _rigged(c, r) for r in range(3)]
        h = pkg.successive_halving(_cands(pkg), rungs, keep=(8, 4))
        hist[name] = [[(c.config_id, s) for c, s in rung] for rung in h]
    assert hist["port"] == hist["ref"]
    assert [len(r) for r in hist["port"]] == [16, 8, 4]
    assert hist["port"][-1][0] == ("d=5|buckets=64-256|k=k_ns3+k_st3|r_max=2", 0.0)


MEASUREMENTS = [
    {"p50_us": 1000.0, "p95_us": 2000.0, "met_rate_offered": 1.0, "index_bytes": 2 << 20},
    {"p50_us": 800.0, "p95_us": 5000.0, "met_rate_offered": 0.93, "index_bytes": 9 << 20},
    {"p50_us": 1500.0, "met_rate": 0.995, "index_bytes": 1 << 20},
]


@pytest.mark.parametrize("objective", [{}, {"deadline_s": 0.02, "w_p95": 0.5,
                                            "target_met_rate": 0.95}])
def test_objective_matches_reference(objective):
    got, want = tune.Objective(**objective), ref_tune.Objective(**objective)
    for i, m in enumerate(MEASUREMENTS):
        assert got.score(m, config_id=f"c{i}") == want.score(m, config_id=f"c{i}")
        assert got.estimate_score(123.4, m["index_bytes"]) == \
            want.estimate_score(123.4, m["index_bytes"])


def test_sensitivity_table_matches_reference():
    tables = [pkg.sensitivity_table([(c, _rigged(c, 0)) for c in _cands(pkg)])
              for pkg in (tune, ref_tune)]
    assert tables[0] == tables[1]
    assert set(tables[0]) == {"max_distance", *AXES}


# -- the config artifact --------------------------------------------------------
def _artifact(pkg, cfg_cls, path):
    cfg = cfg_cls(max_batch=16, top_k=8, r_max=2, buckets=(64, 256), admit_margin=0.7)
    return cfg, pkg.emit_serve_config(str(path), 3, cfg, meta={"workload": "mixed"})


def test_emitted_artifact_matches_reference_but_use_pallas(tmp_path):
    _, got = _artifact(tune, ServeConfig, tmp_path / "port.json")
    _, want = _artifact(ref_tune, JaxConfig, tmp_path / "ref.json")
    assert want["serve_config"].pop("use_pallas") is False
    want["serve_config"].update(PORT_DEFAULTS)
    assert got == want


def test_reference_artifact_loads_with_use_pallas_dropped(tmp_path):
    path = tmp_path / "ref.json"
    _artifact(ref_tune, JaxConfig, path)
    d, cfg, meta = tune.load_serve_config(str(path))
    assert d == 3 and meta["workload"] == "mixed"
    assert meta["dropped_fields"] == {"use_pallas": False}
    assert cfg == ServeConfig(max_batch=16, top_k=8, r_max=2, buckets=(64, 256),
                              admit_margin=0.7, trace_capacity=JaxConfig().trace_capacity)
    # and the port's own artifact loads in the reference, dropping nothing
    _artifact(tune, ServeConfig, tmp_path / "port.json")
    d, jcfg, jmeta = ref_tune.load_serve_config(str(tmp_path / "port.json"))
    assert jcfg == JaxConfig(max_batch=16, top_k=8, r_max=2, buckets=(64, 256),
                             admit_margin=0.7, **PORT_DEFAULTS)
    assert "dropped_fields" not in tune.load_serve_config(str(tmp_path / "port.json"))[2]


@pytest.mark.parametrize("field", ["use_triton", "no_such_knob"])
def test_other_unknown_fields_are_refused(tmp_path, field):
    path = tmp_path / "ref.json"
    _, payload = _artifact(ref_tune, JaxConfig, path)
    payload["serve_config"][field] = True
    path.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match=field):
        tune.load_serve_config(str(path))


def test_foreign_json_is_refused(tmp_path):
    path = tmp_path / "other.json"
    path.write_text(json.dumps({"format": "not-a-config"}))
    with pytest.raises(ValueError, match="not a tuned serve config"):
        tune.load_serve_config(str(path))


def test_cli_resolves_config_with_overlays(tmp_path):
    path = tmp_path / "tuned.json"
    cfg, _ = _artifact(tune, ServeConfig, path)
    d, got = cli.resolve_config(cli.build_parser().parse_args(["--config", str(path)]))
    assert (d, got) == (3, cfg)
    args = cli.build_parser().parse_args(
        ["--config", str(path), "--admission", "--deadline-ms", "25"])
    _, got = cli.resolve_config(args)
    assert got.admission and got.default_deadline_s == pytest.approx(0.025)
    assert got.max_queue == 4 * cfg.max_batch
    assert dataclasses.replace(got, admission=False, max_queue=None,
                               default_deadline_s=None) == cfg


# -- the estimate rung and a tiny sweep ------------------------------------------
@pytest.fixture(scope="module")
def indexes(corpora):
    (jt, jl), (pt, pl) = corpora
    return jax_build_index(jt, jl, max_distance=D), build_index(pt, pl, max_distance=D)


@pytest.mark.parametrize("unit", [1.0, 10.0])
def test_estimate_matches_reference(corpora, indexes, unit):
    (jt, jl), (pt, pl) = corpora
    jidx, pidx = indexes
    want_wl = ref_tune.make_workload("mixed", jt, jl, 16, window=D, seed=13)
    got_wl = tune.make_workload("mixed", pt, pl, 16, window=D, seed=13)
    want = ref_tune.estimate_workload_us(
        JaxService(jidx, jax_make_mesh((1, 1), ("data", "model")),
                   JaxConfig(**KNOBS, unit_us_per_kslot=unit)), want_wl.queries)
    got = tune.estimate_workload_us(
        SearchService(pidx, ServeConfig(**KNOBS, unit_us_per_kslot=unit), device="cpu"),
        got_wl.queries)
    assert got == want > 0.0
    # over a two-shard CPU mesh the same workload still prices
    sharded = SearchService(pidx, ServeConfig(**KNOBS, doc_shards=2, unit_us_per_kslot=unit),
                            mesh=make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2))
    assert tune.estimate_workload_us(sharded, got_wl.queries) > 0.0


def test_tiny_sweep_artifact_serves_through_the_cli(corpora, indexes, tmp_path):
    _, (pt, pl) = corpora
    _, pidx = indexes
    wl = tune.make_workload("mixed", pt, pl, 8, window=D, seed=17)
    cands = tune.grid((D,), {"max_batch": [4, 8]})
    out = tune.sweep({D: pidx}, None, cands, wl, base=ServeConfig(**KNOBS),
                     objective=tune.Objective(deadline_s=0.5), device="cpu")
    assert out.winner in cands and out.n_candidates == 2 and len(out.history) == 2
    assert out.measurements[out.winner.config_id]["p50_us"] > 0.0
    path = tmp_path / "tuned.json"
    tune.emit_serve_config(str(path), out.winner.max_distance,
                           out.winner.serve_config(ServeConfig(**KNOBS)),
                           meta={"workload": wl.name})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--n-docs", "120", "--requests", "16", "--config", str(path)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "loaded tuned config" in run.stderr and "served 16 requests" in run.stdout
