"""A CPU rehearsal of ``cardbench/run.py``'s cell machinery on a tiny corpus
with the port's CPU paths: the result line has the contract's keys and no
device metric; the stream and the tail read as they say; every cell and
metric of the real ``BENCHMARK.json``
resolves to its files by name; a new configuration, traffic mix and
metric are found by name as new files; and the check of ``correct``
fails under the control and under each fault a serving cell can have."""

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from harness import cell, judge
from reference.search import Reference

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SEED = 2**32 + 12345  # past 32 signed bits, as a run's seeds may be
CONTRACT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout-like folder: the real metrics and traffic, plus a tiny
    configuration, a new traffic mix and a new metric, all as files."""
    r = tmp_path_factory.mktemp("checkout")
    bench = r / "cardbench"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    shutil.copytree(BENCH / "traffic", bench / "traffic")
    (bench / "configs").mkdir()
    config = json.loads((BENCH / "configs" / "prox-d5.json").read_text())
    config.update(name="tiny", n_docs=300, mean_doc_len=70, vocab_size=1500, sw_count=20,
                  fu_count=40)
    config["serve"] = dict(config["serve"], buckets=[64, 256, 1024], max_batch=16)
    (bench / "configs" / "tiny.json").write_text(json.dumps(config))
    (bench / "traffic" / "qt25-c16.json").write_text(json.dumps({
        "generator": "mixed", "weights": {"qt2": 3, "qt5": 1}, "window": 5, "min_len": 3,
        "max_len": 4, "stream": 512, "loop": "closed", "clients": 16, "deadline_s": 0.05}))
    (bench / "metrics" / "drains_per_s.py").write_text(
        "def read(run):\n    return run.window.drains / run.window.window_s\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "tiny", "file": "cardbench/configs/tiny.json",
                        "reduced": [], "why": "tiny"}]
    spec["workloads"] = [
        {"name": "tiny-mixed", "config": "tiny", "traffic": "mixed-c128", "chips": 1, "why": "t"},
        {"name": "tiny-flood", "config": "tiny", "traffic": "stopflood-c128", "chips": 1, "why": "t"},
        {"name": "tiny-qt25", "config": "tiny", "traffic": "qt25-c16", "chips": 1, "why": "t"},
    ]
    for m in spec["per_layer"]:
        m.pop("workloads", None)
    spec["per_layer"].append({"name": "drains_per_s", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "service", "moves": "qps"})
    (r / "BENCHMARK.json").write_text(json.dumps(spec))
    return r


def _run(root, workload, trace=False, fault=None, seed=SEED):
    return cell.run(root, workload, seed, 1.0, trace, t_start=time.time(), platform="cpu",
                    fault=fault)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", ["tiny-mixed", "tiny-flood"])
def test_result_line_has_the_contract_keys(root, workload, trace):
    result = _run(root, workload, trace)
    assert all(k in result for k in CONTRACT_KEYS)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    assert "busy_s" not in result["device"] and "breakdown" not in result
    spec = json.loads((root / "BENCHMARK.json").read_text())
    sources = {m["name"]: m["source"] for m in spec["end_to_end"] + spec["per_layer"]}
    assert result["metrics"]
    assert all(sources[name] != "device_trace" for name in result["metrics"])
    wanted = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]}
    assert set(result["metrics"]) <= wanted
    json.loads(json.dumps(result))  # plain JSON


def test_new_config_traffic_and_metric_are_found_by_name(root):
    result = _run(root, "tiny-qt25", trace=True)
    assert result["correct"] is True
    assert result["metrics"]["drains_per_s"]["value"] > 0


def test_every_name_in_the_benchmark_resolves_to_its_files():
    bench = cell.Bench(ROOT)
    spec = bench.spec
    assert spec["paths"] == ["cardbench"]
    for w in spec["workloads"]:
        config = bench.config(w["config"])
        for key in ("max_distance", "sw_count", "fu_count", "n_docs", "mean_doc_len",
                    "vocab_size", "alpha", "serve"):
            assert key in config, (w["name"], key)
        mix = bench.traffic(w["traffic"])
        assert mix["clients"] > 0
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(m["name"])), m["name"]
        for w in m.get("workloads", []):
            bench.cell(w)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("cardbench/")


def test_seeds_past_32_bits_give_the_same_inputs(root):
    """The seed, past 32 bits, makes the corpus, the stream of queries and
    the judge's sample: the same seed the same inputs, another seed others."""
    bench = cell.Bench(root)
    config, mix = bench.config("tiny"), bench.traffic("mixed-c128")
    c1, s1 = cell.inputs(config, mix, SEED)
    c2, s2 = cell.inputs(config, mix, SEED)
    c3, s3 = cell.inputs(config, mix, SEED + 1)
    assert np.array_equal(c1.lemma_ids, c2.lemma_ids) and s1.queries == s2.queries
    assert not np.array_equal(c1.lemma_ids, c3.lemma_ids) and s1.queries != s3.queries
    assert len(s1.queries) == mix["stream"]
    assert cell.seeds(SEED) == cell.seeds(SEED) != cell.seeds(SEED + 1)


def test_the_stream_sends_no_query_twice_and_draws_on(root):
    """A window that reaches the end of the stream's first block gets the
    next block drawn from the same seed, not the first block again."""
    bench = cell.Bench(root)
    corpus, stream = cell.inputs(bench.config("tiny"), dict(bench.traffic("mixed-c128"),
                                                           stream=64), SEED)
    first = list(stream.queries)
    sent = [stream.next() for _ in range(200)]
    assert sent[:64] == first and stream.blocks == 4
    assert sent[64:128] != first and sent[128:192] != sent[64:128]


def test_the_window_goes_on_after_the_queries_served_in_setup(root):
    """``served_in_setup`` queries go to the service in set-up, a turn of
    ``clients`` at a time, each turn drained; the window's first query is
    the one after them, so none is sent twice."""
    from harness.window import serve_prefix

    class Service:
        def __init__(self):
            self.sent, self.turns, self.pending = [], [], 0

        def submit(self, q, deadline_s):
            self.sent.append(q)
            self.pending += 1

        def drain(self):
            self.turns.append(self.pending)
            self.pending = 0

    bench = cell.Bench(root)
    corpus, stream = cell.inputs(bench.config("tiny"), dict(bench.traffic("mixed-c128"),
                                                           stream=64), SEED)
    first = list(stream.queries)
    service = Service()
    assert serve_prefix(service, stream, 16, 0.05, 40) == 40
    assert service.sent == first[:40] and service.turns == [16, 16, 8]
    assert stream.next() == first[40]
    assert serve_prefix(service, stream, 16, 0.05, 0) == 0 and service.turns == [16, 16, 8]


def test_p95_leaves_out_the_traced_slice():
    """The hostpaced tail is read over the requests sent before the traced
    slice, which run under the profiler."""
    from harness.window import Window

    lat = np.r_[np.full(100, 0.010), np.full(20, 1.0)]
    win = Window(latencies_s=lat, attempted=120, completed=120, failed=0, unanswered=0,
                 window_s=1.0, drains=10, deadline_met=0, by_route={}, traced_from=100)
    run = cell.RunRecord(cell={}, config={}, traffic={}, platform="cuda", setup_s=1.0,
                         window=win, counters={})
    read = cell.Bench(ROOT).reader("p95_ms.hostpaced")
    assert read(run) == pytest.approx(10.0)
    win.traced_from = None
    assert read(run) == pytest.approx(1000.0)


# -- the check of correct: its control and the planted faults ----------------------
def _alter_answers(monkeypatch):
    """A record altered where it is produced: decode shifts the first start."""
    from repro_torch.serving import executors

    plain = executors.decode_results

    def decode(*args):
        out = plain(*args)
        for r in out:
            if r["start"].size:
                r["start"] = r["start"].copy()
                r["start"][0] += 1
        return out

    def fault(service):
        monkeypatch.setattr(executors, "decode_results", decode)
    return fault


def _drop_half(monkeypatch):
    """Half of every batch left out: its answers come back empty."""
    from repro_torch.serving.executors import empty_results

    def fault(service):
        for ex in (service.compiled, service.scalar):
            plain = ex.execute

            def execute(*args, _plain=plain, **kw):
                out = _plain(*args, **kw)
                for i in range(1, len(out), 2):
                    out[i].results = empty_results()
                return out
            monkeypatch.setattr(ex, "execute", execute)
    return fault


def _lose_requests(monkeypatch):
    """An answer that never comes: every tenth request is lost at submit."""
    from repro_torch.serving.service import SearchTicket

    def fault(service):
        plain, seen = service.submit, [0]

        def submit(q, **kw):
            seen[0] += 1
            return SearchTicket(list(q)) if seen[0] % 10 == 0 else plain(q, **kw)
        monkeypatch.setattr(service, "submit", submit)
    return fault


@pytest.mark.parametrize("make_fault, number", [
    (_alter_answers, "mismatched_answers"),
    (_drop_half, "mismatched_answers"),
    (_lose_requests, "unanswered_requests"),
], ids=["answer-altered", "half-the-batch-left-out", "answer-never-comes"])
def test_planted_faults_come_out_not_correct(root, monkeypatch, make_fault, number):
    result = _run(root, "tiny-mixed", fault=make_fault(monkeypatch))
    assert result["correct"] is False
    assert result["checks"][number]["value"] > 0


def test_the_control_comes_out_not_correct(root):
    """The reference with bfloat16 scores in the program's place fails the
    same judge on a run's sample of the mix."""
    bench = cell.Bench(root)
    corpus, stream = cell.inputs(bench.config("tiny"), bench.traffic("mixed-c128"), SEED)
    pool = stream.queries
    ref = Reference(corpus.doc_ids, corpus.positions, corpus.lemma_ids, corpus.doc_lengths,
                    corpus.doc_freqs, max_distance=5, sw_count=20, fu_count=40)
    rng = np.random.default_rng(cell.seeds(SEED)[2])
    picks = rng.choice(len(pool), size=128, replace=False)
    sound = {"qt1": [(pool[i], ref.answer(pool[i], "qt1", 16)) for i in picks]}
    control = {"qt1": [(pool[i], ref.answer(pool[i], "qt1", 16, precision="bfloat16"))
                       for i in picks]}
    assert judge.passed(judge.judge(ref, sound, 16))
    verdict = judge.judge(ref, control, 16)
    assert not judge.passed(verdict)
    assert verdict["numbers"]["mismatched_answers"] > 32


@pytest.mark.cuda
def test_a_tiny_traced_cell_on_the_card(root):
    """On a card: the traced run reads the device's busy time from the
    profiler's timeline and reports the device metrics it can read."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = cell.run(root, "tiny-mixed", SEED, 2.0, True, t_start=time.time(), platform="cuda")
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert "device_idle_share" in result["metrics"]
    assert list(result)[-2:] == ["breakdown", "checks"]
