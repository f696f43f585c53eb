"""The port's tracer and instruments (DESIGN.md §15) on its own service:
span ids and parents against time containment, one request id from
``submit`` to the batch span that served it, the host-to-device copy's
``h2d`` spans and bytes, the row cache's ``derive`` spans and miss bytes,
``serve:`` ranges on a recording ``torch.profiler`` and on no other, the
ring's dropped spans in ``stats_snapshot()``, and on a card the step's
device time by CUDA events against its host time."""

import json

import pytest
import torch

from repro_torch.core.index_builder import build_index
from repro_torch.core.torch_search import LocalStep
from repro_torch.data.corpus import generate_corpus, sample_mixed_queries, sample_typed_queries
from repro_torch.obs import chrome_trace
from repro_torch.serving import SearchService, ServeConfig, executors

D = 5
KNOBS = dict(buckets=(256, 1024, 4096), max_batch=16, top_k=16)
CONFIGS = {
    "raw": {},
    "compressed": dict(compressed=True),
    "compressed-no-cache": dict(compressed=True, use_compressed_cache=False),
}
FAMILIES = ("qt1", "qt2", "qt34", "qt5")


@pytest.fixture(scope="module")
def world():
    table, lex = generate_corpus(n_docs=300, mean_doc_len=70, vocab_size=1200, seed=3)
    lex.sw_count = 20
    lex.fu_count = 40
    index = build_index(table, lex, max_distance=D)
    return table, lex, index, sample_mixed_queries(table, lex, 96, window=D, seed=4)


def _serve(index, queries, device="cpu", rounds=2, **knobs):
    """A service drained ``rounds`` times over ``queries``; returns it, the
    responses of every drain and the host bytes each ``place`` was given."""
    svc = SearchService(index, ServeConfig(**KNOBS, **knobs), device=device)
    placed = []
    plain = LocalStep.place

    def place(self, args):
        placed.append(sum(a.nbytes for a in args))
        return plain(self, args)

    LocalStep.place = place
    try:
        drains = []
        for _ in range(rounds):
            for q in queries:
                svc.submit(q)
            drains.append(svc.drain())
    finally:
        LocalStep.place = plain
    return svc, drains, placed


@pytest.fixture(scope="module", params=list(CONFIGS))
def served(request, world):
    *_, index, queries = world
    return (request.param, *_serve(index, queries, **CONFIGS[request.param]))


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_span_ids_and_parents_match_time_containment(served):
    _, svc, _, _ = served
    spans = svc.tracer.snapshot()
    assert svc.tracer.dropped == 0
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans) and 0 not in by_id
    for s in spans:
        if s.parent == 0:
            assert s.depth == 0
            continue
        p = by_id[s.parent]
        assert p.tid == s.tid and p.depth == s.depth - 1
        assert p.ts <= s.ts and s.end <= p.end + 1e-9
        assert p.id < s.id  # a parent opens before its children
    events = json.loads(json.dumps(chrome_trace(spans)))["traceEvents"]
    got = {e["args"]["id"]: e["args"]["parent"] for e in events if e["ph"] == "X"}
    assert got == {s.id: s.parent for s in spans}


def test_request_ids_listed_by_the_batch_span_that_served_them(served):
    _, svc, drains, _ = served
    responses = [r for rs in drains for r in rs]
    assert [r.request_id for r in responses] == list(range(1, len(responses) + 1))
    batches = {s.id: s for s in _by_name(svc.tracer.snapshot(), "batch")}
    listed = [i for s in batches.values() for i in s.args["requests"]]
    assert len(listed) == len(set(listed))
    served_ids = set()
    for r in responses:
        if r.path == "empty":
            assert r.batch_span == 0
            continue
        assert r.request_id in batches[r.batch_span].args["requests"]
        served_ids.add(r.request_id)
    assert set(listed) == served_ids and served_ids
    for s in batches.values():  # one batch span's requests share its shape
        fam = s.args["family"]
        assert all(responses[i - 1].path == ("cpu" if fam == "scalar" else fam)
                   or fam == "qt5" for i in s.args["requests"])


def test_h2d_spans_inside_pack_with_the_copied_bytes(served):
    name, svc, _, placed = served
    spans = svc.tracer.snapshot()
    by_id = {s.id: s for s in spans}
    h2d = _by_name(spans, "h2d")
    assert len(h2d) == len(placed) == svc.compiled.stats["batches"] > 0
    assert [s.args["bytes"] for s in h2d] == placed
    parents = {by_id[s.parent].name for s in h2d}
    assert parents == ({"pack", "compress"} if name == "compressed-no-cache" else {"pack"})
    m = svc.metrics_snapshot("serve.h2d.")
    assert m["serve.h2d.bytes"] == sum(placed)
    assert sum(m[f"serve.h2d.{f}"]["count"] for f in FAMILIES if f"serve.h2d.{f}" in m) \
        == len(placed)


def test_derive_spans_count_the_row_cache_misses(served):
    name, svc, _, _ = served
    spans = svc.tracer.snapshot()
    by_id = {s.id: s for s in spans}
    derive = _by_name(spans, "derive")
    raw = svc.pack_cache.stats
    comp = svc.compressed_cache.stats if svc.compressed_cache is not None else None
    assert raw["evictions"] == 0 and raw["misses"] > 0
    misses = raw["misses"] + (comp["misses"] if comp else 0)
    assert len(derive) == misses
    base = [s for s in derive if not s.args["kind"].endswith("_c")]
    assert len(base) == raw["misses"]
    assert {s.args["kind"] for s in base} <= {"fst", "wv", "ord", "nsw"}
    for s in derive:  # a compressed row's miss derives its raw rows inside it
        assert by_id[s.parent].name in ("pack", "derive")
    m = svc.metrics_snapshot("cache.")
    # every present row a miss derived is resident: no eviction, one snapshot
    assert m["cache.pack.miss_bytes"] == raw["bytes"] > 0
    assert m["cache.pack.derive_us"]["count"] == raw["misses"]
    if comp:
        assert m["cache.compressed.miss_bytes"] == comp["bytes"]


def test_unread_instruments_are_gone_and_step_families_unchanged(served):
    _, svc, _, _ = served
    names = set(svc.metrics_snapshot())
    assert not names & {"serve.request.e2e", "serve.drain.total"}
    assert not {n for n in names if n.startswith("cache.")
                and n.rsplit(".", 1)[1] in ("hits", "misses", "bytes")}
    # the serve.step.* / serve.batch.* families hold the same instruments
    # as before: one per (family, B, L), plus the scalar route's
    for prefix in ("serve.step.", "serve.batch."):
        for n in svc.metrics_snapshot(prefix):
            fam, *shape = n[len(prefix):].split(".")
            assert (fam == "scalar" and not shape and prefix == "serve.step.") or (
                fam in FAMILIES and shape[0][0] == "B" and shape[1][0] == "L"), n
    assert not svc.metrics_snapshot("serve.step_device.")  # no card, no events


def _profiled_names(index, queries, tmp_path, **knobs):
    from torch.profiler import ProfilerActivity, profile

    svc = SearchService(index, ServeConfig(**KNOBS, **knobs), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for q in queries:
            svc.submit(q)
        svc.drain()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("name", "").startswith("serve:")}


def test_serve_ranges_on_a_recording_profiler(world, tmp_path):
    *_, index, queries = world
    names = _profiled_names(index, queries, tmp_path)
    for label in ("serve:drain", "serve:plan", "serve:group", "serve:pack", "serve:h2d",
                  "serve:decode", "serve:derive:fst", "serve:dispatch:base"):
        assert label in names, label
    assert "serve:batch:qt1:B16:L256" in names or any(
        n.startswith("serve:batch:qt1:B") for n in names)
    assert not _profiled_names(index, queries, tmp_path, trace_enabled=False)


def test_no_profiler_range_while_none_records(world, monkeypatch):
    *_, index, queries = world
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    svc, _, _ = _serve(index, queries[:24], rounds=1)
    assert svc.tracer.snapshot() and not opened


def test_dropped_spans_in_stats_snapshot(world):
    *_, index, queries = world
    svc, _, _ = _serve(index, queries, rounds=1, trace_capacity=16)
    snap = svc.stats_snapshot()["tracer"]
    assert snap == {"capacity": 16, "dropped": svc.tracer.dropped}
    assert snap["dropped"] > 0 and len(svc.tracer.snapshot()) == 16
    assert SearchService(index, ServeConfig(**KNOBS), device="cpu") \
        .stats_snapshot()["tracer"] == {"capacity": 1 << 17, "dropped": 0}


def test_one_warm_step_in_step_event_every_is_timed(world, monkeypatch):
    """The step events time one warm batch in ``step_event_every`` while
    the tracer is on and none while it is off: the card's path, run here
    with stand-in events on a stand-in card."""
    *_, index, queries = world
    recorded = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def elapsed_time(self, end):
            return 0.25

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(executors, "_record_events",
                        lambda devices, events: recorded.append(len(events)))
    monkeypatch.setattr(executors.CompiledExecutor, "step_event_every", 3)
    for enabled in (True, False):
        recorded.clear()
        svc = SearchService(index, ServeConfig(**KNOBS, trace_enabled=enabled), device="cpu")
        svc.compiled._cards = ["card"]
        for _ in range(3):
            for q in queries:
                svc.submit(q)
            svc.drain()
        warm = sum(h["count"] for n, h in svc.metrics_snapshot("serve.step.").items()
                   if not n.endswith(".scalar"))
        timed = svc.metrics_snapshot("serve.step_device.")
        if not enabled:
            assert warm > 0 and not recorded and not timed
            continue
        n_timed = sum(h["count"] for h in timed.values())
        assert warm > 3 and n_timed == (warm + 2) // 3
        assert recorded == [1] * (2 * n_timed)  # a start and an end a timed step
        assert all(h["min"] == h["max"] == 250.0 for h in timed.values())


# -- on a card -------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_step_device_time_within_its_host_time(cuda, world, monkeypatch):
    """Each warm QT1 step's CUDA-event time (every step timed here) is
    positive and, summed over a shape's batches, not above the host's
    dispatch-to-synchronise time."""
    monkeypatch.setattr(executors.CompiledExecutor, "step_event_every", 1)
    table, lex, index, _ = world
    queries = sample_typed_queries(table, lex, 64, "qt1", window=D, seed=6)
    svc, _, _ = _serve(index, queries, device=cuda, rounds=3)
    device = svc.metrics_snapshot("serve.step_device.")
    assert device
    for name, h in device.items():
        host = svc.metrics_snapshot("serve.step.")[name.replace("step_device", "step")]
        assert h["count"] == host["count"] > 0
        assert h["min"] > 0 and h["sum"] <= host["sum"]


# -- the replay probe's arithmetic -----------------------------------------------
def _probe():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "serve_probe.py"
    spec = importlib.util.spec_from_file_location("serve_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_probe_reads_the_instruments_per_batch(served):
    """``tools/serve_probe.py`` divides each instrument's sum over the
    stretch by the compiled batches, reads None where a tree has no such
    instrument, and nothing over an empty stretch."""
    _, svc, _, placed = served
    probe = _probe()
    after = probe.sums(svc)
    m = svc.metrics_snapshot()
    nb = sum(h["count"] for n, h in m.items()
             if n.startswith("serve.batch.") and not n.endswith(".scalar"))
    r = probe.readings(after, {}, spans=10, dropped=0, wall=2.0)
    assert r["batches"] == nb > 0
    assert r["h2d_mb_per_batch"] == pytest.approx(sum(placed) / 1e6 / nb)
    assert r["miss_mb_per_batch"] == pytest.approx(m["cache.pack.miss_bytes"] / 1e6 / nb)
    assert r["derive_ms_per_batch"] == pytest.approx(
        m["cache.pack.derive_us"]["sum"] / 1e3 / nb)
    assert r["plan_us_per_query"] == pytest.approx(
        m["serve.phase.plan"]["sum"] / m["serve.phase.plan"]["count"])
    assert r["step_device_ms_per_batch"] is None and r["spans_per_s"] == 5
    bare = {k: v for k, v in after.items()
            if not k.startswith(("serve.h2d.", "cache.pack.miss_bytes"))}
    r = probe.readings(bare, {}, spans=0, dropped=0, wall=1.0)
    assert r["h2d_ms_per_batch"] is r["h2d_mb_per_batch"] is r["miss_mb_per_batch"] is None
    r = probe.readings(after, after, spans=0, dropped=0, wall=1.0)
    assert r["batches"] == 0 and r["host_ms_per_batch"] is None
    assert r["h2d_mb_per_batch"] is r["miss_mb_per_batch"] is r["derive_ms_per_batch"] is None
