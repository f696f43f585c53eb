"""Doc-sharded serving: the port's sharded serve steps and services on CPU
device meshes against the reference package's ``shard_map`` steps and
services on forced host devices.

The reference needs several JAX devices, which a process fixes when it
first imports JAX, so the module fixture runs this file as a script in a
subprocess with eight forced host devices; the script writes the
reference's outputs to an ``.npz``. The port runs in the test process on
meshes of ``"cpu"`` devices. Exact equality throughout, scores bitwise:

* every step family and payload (qt1 raw, delta and offsets; qt2 raw;
  qt34 and qt5 raw, delta and offsets) at meshes (1, 2), (1, 4), (2, 4);
* the services' records, routes and row-cache counters at (1, 2) and
  (1, 4), raw and compressed, on a static index and on a
  ``SegmentedIndex`` across a refresh that adds documents (the range
  partition's bounds move) and one that deletes them;
* the guards: a batch the data axis does not divide, a shard row shorter
  than top_k, a ``doc_shards`` that is not the mesh's model size.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import torch_search as port
from repro_torch.core.index_builder import build_index
from repro_torch.core.search import ProximitySearchEngine
from repro_torch.data.corpus import generate_corpus, sample_mixed_queries, sample_typed_queries
from repro_torch.index import SegmentedIndex
from repro_torch.launch import mesh as port_mesh
from repro_torch.serving import SearchService, ServeConfig

D = 5
L = 512  # step batches: a multiple of 64 * 4, so delta16 splits over 4 shards
B = 16
TOP_K = 16
MESHES = ((1, 2), (1, 4), (2, 4))
STEPS = {  # family: (query kinds, packer, packer kwargs, payloads)
    "qt1": (("qt1",), "pack_qt1_batch", {"K": 2}, ("raw", "delta", "offsets")),
    "qt2": (("qt2",), "pack_qt2_batch", {"K": 3}, ("raw",)),
    "qt34": (("qt3", "qt4"), "pack_qt34_batch", {"Kn": 4}, ("raw", "delta", "offsets")),
    "qt5": (("qt5",), "pack_qt5_batch", {"Kn": 3, "Ks": 3}, ("raw", "delta", "offsets")),
}
KNOBS = dict(buckets=(256, 1024, 4096), max_batch=16, top_k=16,
             payload_cost_driven=False)
SHARDS = (2, 4)
COMPRESSED = {"raw": False, "compressed": True}
CHECKPOINTS = ("seed", "add", "delete")
STATS = ("requests", "refreshes", "paths", "batches", "compressed_batches",
         "offset_fallbacks", "pack_cache", "compressed_cache")
COLS = ("doc", "start", "end", "score")
REF_TIMEOUT_S = 600


# -- one scenario, run by either package ----------------------------------------
def corpus(gen):
    """The 80-document corpus of the reference's multi-device check."""
    table, lex = gen(n_docs=80, mean_doc_len=70, vocab_size=500, seed=11)
    lex.sw_count = 14
    lex.fu_count = 30
    return table, lex


def step_queries(sampler, table, lex, family):
    kinds = STEPS[family][0]
    qs = [q for k in kinds
          for q in sampler(table, lex, B // len(kinds) - 1, k, window=D, seed=3)]
    return qs + [[]] * (B - len(qs))  # padding slots


def step_args(ts, index, queries, family, payload, S):
    """A family's step arguments at L, packed for S shards."""
    _, packer, kw, _ = STEPS[family]
    batch = getattr(ts, packer)(index, queries, L=L, doc_shards=S, **kw)
    if payload == "raw":
        return batch
    compress = getattr(ts, f"compress_{family}_batch")
    return compress(batch, delta_g=(payload == "delta"))


def deleted_docs(table):
    """The documents the last refresh deletes: every ninth, the longest
    one kept so the doc stride holds."""
    longest = int(np.argmax(table.doc_lengths))
    return [d for d in range(3, 80, 9) if d != longest]


def serve_scenario(make_service, seg_cls, table, lex, index, queries):
    """Every service configuration, drained cold and warm on the static
    index, then once per checkpoint of a segmented source. Returns
    ``{(source, S, payload, drain): (responses, stats)}``."""
    out = {}
    for S in SHARDS:
        for name, comp in COMPRESSED.items():
            cfg = dict(KNOBS, doc_shards=S, compressed=comp)
            svc = make_service(index, cfg, S)
            for drain in ("cold", "warm"):
                for q in queries:
                    svc.submit(q)
                out["static", S, name, drain] = (svc.drain(), svc.stats_snapshot())
    docs = table.to_doc_lists()
    seg = seg_cls(lex, max_distance=D, memtable_docs=16)
    services = {(S, name): make_service(seg, dict(KNOBS, doc_shards=S, compressed=comp), S)
                for S in SHARDS for name, comp in COMPRESSED.items()}
    for ckpt in CHECKPOINTS:
        if ckpt == "seed":
            for d in docs[:56]:
                seg.add_document(d)
        elif ckpt == "add":
            for d in docs[56:]:
                seg.add_document(d)
        else:
            for g in deleted_docs(table):
                seg.delete_document(g)
        seg.refresh()
        for (S, name), svc in services.items():
            svc.refresh()
            for q in queries:
                svc.submit(q)
            out["segmented", S, name, ckpt] = (svc.drain(), svc.stats_snapshot())
    return out


def _key(*parts) -> str:
    return "/".join(str(p) for p in parts)


def _drain_record(responses) -> dict:
    meta = [[r.path, r.bucket] + ([None] * 3 if r.plan is None else
                                  [r.plan.route, r.plan.fallback_reason, r.plan.payload])
            for r in responses]
    rec = {c: np.concatenate([r.results[c] for r in responses]) for c in COLS}
    rec["n"] = np.array([r.results["doc"].size for r in responses])
    rec["meta"] = np.array(json.dumps(meta))
    return rec


def _stats_record(stats) -> np.ndarray:
    sub = {k: stats[k] for k in STATS}
    sub["routes"] = stats["plans"]["routes"]
    sub["fallbacks"] = stats["plans"]["fallbacks"]
    return np.array(json.dumps(sub, sort_keys=True))


# -- the reference side (run as a script with eight host devices) ---------------
def reference_main(path: str) -> None:
    import jax

    from repro.core import jax_search as ref
    from repro.core.index_builder import build_index as jax_build_index
    from repro.data.corpus import generate_corpus as jax_corpus
    from repro.data.corpus import sample_mixed_queries as jax_mixed
    from repro.data.corpus import sample_typed_queries as jax_typed
    from repro.index import SegmentedIndex as JaxSegmentedIndex
    from repro.serving import SearchService as JaxService
    from repro.serving import ServeConfig as JaxConfig

    assert len(jax.devices()) == 8, jax.devices()
    table, lex = corpus(jax_corpus)
    index = jax_build_index(table, lex, max_distance=D)
    out = {}

    def mesh(shape):
        return jax.make_mesh(shape, ("data", "model"))

    def step(family, payload, m):
        if family == "qt1":
            if payload == "raw":
                return ref.make_qt1_serve_step(m, top_k=TOP_K)
            return ref.make_qt1_serve_step_compressed(m, top_k=TOP_K,
                                                      delta_g=(payload == "delta"))
        return ref.make_wv_serve_step(m, family, top_k=TOP_K, payload=payload,
                                      max_distance=D, r_max=4)

    for family, (_, _, _, payloads) in STEPS.items():
        queries = step_queries(jax_typed, table, lex, family)
        for shape in MESHES:
            for payload in payloads:
                args = step_args(ref, index, queries, family, payload, shape[1])
                if payload == "raw":
                    args = args.device_args()
                for i, x in enumerate(step(family, payload, mesh(shape))(*args)):
                    out[_key("step", family, payload, *shape, i)] = np.asarray(x)

    def refused(fn) -> bool:
        try:
            jax.block_until_ready(fn())
        except ValueError:
            return True
        return False

    qs = step_queries(jax_typed, table, lex, "qt1")
    odd = ref.pack_qt1_batch(index, qs[:B - 1], L=L, doc_shards=4)
    out["refused/indivisible_batch"] = np.array(refused(
        lambda: ref.make_qt1_serve_step(mesh((2, 4)), top_k=TOP_K)(*odd.device_args())))
    short = ref.pack_qt1_batch(index, qs, L=64, doc_shards=4)  # 16 lanes a shard
    out["refused/short_shard_row"] = np.array(refused(
        lambda: ref.make_qt1_serve_step(mesh((1, 4)), top_k=32)(*short.device_args())))

    queries = jax_mixed(table, lex, 48, window=D, seed=9)
    out["queries"] = np.array(json.dumps(queries))
    drains = serve_scenario(
        lambda src, cfg, S: JaxService(src, mesh((1, S)), JaxConfig(**cfg)),
        JaxSegmentedIndex, table, lex, index, queries)
    for k, (responses, stats) in drains.items():
        for name, arr in _drain_record(responses).items():
            out[_key("svc", *k, name)] = arr
        out[_key("svc", *k, "stats")] = _stats_record(stats)
    np.savez(path, **out)


# -- the port side ---------------------------------------------------------------
def cpu_mesh(shape):
    return port_mesh.make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


def port_step(family, payload, mesh, top_k=TOP_K):
    if family == "qt1":
        if payload == "raw":
            return port.make_qt1_serve_step(top_k=top_k, mesh=mesh)
        return port.make_qt1_serve_step_compressed(top_k=top_k, delta_g=(payload == "delta"),
                                                   mesh=mesh)
    return port.make_wv_serve_step(family, top_k=top_k, payload=payload, max_distance=D,
                                   r_max=4, mesh=mesh)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(Path(__file__).parent.parent / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def world():
    table, lex = corpus(generate_corpus)
    return table, lex, build_index(table, lex, max_distance=D)


@pytest.fixture(scope="module")
def served(world, reference):
    table, lex, index = world
    queries = json.loads(str(reference["queries"]))
    drains = serve_scenario(
        lambda src, cfg, S: SearchService(src, ServeConfig(**cfg), mesh=cpu_mesh((1, S))),
        SegmentedIndex, table, lex, index, queries)
    return queries, drains


# -- the steps -----------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("family,payload", [(f, p) for f, v in STEPS.items() for p in v[3]])
def test_sharded_step_matches_reference(world, reference, family, payload, shape):
    table, lex, index = world
    queries = step_queries(sample_typed_queries, table, lex, family)
    args = step_args(port, index, queries, family, payload, shape[1])
    if payload == "raw":
        args = args.host_args()
    step = port_step(family, payload, cpu_mesh(shape))
    assert isinstance(step, port.ShardedStep)
    got = step(*args)
    for i, name in enumerate(("s", "g", "lo", "hi")):
        want = reference[_key("step", family, payload, *shape, i)]
        g = got[i].numpy()
        assert g.dtype == want.dtype and g.shape == want.shape == (B, TOP_K), name
        np.testing.assert_array_equal(g.view(np.int32), want.view(np.int32),
                                      err_msg=f"{family} {payload} {shape} {name}")
    assert (got[0].numpy() > -1e29).any(), "no hits to compare"


@pytest.mark.parametrize("family", list(STEPS))
def test_one_device_mesh_is_the_single_shard_step(world, family):
    table, lex, index = world
    queries = step_queries(sample_typed_queries, table, lex, family)
    batch = step_args(port, index, queries, family, "raw", 1)
    step = port_step(family, "raw", cpu_mesh((1, 1)))
    assert not isinstance(step, port.ShardedStep)
    want = port_step(family, "raw", None)(*batch.device_args("cpu"))
    for g, w in zip(step(*batch.device_args("cpu")), want):
        assert torch.equal(g, w)


def test_range_partitioned_rows_serve_exactly(world):
    """The sharded step over range-partitioned rows on the reference's
    (2, 4) mesh returns every match the scalar engine finds (the
    reference's multi-device check, on the port)."""
    table, lex, index = world
    from repro_torch.data.corpus import sample_stop_queries

    queries = sample_stop_queries(table, lex, 16, window=5, seed=4)
    batch = port.pack_qt1_batch(index, queries, L=2048, K=2, doc_shards=4)
    # each shard's segment holds its own doc range, sorted, and pads after it
    n_docs, Ls = index.doc_lengths.size, 2048 // 4
    for s in range(4):
        seg = batch.key_g[:, :, s * Ls:(s + 1) * Ls].astype(np.int64)
        live = seg != port.SENTINEL
        docs = seg // batch.stride
        assert ((docs >= s * n_docs // 4) & (docs < (s + 1) * n_docs // 4))[live].all()
        assert (np.diff(np.where(live, seg, np.iinfo(np.int64).max), axis=-1) >= 0).all()
    decoded = port.decode_results(batch, *port.make_qt1_serve_step(
        top_k=512, mesh=cpu_mesh((2, 4)))(*batch.host_args()))
    eng = ProximitySearchEngine(index, top_k=100_000, equalize_mode="bulk")
    hits = 0
    for qi, q in enumerate(queries):
        res, _ = eng.search_ids(q)
        want = set(zip(res.doc.tolist(), res.start.tolist(), res.end.tolist()))
        got = set(zip(*(decoded[qi][c].tolist() for c in ("doc", "start", "end"))))
        assert got == want, qi
        hits += len(got)
    assert hits > 0


def test_indivisible_batch_raises_like_reference(world, reference):
    table, lex, index = world
    qs = step_queries(sample_typed_queries, table, lex, "qt1")
    batch = port.pack_qt1_batch(index, qs[:B - 1], L=L, doc_shards=4)
    assert bool(reference["refused/indivisible_batch"])
    with pytest.raises(ValueError, match="data shards"):
        port.make_qt1_serve_step(top_k=TOP_K, mesh=cpu_mesh((2, 4)))(*batch.host_args())


def test_shard_row_shorter_than_top_k_raises_like_reference(world, reference):
    table, lex, index = world
    qs = step_queries(sample_typed_queries, table, lex, "qt1")
    batch = port.pack_qt1_batch(index, qs, L=64, doc_shards=4)
    assert bool(reference["refused/short_shard_row"])
    with pytest.raises(ValueError, match="top_k"):
        port.make_qt1_serve_step(top_k=32, mesh=cpu_mesh((1, 4)))(*batch.host_args())


def test_unsplittable_row_raises(world):
    table, lex, index = world
    qs = step_queries(sample_typed_queries, table, lex, "qt1")
    batch = port.pack_qt1_batch(index, qs, L=90, doc_shards=2)
    with pytest.raises(ValueError, match="model shards"):
        port.make_qt1_serve_step(top_k=TOP_K, mesh=cpu_mesh((1, 4)))(*batch.host_args())


def test_sharded_outputs_land_on_the_lead_device(world):
    table, lex, index = world
    qs = step_queries(sample_typed_queries, table, lex, "qt34")
    batch = port.pack_qt34_batch(index, qs, L=L, doc_shards=4)
    step = port_step("qt34", "raw", cpu_mesh((2, 4)))
    placed = step.place(batch.host_args())
    assert len(placed) == 2 and all(len(row) == 4 for row in placed)
    a_g = placed[1][3][0]  # data row 1, model shard 3: the anchor rows
    np.testing.assert_array_equal(a_g.numpy(), batch.a_g[B // 2:, 3 * L // 4:])
    ns_r = placed[0][2][2]  # per-key scalars are replicated over model
    np.testing.assert_array_equal(ns_r.numpy(), batch.ns_r[:B // 2])
    assert all(t.device == step.lead for t in step.run(placed))


# -- the straddling delta block --------------------------------------------------
def test_straddling_block_base_is_the_live_minimum(world, ref_ts):
    """At L = 192 over two shards the second 64-block straddles the
    segment boundary at 96: it starts with shard 0's pads and ends with
    shard 1's live postings. Its base is the minimum over the live
    postings, as in the reference, so every delta is non-negative."""
    table, lex, index = world
    key = max(index.fst.keys(), key=index.fst.n_postings)
    g, _, _, present = port.pack_fst_key_rows(index, key, 192, doc_shards=2)
    assert present
    blk = g[64:128].astype(np.int64)
    pad = blk == port.SENTINEL
    assert pad[:32].any() and (~pad[32:]).any(), "block does not straddle"
    base, delta, ok = port._delta16_blocks(g.astype(np.int64))
    want = ref_ts._delta16_blocks(g.astype(np.int64))
    assert ok and want[2]
    np.testing.assert_array_equal(base, want[0])
    np.testing.assert_array_equal(delta, want[1])
    assert base[1] == blk[~pad].min()
    np.testing.assert_array_equal(base[1] + delta[64:128][~pad].astype(np.int64), blk[~pad])


@pytest.fixture(scope="module")
def ref_ts():
    from repro.core import jax_search

    return jax_search


def test_straddling_bucket_served_right(world):
    """A 192 bucket over two shards is block-aligned but not
    shard-aligned: the compressed service serves it as offsets and
    returns the sharded raw service's records."""
    table, lex, index = world
    queries = sample_mixed_queries(table, lex, 48, window=D, seed=9)
    knobs = dict(KNOBS, buckets=(192, 4096), doc_shards=2)
    mesh = cpu_mesh((1, 2))
    out = {}
    for comp in (False, True):
        svc = SearchService(index, ServeConfig(**knobs, compressed=comp), mesh=mesh)
        for q in queries:
            svc.submit(q)
        out[comp] = svc.drain()
    served = [r for r in out[True] if r.bucket == 192]
    assert served and {r.plan.payload for r in served} == {"offsets"}
    for g, w in zip(out[True], out[False]):
        for c in COLS:
            np.testing.assert_array_equal(g.results[c], w.results[c])


# -- the services ----------------------------------------------------------------
SERVICE_CASES = ([("static", S, n, d) for S in SHARDS for n in COMPRESSED for d in ("cold", "warm")]
                 + [("segmented", S, n, c) for S in SHARDS for n in COMPRESSED
                    for c in CHECKPOINTS])


def _ids(case):
    return "-".join(str(p) for p in case)


@pytest.mark.parametrize("case", SERVICE_CASES, ids=_ids)
def test_service_records_match_reference(served, reference, case):
    _, drains = served
    responses, _ = drains[case]
    got = _drain_record(responses)
    assert json.loads(str(got["meta"])) == json.loads(str(reference[_key("svc", *case, "meta")]))
    np.testing.assert_array_equal(got["n"], reference[_key("svc", *case, "n")])
    for c in COLS:
        want = reference[_key("svc", *case, c)]
        assert got[c].dtype == want.dtype, c
        np.testing.assert_array_equal(got[c].view(np.int32) if c == "score" else got[c],
                                      want.view(np.int32) if c == "score" else want,
                                      err_msg=c)
    assert got["n"].sum() > 0


@pytest.mark.parametrize("case", SERVICE_CASES, ids=_ids)
def test_service_stats_match_reference(served, reference, case):
    _, drains = served
    _, stats = drains[case]
    got = json.loads(str(_stats_record(stats)))
    want = json.loads(str(reference[_key("svc", *case, "stats")]))
    assert got == want
    assert got["fallbacks"].get("sharded_qt2_window", 0) > 0


def test_add_refresh_drops_sharded_rows(served):
    """A refresh that adds documents moves the range partition's bounds:
    the row cache keeps no doc_shards > 1 row across it."""
    _, drains = served
    for S in SHARDS:
        before = drains["segmented", S, "raw", "seed"][1]["pack_cache"]
        after = drains["segmented", S, "raw", "add"][1]["pack_cache"]
        assert after["retained"] == before["retained"]
        assert after["invalidations"] > before["invalidations"]


@pytest.mark.parametrize("case", [c for c in SERVICE_CASES if c[3] in ("warm", "delete")],
                         ids=_ids)
def test_sharded_records_equal_unsharded_as_sets(world, served, case):
    """Sharded and unsharded services return the same matches with the
    same float32 scores; only the order among equal scores may differ.
    QT2, which a sharded service sends to the scalar engine (the
    reference's ``sharded_qt2_window`` route), comes back with that
    engine's float64 scores: the same matches, the scores equal to
    float32 rounding."""
    table, lex, index = world
    queries, drains = served
    source, S, name, _ = case
    if source == "static":
        src = index
    else:
        src = SegmentedIndex(lex, max_distance=D, memtable_docs=16)
        for d in table.to_doc_lists():
            src.add_document(d)
        for g in deleted_docs(table):
            src.delete_document(g)
        src.refresh()
    svc = SearchService(src, ServeConfig(**dict(KNOBS, compressed=COMPRESSED[name])),
                        device="cpu")
    for q in queries:
        svc.submit(q)
    hits = rerouted = 0
    for g, w in zip(drains[case][0], svc.drain()):
        if g.path == w.path:
            assert _as_set(g) == _as_set(w)
        else:
            assert (g.path, w.path) == ("cpu", "qt2")
            assert g.plan.fallback_reason == "sharded_qt2_window"
            want = sorted(zip(*(w.results[c].tolist() for c in COLS)))
            got = sorted(zip(*(g.results[c].tolist() for c in COLS)))
            assert [r[:3] for r in got] == [r[:3] for r in want]
            np.testing.assert_allclose([r[3] for r in got], [r[3] for r in want], rtol=1e-6)
            rerouted += 1
        hits += int(g.results["doc"].size)
    assert hits > 0 and rerouted > 0


def _as_set(r):
    return set(zip(r.results["doc"].tolist(), r.results["start"].tolist(),
                   r.results["end"].tolist(), r.results["score"].view(np.int32).tolist()))


# -- meshes and the service's guards ---------------------------------------------
def test_make_mesh_takes_cards_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cards"):
        port_mesh.make_mesh((1, 2), ("data", "model"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="4 cards and 2"):
        port_mesh.make_mesh((1, 4), ("data", "model"))
    m = port_mesh.make_mesh((1, 2), ("data", "model"))
    assert [str(d) for d in m.devices.flat] == ["cuda:0", "cuda:1"]


def test_mesh_helpers_match_reference_semantics():
    m = cpu_mesh((2, 4))
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert port_mesh.tp_size(m) == 4 and port_mesh.dp_size(m) == 2
    assert port_mesh.dp_axes_of(m) == ("data",)
    pod = port_mesh.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=["cpu"] * 8)
    assert port_mesh.dp_axes_of(pod) == ("pod", "data") and port_mesh.dp_size(pod) == 4
    assert pod.grid().shape == (4, 2)
    with pytest.raises(ValueError, match="takes 8 devices"):
        port_mesh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 4)
    with pytest.raises(RuntimeError, match="256 cards"):
        port_mesh.make_production_mesh()
    assert port_mesh.make_production_mesh(
        multi_pod=True, devices=["cpu"] * 512).shape == {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("doc_shards,shape", [(1, (1, 2)), (4, (1, 2)), (2, (1, 1))])
def test_doc_shards_must_equal_model_size(world, doc_shards, shape):
    _, _, index = world
    with pytest.raises(ValueError, match="model-axis size"):
        SearchService(index, ServeConfig(**KNOBS, doc_shards=doc_shards), mesh=cpu_mesh(shape))


def test_device_and_mesh_are_exclusive(world):
    _, _, index = world
    with pytest.raises(ValueError, match="not both"):
        SearchService(index, ServeConfig(**KNOBS), device="cpu", mesh=cpu_mesh((1, 1)))
    svc = SearchService(index, ServeConfig(**KNOBS, doc_shards=2), mesh=cpu_mesh((1, 2)))
    assert svc.device == torch.device("cpu") and port_mesh.tp_size(svc.mesh) == 2


# -- on a card ---------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("family,payload", [(f, p) for f, v in STEPS.items() for p in v[3]])
def test_sharded_step_cuda_equals_cpu(world, cuda, family, payload, shape):
    """Every shard on the one card: the step's scores equal the CPU
    mesh's bit for bit, and so do (g, lo, hi) on every valid lane (on an
    invalid lane the kernel's lo/hi are unspecified, as
    ``window_join`` documents); qt34/qt5 launch the window join per
    shard."""
    from repro_torch.kernels.nearest_r import window_join

    table, lex, index = world
    args = step_args(port, index, step_queries(sample_typed_queries, table, lex, family),
                     family, payload, shape[1])
    if payload == "raw":
        args = args.host_args()
    n = int(np.prod(shape))
    card = port_mesh.make_mesh(shape, ("data", "model"), devices=[cuda] * n)
    before = window_join.launches
    got = port_step(family, payload, card)(*args)
    launched = window_join.launches - before
    want = port_step(family, payload, cpu_mesh(shape))(*args)
    assert all(g.device == cuda for g in got)
    assert torch.equal(got[0].cpu().view(torch.int32), want[0].view(torch.int32))
    valid = want[0] > -1e29
    assert valid.any()
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu()[valid], w[valid])
    assert launched == (n if family in ("qt34", "qt5") else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("compressed", [False, True])
def test_sharded_service_cuda_equals_cpu(world, cuda, compressed):
    table, lex, index = world
    queries = sample_mixed_queries(table, lex, 48, window=D, seed=9)
    out = {}
    for name, devices in (("card", [cuda] * 4), ("cpu", ["cpu"] * 4)):
        mesh = port_mesh.make_mesh((1, 4), ("data", "model"), devices=devices)
        svc = SearchService(index, ServeConfig(**KNOBS, doc_shards=4, compressed=compressed),
                            mesh=mesh)
        out[name] = []
        for _ in range(2):
            for q in queries:
                svc.submit(q)
            out[name].append(svc.drain())
    for got, want in zip(out["card"], out["cpu"]):
        for g, w in zip(got, want):
            assert g.path == w.path
            for c in COLS:
                np.testing.assert_array_equal(g.results[c], w.results[c])


if __name__ == "__main__":
    reference_main(sys.argv[1])
