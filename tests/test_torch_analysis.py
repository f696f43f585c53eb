"""The port's analysis layer (``obs/cost.py``, ``launch/{dryrun,
hlo_analysis,roofline}.py``, ``steps.build_lm_layer_probe`` and the
serve executor's ``cost_summaries``) against the reference's.

* ``model_flops_per_device`` equals the reference's for every (arch,
  shape) of the registry on a 16x16 record;
* ``analyze`` of a port record equals the reference's ``analyze`` of the
  same record in the reference's meaning (its ``cost`` less (L - 1) x the
  layer probe, since XLA counts a scanned layer once), with the
  reference's peaks set to the port's for the cell's type;
* the layer probe's train (loss and gradients), prefill and decode
  outputs equal the reference's probe at (1, 1) on a reduced dense LM and
  a reduced MoE, the weights carried over: in float32 within rtol and
  atol 1e-5 (gradients, which reach ~600, 1e-4), decode in bf16 within
  1.6e-2; the TP probe at (1, 2) of two CPU entries equals the port's
  (1, 1) probe within the same tolerances;
* at (1, 1) the reckoned ``argument_bytes`` and ``output_bytes`` equal
  the reference's ``memory_analysis()`` for the search arch's qt1_p99 and
  one reduced cell of each model family (departures named in
  ``MEMORY_DEPARTURES``);
* the copy record's bytes equal a count by hand for a reduced TP prefill
  at (1, 2) and an FSDP train step at (2, 1), every shard on the CPU;
* a probe's matrix-product FLOPs equal the count from its config;
* under the pass every kernel entry point reports its own work (5b and
  row 6 at PERF.md's shapes equal its bounds), launches nothing and runs
  none of its plain version's ops;
* ``run_cell`` and the CLI write records with the reference's keys; an
  LM cell reckoned from one and two layers (and microbatches) equals
  its whole count, its temps included;
* the executor's ``cost_summaries`` are filled after one drain.
"""

import copy
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side: a card host without JAX skips the file

from repro.configs.lm_archs import LM_ARCHS as REF_LM_ARCHS
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh as jax_mesh
from repro.models import transformer as jtransformer
from repro_torch.configs.lm_archs import LM_ARCHS
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import carry_params, tree_leaves
from repro_torch.obs import cost
from repro_torch.parallel import Sharded

RTOL = ATOL = 1e-5
BF16_TOL = 1.6e-2  # two bf16 ulps
GRAD_TOL = 1e-4  # gradients of sum(y) reach ~600: float32 sums in XLA's order and torch's
CPU = "cpu"
REF_KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "memory", "cost", "collectives",
            "meta"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_per_device_gib"}


def _meta_mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["meta"] * int(np.prod(shape)))


def _f32(arch):
    return replace(arch, model_cfg=replace(arch.model_cfg, dtype="float32"))


def _pair(arch_id, f32=True):
    ref = next(a for a in REF_LM_ARCHS if a.arch_id == arch_id).reduced()
    port = next(a for a in LM_ARCHS if a.arch_id == arch_id).reduced()
    return (_f32(ref), _f32(port)) if f32 else (ref, port)


# -- the roofline --------------------------------------------------------------------
def test_model_flops_per_device_matches_reference():
    """Every cell of the registry, on a 16x16 record whose meta is the
    port's built step's."""
    mesh = _meta_mesh((16, 16))
    n = 0
    for aid, arch in ARCHS.items():
        for s, shape in arch.shapes.items():
            meta = dryrun._json_meta(tsteps.build_step(arch, s, mesh).meta)
            rec = {"arch": aid, "shape": s, "kind": shape.kind, "n_devices": 256,
                   "meta": meta}
            assert roofline.model_flops_per_device(rec, ARCHS) == pytest.approx(
                jroofline.model_flops_per_device(rec, REF_ARCHS), rel=1e-12)
            n += 1
    assert n == 39


@pytest.mark.parametrize("arch_id,shape", [("stablelm-1.6b", "train_4k"),
                                           ("granite-moe-1b-a400m", "decode_32k"),
                                           ("two-tower-retrieval", "train_batch")])
def test_analyze_matches_reference(monkeypatch, arch_id, shape):
    arch = get_arch(arch_id).reduced()
    rec = dryrun.run_cell(arch, shape, False, mesh=_meta_mesh((2, 2)))
    rec["arch"] = arch_id  # the registry's entry: model_flops_per_device reads its config
    want_rec = copy.deepcopy(rec)
    L = rec["meta"]["n_layers"]
    if "layer_probe" in rec:
        for k in ("flops", "bytes_accessed"):
            want_rec["cost"][k] -= (L - 1) * rec["layer_probe"][k]
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS[rec["compute_dtype"]])
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "LINK_BW", roofline.LINK_BW)
    got = roofline.analyze(rec, ARCHS)
    want = jroofline.analyze(want_rec, REF_ARCHS)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == (pytest.approx(v, rel=1e-9) if isinstance(v, float) else v), k
    assert roofline.to_markdown([got]).count("\n") == 3


# -- the layer probe ---------------------------------------------------------------------
def _probe_inputs(ref, kind, seed=0):
    """The reference probe's concrete inputs: x, the layer (float32), and
    for decode a bf16 cache and a position."""
    shape = ref.shapes[{"train": "train_4k", "prefill": "prefill_32k",
                        "decode": "decode_32k"}[kind]]
    cfg = ref.model_cfg
    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    rng = np.random.default_rng(seed)
    layer = jax.tree.map(np.asarray, jtransformer._layer_init(cfg, jax.random.key(seed)))
    layer = jax.tree.map(lambda a: (a + rng.normal(0, 0.02, a.shape)).astype(a.dtype), layer)
    x = rng.normal(0, 1, (B, 1 if kind == "decode" else S, cfg.d_model))
    x = np.asarray(jax.numpy.asarray(x, cfg.dtype))
    if kind != "decode":
        return shape, (x, layer)
    cache = {k: rng.normal(0, 1, (B, S, cfg.n_kv, cfg.head_dim)).astype(np.float32)
             for k in ("k", "v")}
    cache = {k: np.asarray(jax.numpy.asarray(v, jax.numpy.bfloat16)) for k, v in cache.items()}
    return shape, (x, layer, cache, 5)


def _to_port(args, kind):
    x, layer = carry_params(args[0], device=CPU), carry_params(args[1], device=CPU)
    if kind != "decode":
        return (x, layer)
    return (x, layer, carry_params(args[2], device=CPU), args[3])


def _whole(tree):
    """Sharded leaves as whole tensors; a [d][r] list of per-shard caches
    as one cache, its shards' kv heads side by side."""
    if isinstance(tree, Sharded):
        return tree.full()
    if isinstance(tree, list) and tree and isinstance(tree[0], list):
        (row,) = tree
        return {k: torch.cat([c[k] for c in row], dim=2) for k in row[0]}
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole(v) for v in tree)
    return tree


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = [t for t in tree_leaves(got)]
    want = jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("arch_id", ["stablelm-1.6b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_layer_probe_matches_reference(arch_id, kind):
    """At (1, 1), then the TP probe at (1, 2) of two CPU entries against
    the port's (1, 1) probe. Decode in bf16: the reference's probe writes
    a bf16 cache, which its float32 compute cannot update."""
    ref, port = _pair(arch_id, f32=kind != "decode")
    tol = BF16_TOL if kind == "decode" else RTOL
    shape, args = _probe_inputs(ref, kind)
    jbuilt = jsteps.build_lm_layer_probe(ref, shape, jax_mesh((1, 1), ("data", "model")))
    want = jbuilt.fn(*args)
    pshape = port.shapes[shape.name]
    outs = {}
    for mshape in ((1, 1), (1, 2)):
        mesh = make_mesh(mshape, ("data", "model"), devices=[CPU] * mshape[1])
        built = tsteps.build_lm_layer_probe(port, pshape, mesh)
        assert built.meta["n_layers"] == 1
        assert all(t.device.type == "meta" for t in tree_leaves(list(built.args[:2])))
        pargs = _to_port(args, kind)
        if mshape != (1, 1):
            pargs = (pargs[0], tsteps.place_params(built, pargs[1])) + tuple(pargs[2:])
            if kind == "decode":
                pargs = pargs[:2] + (tsteps.place_caches(built, pargs[2], stacked=False),
                                     pargs[3])
        outs[mshape] = built.fn(*pargs)
    got, tp = outs[(1, 1)], _whole(outs[(1, 2)])
    if kind == "train":
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=RTOL)
        _close(got[1], want[1], rtol=GRAD_TOL, atol=GRAD_TOL, what="gradients")
        np.testing.assert_allclose(float(tp[0]), float(got[0]), rtol=RTOL)
        for a, b in zip(tree_leaves(tp[1]), tree_leaves(got[1])):
            torch.testing.assert_close(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)
        return
    _close(got[0], want[0], rtol=tol, atol=tol, what="y")
    _close(got[1], want[1], rtol=tol, atol=tol, what="cache")
    torch.testing.assert_close(tp[0].float(), got[0].float(), rtol=tol, atol=tol)
    for name in ("k", "v"):
        torch.testing.assert_close(tp[1][name].float(), got[1][name].float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_probe_matmul_flops_follow_the_config(kind):
    """A dense layer's products: q/k/v/o projections, the scores and the
    weighted values over the whole (naive) attention, three MLP products."""
    arch = get_arch("stablelm-1.6b").reduced()
    cfg = arch.model_cfg
    shape = arch.shapes["prefill_32k" if kind == "prefill" else "decode_32k"]
    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    built = tsteps.build_lm_layer_probe(arch, shape, _meta_mesh((1, 1)))
    _, c = cost.count(built.fn, *tsteps.placed_args(built))
    D, H, Hkv, dh, F = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_ff
    T = B * (1 if kind == "decode" else S)
    want = 2 * T * D * (H + 2 * Hkv) * dh + 2 * T * H * dh * D + 3 * 2 * T * D * F
    want += 2 * 2 * T * H * S * dh  # scores and weighted values, every key row
    assert c.matmul_flops == want


# -- memory against XLA's memory_analysis -------------------------------------------------
# (arch, shape): the reduced cells (the search arch at full size, as
# test_system.py compiles it)
MEMORY_CELLS = [("proximity-search", "qt1_p99"), ("stablelm-1.6b-smoke", "prefill_32k"),
                ("egnn-smoke", "full_graph_sm"), ("two-tower-retrieval-smoke", "serve_p99")]
# XLA's output buffer of a tuple result also holds the tuple's table, an
# 8-byte pointer per leaf; the port's results are the leaves alone
MEMORY_DEPARTURES = {"output_bytes": "XLA adds 8 bytes per leaf of a tuple result"}


def _arch(ids, aid):
    base = aid.removesuffix("-smoke")
    return ids[base].reduced() if aid.endswith("-smoke") else ids[base]


@pytest.mark.parametrize("arch_id,shape", MEMORY_CELLS)
def test_memory_matches_reference(arch_id, shape):
    jbuilt = jsteps.build_step(_arch(REF_ARCHS, arch_id), shape,
                               jax_mesh((1, 1), ("data", "model")))
    ma = jbuilt.lower().compile().memory_analysis()
    rec = dryrun.run_cell(_arch(ARCHS, arch_id), shape, False, layer_probe=False,
                          mesh=_meta_mesh((1, 1)))
    mem = rec["memory"]
    assert set(mem) == MEMORY_KEYS
    assert mem["argument_bytes"] == ma.argument_size_in_bytes
    leaves = jax.tree.leaves(jax.eval_shape(jbuilt.fn, *jbuilt.args))
    table = 8 * len(leaves) if len(leaves) > 1 else 0
    assert mem["output_bytes"] == ma.output_size_in_bytes - table
    assert mem["temp_bytes"] >= 0


# -- copies between shards ---------------------------------------------------------------
def test_tp_prefill_copies_by_hand():
    """Reduced stablelm prefill at (1, 2) on two CPU entries: the vocab-
    sharded lookup's partials meet once; each layer broadcasts its normed
    input to both shards and adds their partials, for attention and for
    the MLP; the head broadcasts the last position."""
    arch = get_arch("stablelm-1.6b").reduced()
    cfg = arch.model_cfg
    B, S = (arch.shapes["prefill_32k"].dims[k] for k in ("global_batch", "seq_len"))
    mesh = make_mesh((1, 2), ("data", "model"), devices=[CPU, CPU])
    built = tsteps.build_step(arch, "prefill_32k", mesh)
    args = tsteps.materialize_inputs(arch, "prefill_32k", built, seed=0)
    _, c = cost.count(built.fn, *args)
    act = B * S * cfg.d_model * 2  # bf16
    L = cfg.n_layers
    assert c.copies == {"all-reduce": (1 + 2 * L) * act,
                        "broadcast": 2 * L * act + B * cfg.d_model * 2}
    assert c.n_copies == 1 + 4 * L + 1


def test_fsdp_train_copies_by_hand():
    """Reduced stablelm train at (2, 1) on two CPU entries: each weight is
    gathered (cast to bf16) onto both data shards, so each moves its bf16
    bytes once (two half blocks each to the other shard, or a whole leaf
    to the second shard); the backward sends as much back."""
    arch = get_arch("stablelm-1.6b").reduced()
    mesh = make_mesh((2, 1), ("data", "model"), devices=[CPU, CPU])
    built = tsteps.build_step(arch, "train_4k", mesh)
    assert built.meta["n_micro"] == 1 and not arch.model_cfg.remat
    args = tsteps.materialize_inputs(arch, "train_4k", built, seed=0)
    want = sum(t.numel() * 2 for t in tree_leaves(args[0]))
    _, c = cost.count(built.fn, *args)
    assert c.copies == {"all-gather": want, "reduce-scatter": want}


# -- the kernels under the pass ------------------------------------------------------------
def _plain_raises(monkeypatch):
    import repro_torch.kernels.embedding_bag.ops as bag
    import repro_torch.kernels.intersect.ops as inter
    import repro_torch.kernels.nearest_r.ops as nr
    import repro_torch.kernels.proximity.ops as prox
    import repro_torch.kernels.segment_sum.ops as seg

    def boom(*a, **k):
        raise AssertionError("a plain version ran under the cost pass")

    for mod, name in ((bag, "embedding_bag_plain"), (bag, "embedding_bag_backward_plain"),
                      (seg, "segment_sum_plain"), (nr, "window_join_plain"),
                      (inter, "intersect_plain"), (inter, "intersect_compressed_plain"),
                      (prox, "proximity_plain")):
        monkeypatch.setattr(mod, name, boom)


def test_kernels_report_their_work_and_run_nothing(monkeypatch):
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.intersect import (
        intersect_compressed_streams,
        intersect_sorted,
        intersect_sorted_compressed,
    )
    from repro_torch.kernels.nearest_r import window_join
    from repro_torch.kernels.proximity import proximity_join
    from repro_torch.kernels.segment_sum import gather_rows, segment_sum

    _plain_raises(monkeypatch)
    m = lambda *s, dt=torch.int32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731

    def bag_step(table):  # PERF.md row 5b's shape: two-tower train_batch
        ids = m(32768, 50)
        return torch.autograd.grad(embedding_bag(ids, table).sum(), table)

    table = m(10_000_000, 256, dt=torch.float32).requires_grad_()
    (g,), c = cost.count(bag_step, table)
    assert g.shape == (10_000_000, 256) and g.device.type == "meta"
    assert c.kernels["embedding_bag.embedding_bag_backward"]["bytes_accessed"] == 10_280_108_032
    assert c.kernels["embedding_bag.embedding_bag"]["launches"] == 1

    src = m(172_032)  # row 6's: minibatch_lg E 172,032 C 64
    out, c = cost.count(lambda x: segment_sum(x, src, 172_032), m(172_032, 64, dt=torch.float32))
    assert out.shape == (172_032, 64)
    assert c.kernels["segment_sum.segment_sum"]["bytes_accessed"] == 89_456_644
    x = m(1000, 8, dt=torch.float32).requires_grad_()
    _, c = cost.count(lambda x: torch.autograd.grad(gather_rows(x, m(5000)).sum(), x), x)
    assert c.kernels["segment_sum.segment_sum"]["launches"] == 1

    a, b = m(4096), m(8192)
    (mask, idx), c = cost.count(intersect_sorted, a, b)
    assert (mask.dtype, idx.shape) == (torch.bool, (4096,))
    assert c.kernels["intersect.intersect_sorted"]["bytes_accessed"] == 4 * 4096 + 4 * 8192 + 5 * 4096
    _, c = cost.count(proximity_join, a, b, 5)
    assert c.kernels["proximity.proximity_join"]["bytes_accessed"] == 4 * 4096 + 4 * 8192 + 9 * 4096
    mask, c = cost.count(intersect_sorted_compressed, a, b)
    assert mask.shape == (4096,) and c.kernels["intersect.intersect_compressed_streams"]
    streams = (m(64), m(4096, dt=torch.int16), m(128), m(8192, dt=torch.int16), m(8))
    _, c = cost.count(intersect_compressed_streams, *streams)
    want = 64 * 4 + 4096 * 2 + 128 * 4 + 8192 * 2 + 8 * 4 + 4096
    assert c.kernels["intersect.intersect_compressed_streams"]["bytes_accessed"] == want
    B, Kn, Ks, L = 4, 3, 2, 1024
    (valid, lo, hi), c = cost.count(window_join, m(B, L), m(B, Kn, L), m(B, Kn), m(B, Ks, L),
                                    m(B, Ks, L), m(B, Ks), max_sep=5, r_max=4)
    assert valid.shape == lo.shape == (B, L)
    assert c.kernels["nearest_r.window_join"]["bytes_accessed"] == (
        4 * (B * L + B * Kn * L + B * Kn + 2 * B * Ks * L + B * Ks) + 9 * B * L)
    for k in c.kernels.values():
        assert k["launches"] == 1


def test_views_move_no_bytes_and_copies_do():
    x = torch.empty(64, 32, device="meta")
    _, c = cost.count(lambda x: (x.view(32, 64), x.reshape(2048), x[1:5], x.t(), x.T[None]
                                 .expand(3, 32, 64), x.as_strided((8,), (1,))), x)
    assert c.bytes_accessed == 0 and c.flops == 0
    _, c = cost.count(lambda x: x.clone(), x)
    assert c.bytes_accessed == 2 * 64 * 32 * 4
    _, c = cost.count(lambda x: torch.empty_like(x).copy_(x), x)
    assert c.bytes_accessed == 2 * 64 * 32 * 4
    _, c = cost.count(lambda x: torch.exp(x) + 1, x)
    assert (c.transcendentals, c.flops) == (64 * 32, 64 * 32)


# -- the dry run ------------------------------------------------------------------------
def test_run_cell_and_cli_write_reference_keys(tmp_path, monkeypatch):
    arch = get_arch("granite-moe-1b-a400m").reduced()
    rec = dryrun.run_cell(arch, "train_4k", False, mesh=_meta_mesh((2, 2)))
    assert REF_KEYS | {"layer_probe"} <= set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["cost"]) == {"flops", "bytes_accessed", "transcendentals"}
    assert set(rec["collectives"]) == {"once_bytes", "in_loop_bytes", "n_ops"}
    assert rec["collectives"]["in_loop_bytes"] == {}
    assert set(rec["collectives"]["once_bytes"]) >= {"all-gather", "reduce-scatter"}
    assert rec["layer_probe"]["flops"] * rec["meta"]["n_layers"] <= rec["cost"]["flops"]
    assert 0 < rec["memory"]["argument_bytes"] and rec["memory"]["alias_bytes"] > 0
    json.dumps(rec)
    # the CLI on the search arch's reduced cells, restartable
    out = tmp_path / "dry.jsonl"
    monkeypatch.setattr(dryrun, "get_arch", lambda aid: _arch(ARCHS, aid))
    monkeypatch.setattr(dryrun, "_production_mesh", lambda multi_pod: _meta_mesh((2, 2)))
    for _ in range(2):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "proximity-search-smoke", "--out", str(out)])
        assert e.value.code == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 2 and all(REF_KEYS <= set(r) for r in recs)


@pytest.mark.parametrize("n_layers", [3, 5])
@pytest.mark.parametrize("kind,dims", [
    ("train", {"seq_len": 32, "global_batch": 6, "n_micro": 3}),
    ("prefill", {"seq_len": 96, "global_batch": 2}),
    ("decode", {"seq_len": 96, "global_batch": 4})])
def test_extrapolated_count_equals_the_whole_count(kind, dims, n_layers):
    """A reduced stablelm of three or five layers (train: three
    microbatches, remat) at (2, 2): the count reckoned from one and two
    layers (and microbatches) equals the whole count in every field, the
    temps' high-water mark too (reckoned from the counts' live-bytes
    profiles), and the cell's record carries those temps and a peak."""
    from repro_torch.configs.base import ShapeSpec

    arch = get_arch("stablelm-1.6b").reduced()
    arch = replace(arch, model_cfg=replace(arch.model_cfg, n_layers=n_layers,
                                           remat=kind == "train"),
                   shapes={"s": ShapeSpec("s", kind, dims)})
    mesh = _meta_mesh((2, 2))
    built = tsteps.build_step(arch, "s", mesh)
    got, how = dryrun.count_cell(arch, "s", mesh, built)
    assert how == {"layers": [1, 2], "micro": [1, 2] if kind == "train" else [1]}
    want, _ = dryrun._counted(built, mesh.grid())
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k
    temps = want[("memory", "temp_bytes")]
    assert got[("memory", "temp_bytes")] == temps > 0
    rec = dryrun.run_cell(arch, "s", False, layer_probe=False, mesh=mesh)
    assert rec["memory"]["temp_bytes"] == temps and rec["extrapolated"] == how
    assert rec["memory"]["peak_per_device_gib"] is not None


# -- the serve executor ----------------------------------------------------------------
def test_executor_cost_summaries_filled_after_a_drain():
    from repro_torch.core.index_builder import build_index
    from repro_torch.data.corpus import generate_corpus, sample_mixed_queries
    from repro_torch.serving import SearchService, ServeConfig

    table, lex = generate_corpus(n_docs=200, mean_doc_len=60, vocab_size=800, seed=3)
    lex.sw_count, lex.fu_count = 20, 40
    idx = build_index(table, lex, max_distance=5)
    svc = SearchService(idx, ServeConfig(buckets=(256, 1024), max_batch=16), device="cpu")
    queries = sample_mixed_queries(table, lex, 32, window=5, seed=1)
    for q in queries:
        svc.submit(q)
    svc.drain()
    ex = svc.compiled
    assert ex.cost_summaries and set(ex.cost_summaries) == set(ex.compile_times)
    for summary in ex.cost_summaries.values():
        assert set(summary) == {"flops", "bytes_accessed", "transcendentals"}
        assert summary["bytes_accessed"] > 0
    for q in queries:  # warm batches: the per-bucket stats carry each shape's count
        svc.submit(q)
    svc.drain()
    (fam, B, L), *_ = sorted(ex.measured_keys)
    assert set(ex.measured_cost(fam, L)[f"B{B}"]["cost"]) == {"flops", "bytes_accessed",
                                                            "transcendentals"}
