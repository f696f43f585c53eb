"""The port's step builders (``launch/steps.py``, serving half) against
the reference's.

For every reduced serving cell — LM prefill and decode (the bf16 and,
with ``REPRO_KV_INT8=1``, the int8 cache), recsys serve_p99, serve_bulk
and retrieval_cand — ``build_step`` gives meta-device abstract arguments
and ``materialize_inputs`` concrete ones whose batch equals the
reference's draw for draw; the step's outputs have the shapes
``test_arch_smoke`` asserts and are finite; and the port's step on the
reference's materialized inputs (its weights carried across) agrees
with the reference's step: LM logits by cosine >= 0.995 and argmax
agreement >= 0.9 (bf16 serving weights), recsys outputs within rtol and
atol 1e-5 with equal top-k ids. The reduced EGNN cells' built train
steps match the reference's over two steps (loss and grad_norm within
rtol 1e-5, float32 sums in other orders); the search arch's built QT1
step, under each ``REPRO_SEARCH_COMPRESSED`` mode at both smoke shapes,
gives the reference's top-k records exactly; the registry lists the
reference's arch ids. The LM and recsys train cells are held to the
reference in ``test_torch_train_steps.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side: a card host without JAX skips the file

from repro.configs.gnn_archs import EGNN_ARCH as REF_EGNN_ARCH
from repro.configs.lm_archs import LM_ARCHS as REF_LM_ARCHS
from repro.configs.proximity_search import SEARCH_ARCH as REF_SEARCH_ARCH
from repro.configs.recsys_archs import RECSYS_ARCHS as REF_RECSYS_ARCHS
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh as jax_mesh
from repro_torch.configs.gnn_archs import EGNN_ARCH
from repro_torch.configs.lm_archs import LM_ARCHS
from repro_torch.configs.proximity_search import SEARCH_ARCH
from repro_torch.configs.recsys_archs import RECSYS_ARCHS
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import carry_params

COS_BF16, ARGMAX_BF16 = 0.995, 0.9
RTOL = ATOL = 1e-5
CPU = "cpu"
ARCH_IDS = [a.arch_id for a in LM_ARCHS]
RECSYS_IDS = [a.arch_id for a in RECSYS_ARCHS]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _cosine(a, b) -> float:
    a, b = _np(a).ravel().astype(np.float64), _np(b).ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _agreement(a, b) -> float:
    return float((_np(a).argmax(-1) == _np(b).argmax(-1)).mean())


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _mesh11():
    return make_mesh((1, 1), ("data", "model"), devices=[CPU])


def _reference(ref, shape_name):
    """The reference's built step and materialized inputs, and the same
    inputs carried to the port (before the step donates any of them)."""
    jbuilt = jsteps.build_step(ref, shape_name, jax_mesh((1, 1), ("data", "model")))
    jargs = jsteps.materialize_inputs(ref, shape_name, jbuilt, seed=1)
    carried = tuple(carry_params(jax.tree.map(np.asarray, a), device=CPU) for a in jargs)
    return jbuilt, jargs, carried


# -- LM ---------------------------------------------------------------------------
CELLS = [(a, s, q) for a in ARCH_IDS for s, q in
         (("prefill_32k", False), ("decode_32k", False), ("decode_32k", True))]


@pytest.mark.parametrize("arch_id,shape_name,kv_int8", CELLS)
def test_built_lm_step(monkeypatch, arch_id, shape_name, kv_int8):
    """build_step + materialize_inputs for every reduced prefill/decode
    cell (REPRO_KV_INT8 on and off): test_arch_smoke's shapes, finite
    outputs, the reference's synthetic batch draw for draw, and the
    port's step on the reference's inputs equal to the reference's."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if kv_int8 else "0")
    ref = next(a for a in REF_LM_ARCHS if a.arch_id == arch_id).reduced()
    port = next(a for a in LM_ARCHS if a.arch_id == arch_id).reduced()
    built = tsteps.build_step(port, shape_name, _mesh11())
    assert all(t.device.type == "meta" for t in _leaves(built.args))
    args = tsteps.materialize_inputs(port, shape_name, built, seed=1)
    jbuilt, jargs, carried = _reference(ref, shape_name)
    for got, want in zip(_leaves(args[1:]), jax.tree.leaves(jargs[1:])):
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    logits, caches = built.fn(*args)
    shape, cfg = port.shapes[shape_name], port.model_cfg
    assert logits.shape == (shape.dims["global_batch"], cfg.vocab)
    assert caches["k"].shape[0] == cfg.n_layers
    assert torch.isfinite(logits.float()).all()

    want_l, want_c = jbuilt.fn(*jargs)
    got_l, got_c = built.fn(*carried)
    assert _cosine(got_l, want_l) >= COS_BF16
    assert _agreement(got_l, want_l) >= ARGMAX_BF16
    assert sorted(got_c) == sorted(want_c)


def test_lm_train_and_probe_wait_for_their_slices():
    port = LM_ARCHS[0].reduced()
    mesh = _mesh11()
    built = tsteps.build_step(port, "train_4k", mesh)  # training is ported
    assert built.meta["n_micro"] == 1 and len(built.args) == 3
    probe = tsteps.build_lm_layer_probe(port, port.shapes["prefill_32k"], mesh)
    assert probe.meta["n_layers"] == 1 and len(probe.args) == 2
    # a step over a mesh of several distinct devices builds (tensor parallelism)
    built = tsteps.build_step(port, "prefill_32k",
                              make_mesh((1, 2), ("data", "model"), devices=["cpu", "meta"]))
    assert built.meta["devices"] == ["cpu", "meta"]
    assert built.meta["device"] == torch.device("cpu")


# -- recsys -----------------------------------------------------------------------
RECSYS_CELLS = [(a, s) for a in RECSYS_IDS for s in ("serve_p99", "serve_bulk", "retrieval_cand")]


@pytest.mark.parametrize("arch_id,shape_name", RECSYS_CELLS)
def test_built_recsys_step(arch_id, shape_name):
    ref = next(a for a in REF_RECSYS_ARCHS if a.arch_id == arch_id).reduced()
    port = next(a for a in RECSYS_ARCHS if a.arch_id == arch_id).reduced()
    built = tsteps.build_step(port, shape_name, _mesh11())
    assert all(t.device.type == "meta" for t in _leaves(built.args))
    args = tsteps.materialize_inputs(port, shape_name, built, seed=1)
    jbuilt, jargs, carried = _reference(ref, shape_name)
    assert sorted(args[1]) == sorted(jargs[1])
    for name in jargs[1]:
        np.testing.assert_array_equal(_np(args[1][name]), np.asarray(jargs[1][name], np.float32))
    assert built.meta["model_params"] == jbuilt.meta["model_params"]
    out = built.fn(*args)
    want = jbuilt.fn(*jargs)
    got = built.fn(*carried)
    shape = port.shapes[shape_name]
    if isinstance(want, (tuple, list)):  # retrieval top-k: (scores (1, k), ids (1, k))
        assert out[0].shape == out[1].shape == (1, 100)
        assert torch.isfinite(out[0]).all()
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
        return
    B = shape.dims["batch"]
    n_cand = shape.dims.get("n_candidates")
    assert tuple(out.shape) == (tuple(want.shape) if n_cand else
                                ((B, 100) if "hist" in args[1] and "candidates" in args[1]
                                 else (B,)))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


# -- GNN (EGNN) train steps -------------------------------------------------------
GNN_RTOL = 1e-5  # float32 loss and grad_norm after two steps: sums in other orders
GNN_SHAPES = list(EGNN_ARCH.reduced().shapes)


@pytest.mark.parametrize("shape_name", GNN_SHAPES)
def test_built_gnn_step(shape_name):
    """build_step + materialize_inputs for every reduced EGNN shape: the
    reference's meta and batch draw for draw, and two steps on the
    reference's inputs (its weights and optimizer state carried across)
    within GNN_RTOL of the reference's built step on a (1, 1) mesh."""
    ref, port = REF_EGNN_ARCH.reduced(), EGNN_ARCH.reduced()
    built = tsteps.build_step(port, shape_name, _mesh11())
    assert all(t.device.type == "meta" for t in _leaves(built.args))
    _, opt, batch = tsteps.materialize_inputs(port, shape_name, built, seed=1)
    assert sorted(opt) == ["mu", "nu", "step"]
    jbuilt, jargs, carried = _reference(ref, shape_name)
    for name in jargs[2]:
        np.testing.assert_array_equal(_np(batch[name]), np.asarray(jargs[2][name], np.float32))
        assert batch[name].dtype == carried[2][name].dtype
    assert {k: built.meta[k] for k in jbuilt.meta} == jbuilt.meta
    jp, jo, jb = jargs
    p, o, b = carried
    for _ in range(2):
        jp, jo, jm = jbuilt.fn(jp, jo, jb)
        p, o, m = built.fn(p, o, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=GNN_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=GNN_RTOL)


def test_gnn_step_pads_edges_to_a_multiple_of_512():
    built = tsteps.build_step(EGNN_ARCH, "full_graph_sm", _mesh11())
    assert tuple(built.args[2]["src"].shape) == (10_752,)
    assert built.meta["n_edges"] == 10_556
    assert tuple(built.args[2]["feats"].shape) == (2_708, 1_433)


# -- search (the paper's engine) ----------------------------------------------------
SEARCH_SHAPES = list(REF_SEARCH_ARCH.reduced().shapes)


@pytest.mark.parametrize("mode", ["", "offsets", "delta"])
@pytest.mark.parametrize("shape_name", SEARCH_SHAPES)
def test_built_search_step(monkeypatch, shape_name, mode):
    """build_search_step under each REPRO_SEARCH_COMPRESSED mode at both
    smoke shapes: the reference's argument shapes and types and meta;
    materialize_inputs equal to the reference's raw draw, encoded for the
    mode as the reference's compress_qt1_batch encodes it; the top-k
    records equal to the reference's built step's on those inputs."""
    from repro.core.jax_search import QT1Batch, compress_qt1_batch

    ref, port = REF_SEARCH_ARCH.reduced(), SEARCH_ARCH.reduced()
    monkeypatch.setenv("REPRO_SEARCH_COMPRESSED", "")
    jraw = jsteps.materialize_inputs(ref, shape_name, jsteps.build_step(
        ref, shape_name, jax_mesh((1, 1), ("data", "model"))), seed=1)
    monkeypatch.setenv("REPRO_SEARCH_COMPRESSED", mode)
    jbuilt = jsteps.build_step(ref, shape_name, jax_mesh((1, 1), ("data", "model")))
    jargs = [np.asarray(a) for a in jraw]
    if mode:
        jargs = compress_qt1_batch(QT1Batch(*jargs, 1), delta_g=mode == "delta")
    built = tsteps.build_step(port, shape_name, _mesh11())
    assert built.meta["search_mode"] == jbuilt.meta["search_mode"] == (mode or "baseline")
    assert {k: built.meta[k] for k in jbuilt.meta} == jbuilt.meta
    args = tsteps.materialize_inputs(port, shape_name, built, seed=1)
    for a, abstract, jabs, want in zip(args, built.args, jbuilt.args, jargs):
        assert tuple(a.shape) == tuple(abstract.shape) == tuple(jabs.shape)
        assert a.dtype == abstract.dtype
        assert str(a.dtype).split(".")[-1] == str(jabs.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    got = built.fn(*args)
    want = jbuilt.fn(*jargs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_search_step_refuses_an_unknown_mode(monkeypatch):
    monkeypatch.setenv("REPRO_SEARCH_COMPRESSED", "zstd")
    with pytest.raises(ValueError, match="REPRO_SEARCH_COMPRESSED"):
        tsteps.build_step(SEARCH_ARCH.reduced(), "qt1_serve", _mesh11())


# -- the registry -------------------------------------------------------------------
def test_registry_lists_the_reference_archs():
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg

    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)
    assert [a.arch_id for a in treg.ALL_ARCHS] == [a.arch_id for a in jreg.ALL_ARCHS]
    assert treg.ASSIGNED_ARCH_IDS == jreg.ASSIGNED_ARCH_IDS
    for arch_id in jreg.ARCHS:
        port, ref = treg.get_arch(arch_id), jreg.get_arch(arch_id)
        assert (port.family, sorted(port.shapes), port.skips, port.source) == \
            (ref.family, sorted(ref.shapes), ref.skips, ref.source)
        assert {n: s.dims for n, s in port.shapes.items()} == {n: s.dims for n, s in ref.shapes.items()}
    with pytest.raises(KeyError) as got:
        treg.get_arch("nope")
    with pytest.raises(KeyError) as want:
        jreg.get_arch("nope")
    assert str(got.value) == str(want.value)
    built = tsteps.build_step(RECSYS_ARCHS[0].reduced(), "train_batch", _mesh11())
    assert sorted(built.args[1]) == ["mu", "nu", "step"]
