"""The port's training package (``repro_torch.train``) and the embedding
bag's gradient against the reference package.

* AdamW: several steps with clipping active, on the same numpy
  parameters and gradients, through ``repro.train.optimizer`` and the
  port. Float32 within rtol 1e-6, atol 1e-7: the elementwise update is
  the reference's op for op, but the global norm's float32 sum of squares
  adds in another order (a few ulps), which the clip scale carries into
  every element.
* Checkpoints: round trip, a partial write, GC, the async checkpointer
  against in-place updates after ``save``, and checkpoints crossing
  between the packages both ways with equal manifests (exact).
* The supervisor and the straggler detector: the reference's
  ``tests/test_fault_tolerance.py`` on the port.
* Compression: the int8 error bound and the top-k error-feedback
  invariant; ``quantize_int8`` and ``topk_sparsify`` equal to the
  reference's.
* The compressed-DP step: ``tests/multidevice/check_compressed_dp.py``'s
  problem (linear regression, 4 data shards, 40 steps, exact / int8 /
  top-k with ``topk_frac`` 0.5). The reference needs four JAX devices,
  which a process fixes when it first imports JAX, so a module fixture
  runs this file as a script with four forced host devices. The port
  runs on a (4,) mesh of CPU devices. Losses within rtol 1e-5 (float32;
  the shards' means add in other orders), each shard's final top-k error
  state within atol 1e-5, and the reference script's own thresholds.
* The bag's backward: ``embedding_bag_backward_plain`` and the autograd
  path against ``jax.grad`` of the reference's ``embedding_bag_sum``
  (pads, ids past the table, repeats, weights, ``mean`` as the kernel's
  wrapper divides): the table's gradient within rtol 1e-6, atol 1e-6
  (float32 sums in other orders); the weights' gradient, a dot over D in
  another order, within rtol and atol 1e-5, on ids inside the table (the
  reference's fill mode gives NaN rows past it). ``-m cuda``
  holds the kernel to the plain version on the host to the bit: both add
  each row's terms in (b, s) order.
* Replay: the reduced two-tower train step, run twice from one state on
  the CPU, gives equal losses, grad norms and parameters, to the bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import (
    embedding_bag,
    embedding_bag_backward,
    embedding_bag_backward_plain,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import embedding as temb
from repro_torch.train import (
    AdamWConfig,
    AsyncCheckpointer,
    FailureInjector,
    InjectedFailure,
    StragglerDetector,
    TrainSupervisor,
    adamw_update,
    dequantize_int8,
    gc_checkpoints,
    init_error_state,
    init_opt_state,
    latest_step,
    make_compressed_dp_train_step,
    quantize_int8,
    restore_checkpoint,
    save_checkpoint,
    topk_sparsify,
)

SCHEMES = ("exact", "int8", "topk")
DP_STEPS = 40
DP_RTOL, DP_ERR_ATOL = 1e-5, 1e-5
REF_TIMEOUT_S = 300


def _tree(seed=0):
    """The reference test's tree, as the port holds it."""
    rng = np.random.default_rng(seed)
    return {
        "layers": {"w": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))},
        "step": torch.tensor(3, dtype=torch.int32),
        "list": [torch.ones(2), torch.zeros(3)],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# -- AdamW ----------------------------------------------------------------------
@pytest.mark.parametrize("wd,clip", [(0.1, 0.5), (0.0, 1.0)])
def test_adamw_matches_reference(wd, clip):
    import jax
    import jax.numpy as jnp
    from repro.train import optimizer as jopt

    rng = np.random.default_rng(0)
    shapes = {"a": (33, 17), "b": {"c": (5,), "d": (2, 3, 4)}}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    cfg = dict(lr=1e-2, weight_decay=wd, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    ts = init_opt_state(tp)
    clipped = 0
    for _ in range(6):
        g = jax.tree.map(lambda a: (3 * rng.normal(size=a.shape)).astype(np.float32), params)
        jp, js, jn = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tn = adamw_update(AdamWConfig(**cfg), tp, jax.tree.map(torch.from_numpy, g), ts)
        clipped += float(jn) > clip
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for want, got in zip(jax.tree.leaves((jp, js["mu"], js["nu"])), _leaves((tp, ts["mu"], ts["nu"]))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
    assert clipped == 6


def test_adamw_updates_in_place():
    p = {"w": torch.ones(3)}
    s = init_opt_state(p)
    w, mu = p["w"], s["mu"]["w"]
    p2, s2, _ = adamw_update(AdamWConfig(), p, {"w": torch.full((3,), 0.5)}, s)
    assert p2["w"] is w and s2["mu"]["w"] is mu
    assert not torch.equal(w, torch.ones(3))


# -- checkpoints ------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 7, tree, {"note": "x"})
    assert latest_step(tmp_path) == 7
    zeros = {"layers": {"w": torch.zeros(4, 8)}, "step": torch.tensor(0, dtype=torch.int32),
             "list": [torch.zeros(2), torch.zeros(3)]}
    restored, manifest = restore_checkpoint(tmp_path, zeros)
    assert manifest["step"] == 7 and manifest["meta"] == {"note": "x"}
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [r["name"] for r in manifest["leaves"]] == ["layers/w", "list/0", "list/1", "step"]


def test_checkpoint_atomicity_partial_write(tmp_path):
    """A stale .tmp dir (crash mid-write) must not be visible as latest."""
    save_checkpoint(tmp_path, 1, _tree())
    (tmp_path / "step_00000002.tmp").mkdir()
    assert latest_step(tmp_path) == 1


def test_checkpoint_gc(tmp_path):
    for s in range(6):
        save_checkpoint(tmp_path, s, _tree())
    gc_checkpoints(tmp_path, keep=2)
    assert latest_step(tmp_path) == 5
    assert len(list(tmp_path.iterdir())) == 2


def test_restore_places_leaves_on_device(tmp_path):
    save_checkpoint(tmp_path, 0, {"w": torch.arange(16.0).reshape(4, 4)})
    example = {"w": torch.empty(4, 4, device="meta")}
    restored, _ = restore_checkpoint(tmp_path, example, device="cpu")
    assert restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], torch.arange(16.0).reshape(4, 4))


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(tmp_path, keep=2)
    for s in (0, 1, 2):
        ck.save(s, _tree())
    ck.wait()
    assert latest_step(tmp_path) == 2


def test_async_checkpointer_saves_the_step_it_was_given(tmp_path):
    """The port's steps write into their tensors: a save must hold the
    values of the moment it was called, not what the caller writes after."""
    tree = _tree()
    want = [t.clone() for t in _leaves(tree)]
    ck = AsyncCheckpointer(tmp_path)
    ck.save(5, tree)
    for t in _leaves(tree):
        t.add_(1)  # the next step, in place, while the thread may still write
    ck.wait()
    restored, _ = restore_checkpoint(tmp_path, tree)
    for w, g in zip(want, _leaves(restored)):
        assert torch.equal(w, g)


def _jax_tree(seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return {
        "layers": {"w": jnp.asarray(rng.normal(size=(4, 8)), jnp.float32)},
        "step": jnp.asarray(3, jnp.int32),
        "list": [jnp.ones(2), jnp.zeros(3)],
    }


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """Either package restores the other's checkpoint, and both write the
    same manifest and the same files for the same tree."""
    import jax
    from repro.train import checkpoint as jck

    meta = {"note": "x"}
    jck.save_checkpoint(tmp_path / "ref", 4, _jax_tree(), meta)
    save_checkpoint(tmp_path / "port", 4, _tree(), meta)
    read = lambda d: json.loads((d / "step_00000004" / "manifest.json").read_text())  # noqa: E731
    assert read(tmp_path / "ref") == read(tmp_path / "port")
    for rec in read(tmp_path / "port")["leaves"]:
        a = np.load(tmp_path / "ref" / "step_00000004" / rec["file"])
        b = np.load(tmp_path / "port" / "step_00000004" / rec["file"])
        assert a.dtype == b.dtype and np.array_equal(a, b), rec["name"]
    if writer == "reference":
        got, manifest = restore_checkpoint(tmp_path / "ref", _tree(1), device="cpu")
        for a, b in zip(_leaves(_tree()), _leaves(got)):
            assert torch.equal(a, b)
    else:
        got, manifest = jck.restore_checkpoint(tmp_path / "port", _jax_tree(1))
        for a, b in zip(jax.tree.leaves(_jax_tree()), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert manifest["step"] == 4


# -- the supervisor -------------------------------------------------------------
def _supervisor(inject, ckpt_dir, ckpt_every=5):
    def init():
        return {"x": torch.zeros(4), "n": torch.tensor(0, dtype=torch.int32)}

    def batch_fn(step):
        rng = np.random.default_rng(step)
        return torch.from_numpy(rng.normal(size=4).astype(np.float32))

    def step_fn(state, batch):
        state["x"].add_(batch)  # in place, as the port's train steps update
        state["n"].add_(1)
        return state, {"loss": float(torch.sum(state["x"] ** 2))}

    return TrainSupervisor(step_fn, batch_fn, init, ckpt_dir, ckpt_every=ckpt_every,
                           injector=FailureInjector(inject))


def test_supervisor_restart_recovers_exactly(tmp_path):
    """Injected failures: the run completes with the failure-free run's
    final loss, to the bit (checkpoint + deterministic replay)."""
    clean = _supervisor({}, tmp_path / "clean").run(23)
    failed = _supervisor({7: "node_loss", 12: "preemption", 19: "oom"}, tmp_path / "faulty").run(23)
    assert failed.restarts == 3
    assert failed.final_step == clean.final_step == 22
    assert failed.losses[-1] == clean.losses[-1]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    class AlwaysFail(FailureInjector):
        def maybe_fail(self, step):
            if step == 0:
                raise InjectedFailure("always")

    sup = TrainSupervisor(step_fn=lambda s, b: (s, {"loss": 1.0}), batch_fn=lambda step: None,
                          init_state_fn=lambda: {"x": torch.zeros(2)}, ckpt_dir=tmp_path,
                          max_restarts=2, injector=AlwaysFail())
    with pytest.raises(RuntimeError, match="exceeded max restarts"):
        sup.run(5)


def test_straggler_detection():
    det = StragglerDetector(window=16, tolerance=2.0, warmup=4)
    for i in range(10):
        det.observe(i, 0.10)
    ev = det.observe(10, 0.35)
    assert ev is not None and ev.step == 10
    assert det.observe(11, 0.11) is None


# -- compression -----------------------------------------------------------------
def test_int8_compression_accuracy():
    import jax.numpy as jnp
    from repro.train import grad_compression as jgc

    x = np.random.default_rng(0).normal(size=(1000,)).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    err = np.abs(dequantize_int8(q, s).numpy() - x).max()
    assert err <= float(s) * 0.51 + 1e-6
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_int8_stochastic_rounding_is_unbiased():
    x = torch.full((20000,), 0.3) * torch.linspace(-1, 1, 20000)
    gen = torch.Generator().manual_seed(0)
    q, s = quantize_int8(x, gen)
    y = (x / s).double()
    assert ((q.double() - torch.floor(y)) >= 0).all() and ((q.double() - torch.floor(y)) <= 1).all()
    assert abs(float((dequantize_int8(q, s) - x).mean())) < 1e-3 * float(s) * 127


def test_topk_error_feedback_invariant():
    """g + err_old == scattered(sel) + err_new (nothing is lost)."""
    import jax.numpy as jnp
    from repro.train import grad_compression as jgc

    rng = np.random.default_rng(1)
    g = rng.normal(size=(64,)).astype(np.float32)
    err = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    sel, idx, new_err = topk_sparsify(torch.from_numpy(g), torch.from_numpy(err), k=8)
    dense = np.zeros(64, np.float32)
    dense[idx.numpy()] = sel.numpy()
    np.testing.assert_allclose(g + err, dense + new_err.numpy(), rtol=1e-6)
    jsel, jidx, jerr = jgc.topk_sparsify(jnp.asarray(g), jnp.asarray(err), 8)
    assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(sel.numpy(), np.asarray(jsel))
    assert np.array_equal(new_err.numpy(), np.asarray(jerr))


def test_topk_takes_the_lower_index_among_ties():
    x = torch.tensor([1.0, -2.0, 2.0, 0.5, 2.0])
    _, idx, _ = topk_sparsify(x, torch.zeros(5), 2)
    assert idx.tolist() == [1, 2]


# -- compressed data parallelism -------------------------------------------------
def dp_problem():
    """check_compressed_dp.py's problem: (w_true, make_batch) as numpy."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8, 1)).astype(np.float32)

    def make_batch(step):
        r = np.random.default_rng(step)
        x = r.normal(size=(64, 8)).astype(np.float32)
        y = x @ w_true + 0.01 * r.normal(size=(64, 1)).astype(np.float32)
        return {"x": x, "y": y}

    return make_batch


def reference_main(path: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import make_mesh as jax_mesh
    from repro.train.grad_compression import init_error_state as jerr_init
    from repro.train.grad_compression import make_compressed_dp_train_step as jstep
    from repro.train.optimizer import AdamWConfig as JConfig
    from repro.train.optimizer import init_opt_state as jopt_init

    assert len(jax.devices()) == 4, jax.devices()
    mesh = jax_mesh((4,), ("data",))
    make_batch = dp_problem()

    def loss_fn(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    out = {}
    for scheme in SCHEMES:
        step = jstep(loss_fn, JConfig(lr=5e-2, weight_decay=0.0), mesh, "data", scheme,
                     topk_frac=0.5)
        params = {"w": jnp.zeros((8, 1), jnp.float32)}
        opt, err = jopt_init(params), jerr_init(params)
        losses, norms = [], []
        for i in range(DP_STEPS):
            params, opt, err, m = step(params, opt, err, jax.tree.map(jnp.asarray, make_batch(i)))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{scheme}/loss"] = np.array(losses)
        out[f"{scheme}/grad_norm"] = np.array(norms)
        out[f"{scheme}/w"] = np.asarray(params["w"])
        out[f"{scheme}/err"] = np.stack([np.asarray(s.data) for s in err["w"].addressable_shards])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def dp_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("compressed_dp") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(Path(__file__).parent.parent / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _port_dp(scheme):
    make_batch = dp_problem()
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)

    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    step = make_compressed_dp_train_step(loss_fn, AdamWConfig(lr=5e-2, weight_decay=0.0), mesh,
                                         "data", scheme, topk_frac=0.5)
    params = {"w": torch.zeros((8, 1))}
    opt, err = init_opt_state(params), [init_error_state(params)] * 4
    losses, norms = [], []
    for i in range(DP_STEPS):
        batch = {k: torch.from_numpy(v) for k, v in make_batch(i).items()}
        params, opt, err, m = step(params, opt, err, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return np.array(losses), np.array(norms), params, err


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compressed_dp_matches_reference(dp_reference, scheme):
    losses, norms, params, err = _port_dp(scheme)
    np.testing.assert_allclose(losses, dp_reference[f"{scheme}/loss"], rtol=DP_RTOL)
    np.testing.assert_allclose(norms, dp_reference[f"{scheme}/grad_norm"], rtol=DP_RTOL)
    np.testing.assert_allclose(params["w"].numpy(), dp_reference[f"{scheme}/w"], rtol=DP_RTOL,
                               atol=DP_ERR_ATOL)
    assert len(err) == 4
    got_err = np.stack([e["w"].numpy() for e in err])
    np.testing.assert_allclose(got_err, dp_reference[f"{scheme}/err"], atol=DP_ERR_ATOL)
    if scheme != "topk":
        assert not got_err.any()


def test_compressed_dp_meets_the_reference_thresholds():
    """check_compressed_dp.py's own assertions, on the port."""
    results = {s: _port_dp(s)[0] for s in SCHEMES}
    for scheme, losses in results.items():
        assert losses[-1] < 0.05 * losses[0], (scheme, losses[0], losses[-1])
    for scheme in ("int8", "topk"):
        assert results[scheme][-1] < results["exact"][-1] * 20 + 1e-3


def test_compressed_dp_refuses_an_indivisible_batch():
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    step = make_compressed_dp_train_step(lambda p, b: (b["x"] @ p["w"]).mean(), AdamWConfig(),
                                         mesh, "data", "exact")
    params = {"w": torch.zeros(8, 1)}
    with pytest.raises(ValueError, match="split"):
        step(params, init_opt_state(params), [init_error_state(params)] * 4,
             {"x": torch.ones(6, 8)})


# -- the bag's gradient ----------------------------------------------------------
BAG_CASES = {  # name: (B, S, V, D, ids low, ids high)
    "pads and past the table": (12, 7, 40, 16, -1, 50),
    "repeats": (10, 9, 6, 8, 0, 3),
    "one row": (8, 5, 1, 4, 0, 1),
    "wide": (33, 17, 300, 130, -1, 330),
}


def _bag_inputs(case):
    B, S, V, D, lo, hi = BAG_CASES[case]
    rng = np.random.default_rng(len(case))
    ids = rng.integers(lo, hi, (B, S)).astype(np.int32)
    ids[0, :2] = ids[1, 0]  # a repeat within a bag and across bags
    return (ids, rng.normal(size=(B, S)).astype(np.float32),
            rng.normal(size=(V, D)).astype(np.float32), rng.normal(size=(B, D)).astype(np.float32))


def _jax_bag_grads(ids, w, table, g, combine):
    import jax
    import jax.numpy as jnp
    from repro.models.embedding import embedding_bag_sum

    def f(t, ww):
        out = embedding_bag_sum(t, jnp.asarray(ids), ww)
        if combine == "mean":  # the kernel's wrapper divides the same way
            out = out / jnp.maximum((ids >= 0).sum(-1, keepdims=True), 1)
        return jnp.sum(out * g)

    if w is None:
        return np.asarray(jax.grad(f)(jnp.asarray(table), None)), None
    gt, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(w))
    return np.asarray(gt), np.asarray(gw)


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", list(BAG_CASES))
def test_bag_backward_matches_jax_grad(case, weighted, combine):
    ids, w, table, g = _bag_inputs(case)
    w = w if weighted else None
    want_t, want_w = _jax_bag_grads(ids, w, table, g, combine)
    tw = None if w is None else torch.from_numpy(w)
    plain = embedding_bag_backward_plain(torch.from_numpy(ids), torch.from_numpy(g),
                                         table.shape[0], tw, combine)
    np.testing.assert_allclose(plain.numpy(), want_t, rtol=1e-6, atol=1e-6)
    t = torch.from_numpy(table).requires_grad_()
    tw = None if w is None else torch.from_numpy(w).requires_grad_()
    embedding_bag(torch.from_numpy(ids), t, tw, combine).backward(torch.from_numpy(g))
    assert torch.equal(t.grad, plain)
    assert torch.equal(embedding_bag_backward(torch.from_numpy(ids), torch.from_numpy(g),
                                              table.shape[0], tw, combine), plain)
    if weighted:
        inside = ids < table.shape[0]
        np.testing.assert_allclose(tw.grad.numpy()[inside], want_w[inside], rtol=1e-5, atol=1e-5)
        assert not tw.grad.numpy()[~inside].any()


def test_bag_sum_gradient_through_the_model_function():
    ids, _, table, g = _bag_inputs("pads and past the table")
    t = torch.from_numpy(table).requires_grad_()
    temb.embedding_bag_sum(t, torch.from_numpy(ids)).backward(torch.from_numpy(g))
    want, _ = _jax_bag_grads(ids, None, table, g, "sum")
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bag_backward_refuses_bfloat16_tables():
    t = torch.zeros(4, 3, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(TypeError, match="float32"):
        embedding_bag(torch.zeros(2, 2, dtype=torch.int32), t)
    with torch.no_grad():  # no gradient asked: the forward takes bfloat16
        assert embedding_bag(torch.zeros(2, 2, dtype=torch.int32), t).dtype == torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BAG_CASES))
def test_bag_backward_kernel_matches_plain_cuda(cuda, case):
    host = [torch.from_numpy(a) for a in _bag_inputs(case)]
    ids, w, table, g = (t.to(cuda) for t in host)
    for combine in ("sum", "mean"):
        for ww, hw in ((None, None), (w, host[1])):
            before = embedding_bag_backward.launches
            got = embedding_bag_backward(ids, g, table.shape[0], ww, combine)
            torch.cuda.synchronize()
            assert embedding_bag_backward.launches == before + 1
            want = embedding_bag_backward_plain(host[0], host[3], table.shape[0], hw, combine)
            assert torch.equal(got.cpu(), want)


def test_twotower_train_step_replays_to_the_bit():
    from repro_torch.configs.recsys_archs import TWO_TOWER
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import tree_leaves

    arch = TWO_TOWER.reduced()
    built = build_step(arch, "train_batch", make_mesh((1, 1), ("data", "model"), devices=["cpu"]))
    runs = []
    for _ in range(2):
        params, opt, batch = materialize_inputs(arch, "train_batch", built, seed=3)
        metrics = []
        for _ in range(3):
            params, opt, m = built.fn(params, opt, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, tree_leaves(params)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


if __name__ == "__main__":
    reference_main(sys.argv[1])
