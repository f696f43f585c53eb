"""The port's train steps (``launch/steps.py``, train half) and training
driver (``launch/train.py``) against the reference's.

For every reduced train cell — the five LMs at train_4k, the four recsys
models at train_batch — ``build_step`` gives meta-device abstract
arguments (parameters, optimizer state, batch) and ``materialize_inputs``
concrete ones whose batch equals the reference's draw for draw, to the
bit; the port's step on the reference's inputs (its weights carried
across with ``carry_params``, its optimizer state too) agrees with the
reference's built step on a (1, 1) mesh over two steps:

* recsys, float32 throughout: loss and grad_norm within rtol 1e-5
  (sums in other orders);
* the LMs in their own bf16 compute (float32 masters, the bf16 gather):
  loss within rtol 2e-3, grad_norm within rtol 3e-2 (bf16 products and
  sums rounded in other orders, and Adam's first step, about lr * sign(g)
  per element, carries any flipped sign of a tiny gradient into step 2);
* stablelm and granite in float32 compute: with ``REPRO_BF16_GATHER=0``
  loss and grad_norm within rtol 2e-6; with the gather, whose gradients
  are bf16-rounded, loss within 1e-4 and grad_norm within 3e-3.

Then the smoke LM's loss falls over 20 steps on one batch, as
``test_smoke_archs.py`` requires of the reference; the supervisor
(``train_arch``) recovers from an injected failure with the uninterrupted
run's losses, to the bit; and the CLI runs on the CPU.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side: a card host without JAX skips the file

from repro.configs.lm_archs import LM_ARCHS as REF_LM_ARCHS
from repro.configs.recsys_archs import RECSYS_ARCHS as REF_RECSYS_ARCHS
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh as jax_mesh
from repro_torch.configs.lm_archs import LM_ARCHS
from repro_torch.configs.recsys_archs import RECSYS_ARCHS
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import carry_params

CPU = "cpu"
F32_RTOL = 1e-5
BF16_LOSS_RTOL, BF16_GNORM_RTOL = 2e-3, 3e-2
F32_NO_GATHER_RTOL = 2e-6
F32_GATHER_LOSS_RTOL, F32_GATHER_GNORM_RTOL = 1e-4, 3e-3
LM_IDS = [a.arch_id for a in LM_ARCHS]
RECSYS_IDS = [a.arch_id for a in RECSYS_ARCHS]


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _mesh11():
    return make_mesh((1, 1), ("data", "model"), devices=[CPU])


def _archs(arch_id, dtype=None):
    lm = arch_id in LM_IDS
    ref = next(a for a in (REF_LM_ARCHS if lm else REF_RECSYS_ARCHS) if a.arch_id == arch_id)
    port = next(a for a in (LM_ARCHS if lm else RECSYS_ARCHS) if a.arch_id == arch_id)
    ref, port = ref.reduced(), port.reduced()
    if dtype is not None:
        ref = replace(ref, model_cfg=replace(ref.model_cfg, dtype=dtype))
        port = replace(port, model_cfg=replace(port.model_cfg, dtype=dtype))
    return ref, port, "train_4k" if lm else "train_batch"


def _two_steps(ref, port, shape_name):
    """Both packages' built steps twice on the reference's inputs ->
    [(reference loss, grad_norm), ...], [(port loss, grad_norm), ...]."""
    jbuilt = jsteps.build_step(ref, shape_name, jax_mesh((1, 1), ("data", "model")))
    jargs = jsteps.materialize_inputs(ref, shape_name, jbuilt, seed=1)
    carried = [carry_params(jax.tree.map(np.asarray, a), device=CPU) for a in jargs]
    built = tsteps.build_step(port, shape_name, _mesh11())
    if "n_micro" in jbuilt.meta:
        assert built.meta["n_micro"] == jbuilt.meta["n_micro"]
    want, got = [], []
    jp, jo = jargs[0], jargs[1]
    p, o = carried[0], carried[1]
    for _ in range(2):
        jp, jo, jm = jbuilt.fn(jp, jo, jargs[2])
        p, o, m = built.fn(p, o, carried[2])
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    assert int(o["step"]) == int(jo["step"]) == 2
    return np.array(want), np.array(got)


@pytest.mark.parametrize("arch_id", LM_IDS + RECSYS_IDS)
def test_built_train_step(arch_id):
    """build_step + materialize_inputs for every reduced train cell: meta
    arguments, the reference's batch to the bit, float32 masters and
    zeroed moments, finite metrics; then two steps on the reference's
    inputs against the reference's built step."""
    ref, port, shape_name = _archs(arch_id)
    built = tsteps.build_step(port, shape_name, _mesh11())
    assert all(t.device.type == "meta" for t in _leaves(built.args))
    params, opt, batch = tsteps.materialize_inputs(port, shape_name, built, seed=1)
    jbuilt = jsteps.build_step(ref, shape_name, jax_mesh((1, 1), ("data", "model")))
    jbatch = jsteps.materialize_inputs(ref, shape_name, jbuilt, seed=1)[2]
    assert sorted(batch) == sorted(jbatch)
    for name in jbatch:
        want = np.asarray(jbatch[name])
        got = batch[name].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert all(t.dtype == torch.float32 for t in _leaves(params))
    assert not any(bool(t.any()) for t in _leaves((opt["mu"], opt["nu"])))
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0
    _, _, metrics = built.fn(params, opt, batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    if port.family == "lm":
        assert built.meta["bf16_gather"] is True

    want, got = _two_steps(ref, port, shape_name)
    if port.family == "lm":
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=BF16_GNORM_RTOL)
    else:
        np.testing.assert_allclose(got, want, rtol=F32_RTOL)


@pytest.mark.parametrize("gather", ["0", "1"])
@pytest.mark.parametrize("arch_id", ["stablelm-1.6b", "granite-moe-1b-a400m"])
def test_float32_lm_train_step(monkeypatch, arch_id, gather):
    """The dense and the MoE (capacity dispatch) LM in float32 compute,
    with and without the bf16 gather."""
    monkeypatch.setenv("REPRO_BF16_GATHER", gather)
    ref, port, shape_name = _archs(arch_id, dtype="float32")
    assert tsteps.build_step(port, shape_name, _mesh11()).meta["bf16_gather"] is (gather == "1")
    want, got = _two_steps(ref, port, shape_name)
    if gather == "0":
        np.testing.assert_allclose(got, want, rtol=F32_NO_GATHER_RTOL)
    else:
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=F32_GATHER_LOSS_RTOL)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=F32_GATHER_GNORM_RTOL)


def test_micro_batches_follow_the_reference_rule(monkeypatch):
    """REPRO_MICRO_STACK_GIB splits the batch as the reference does, and
    the accumulated step equals the reference's."""
    monkeypatch.setenv("REPRO_MICRO_STACK_GIB", str(2 * 64 * 64 * 2 * 2 / 2**30))
    ref, port, shape_name = _archs("stablelm-1.6b", dtype="float32")
    built = tsteps.build_step(port, shape_name, _mesh11())
    assert built.meta["n_micro"] == 2
    want, got = _two_steps(ref, port, shape_name)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=F32_GATHER_LOSS_RTOL)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=F32_GATHER_GNORM_RTOL)


def test_train_loss_decreases_lm_smoke():
    """20 steps of the smoke LM on one batch must reduce its loss."""
    port = next(a for a in LM_ARCHS if a.arch_id == "stablelm-1.6b").reduced()
    built = tsteps.build_step(port, "train_4k", _mesh11())
    params, opt, batch = tsteps.materialize_inputs(port, "train_4k", built, seed=2)
    losses = []
    for _ in range(20):
        params, opt, metrics = built.fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses


def test_lm_batches_match_reference():
    from repro.launch.train import make_lm_batch_fn as jax_batch_fn

    want = jax_batch_fn(512, 4, 64, seed=3)(7)
    got = ttrain.make_lm_batch_fn(512, 4, 64, seed=3, device=CPU)(7)
    for name in ("tokens", "targets"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))


def test_train_arch_resumes_exactly(tmp_path):
    """A failure at step 15 with checkpoints every 10 steps: one restart,
    and the losses from the restored step on equal an uninterrupted run's."""
    kw = dict(steps=30, ckpt_every=10, device=CPU)
    clean = ttrain.train_arch("stablelm-1.6b", ckpt_dir=str(tmp_path / "clean"), **kw)
    failed = ttrain.train_arch("stablelm-1.6b", ckpt_dir=str(tmp_path / "faulty"),
                               inject_failures={15: "node_loss"}, **kw)
    assert clean.restarts == 0 and failed.restarts == 1
    assert failed.final_step == clean.final_step == 29
    # the faulty run logs steps 0-14, then replays 10-29 from step 9's checkpoint
    assert failed.losses[:15] == clean.losses[:15]
    assert failed.losses[15:] == clean.losses[10:]


def test_train_cli(tmp_path, capsys):
    ttrain.main(["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "steps=3 restarts=0" in out
