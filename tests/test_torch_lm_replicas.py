"""An LM train step with its weights held once per data shard
(``launch/steps.py`` ``sum_replicas``, ``parallel.all_reduce``).

A CPU mesh shares one device, so ``place_params`` keeps no replicas there
(and FSDP-splits what divides). Here every leaf of the reduced float32
stablelm and phi3.5-moe is placed by hand, whole along the data axis: once
per data shard (replicas), or once for all of them (every data shard's
view of one block, its gradient added over the data shards in shard order
by ``gather_blocks``' backward). Three train steps on (2, 1) and (2, 2)
meshes keep every replica of every parameter and moment equal to the bit
after each step, and give the losses, grad norms (each replica counted
once) and parameters of the one-copy placement: to the bit on (2, 1),
since ``all_reduce`` adds the replicas' gradients in the shard order
``gather_blocks`` adds the data shards'; within ``OWN_TOL`` on (2, 2),
where a leaf every model column uses whole has its columns' gradients
added first on each data shard. A replay from the same state is equal in
every leaf.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs.lm_archs import LM_ARCHS
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import tree_leaves
from repro_torch.parallel import Sharded
from repro_torch.train.optimizer import init_opt_state

AXES = ("data", "model")
STEPS = 3
OWN_TOL = 1e-5  # float32, rtol and atol: the (2, 2) mesh's other order of adding


def _port(arch_id):
    port = next(a for a in LM_ARCHS if a.arch_id == arch_id).reduced()
    return replace(port, model_cfg=replace(port.model_cfg, dtype="float32"))


def _placed(params, mesh, rows: int):
    """Each leaf whole along the data axis, its model blocks as placed,
    on the mesh's first ``rows`` data rows: replicas where ``rows`` > 1."""
    grid = mesh.grid()

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        axis, cols = (x.axes[1], x.grid[1]) if isinstance(x, Sharded) else (None, 1)
        full = (x.full() if isinstance(x, Sharded) else x).clone()
        if rows == cols == 1:
            return full
        return Sharded.split(full, grid[:rows, :cols], (None, axis),
                             x.spans if axis is not None else None)

    return leaf(params)


def _rows_equal(tree) -> bool:
    return all(torch.equal(x.block(i, j), x.block(0, j))
               for x in _sharded(tree) for i in range(1, x.grid[0]) for j in range(x.grid[1]))


def _sharded(tree) -> list:
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _sharded(v)]
    return [tree] if isinstance(tree, Sharded) else []


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch_id", ["stablelm-1.6b", "phi3.5-moe-42b-a6.6b"])
def test_lm_replicas_stay_equal_to_the_bit(monkeypatch, arch_id, mesh):
    monkeypatch.setenv("REPRO_BF16_GATHER", "0")
    port = _port(arch_id)
    mesh = make_mesh(mesh, AXES, devices=["cpu"] * int(np.prod(mesh)))
    built = tsteps.build_step(port, "train_4k", mesh)
    params, _, batch = tsteps.materialize_inputs(port, "train_4k", built, seed=5)

    def runs(p, check):
        o, out = init_opt_state(p), []
        for _ in range(STEPS):
            p, o, m = built.fn(p, o, batch)
            if check:
                assert _rows_equal(p) and _rows_equal(o["mu"]) and _rows_equal(o["nu"])
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, tree_leaves((p, o), replicas=False)

    rows = mesh.grid().shape[0]
    replicated = _placed(params, mesh, rows)
    assert all(x.grid[0] == rows for x in _sharded(replicated))
    got, got_leaves = runs(replicated, True)
    want, want_leaves = runs(_placed(params, mesh, 1), False)
    assert np.isfinite(got).all()
    if mesh.grid().shape[1] == 1:
        assert got == want
        assert all(torch.equal(a, b) for a, b in zip(got_leaves, want_leaves))
    else:
        np.testing.assert_allclose(got, want, rtol=OWN_TOL, atol=OWN_TOL)
        for a, b in zip(got_leaves, want_leaves):
            torch.testing.assert_close(a, b, rtol=OWN_TOL, atol=OWN_TOL)
    again, again_leaves = runs(_placed(params, mesh, rows), True)
    assert again == got
    assert all(torch.equal(a, b) for a, b in zip(again_leaves, got_leaves))
