"""The recsys tables' gradients: each lookup's backward through the sorted
segment sum (``kernels/segment_sum`` ``take_rows``), and the data shards'
table gradients summed over the rows their lookups touched
(``parallel.all_reduce_rows``, chosen by ``launch/steps.py``
``sum_replicas`` through ``parallel.rows_move_less``).

* ``embedding_lookup`` and ``sharded_embedding_lookup`` on (1, 2) and
  (2, 2) CPU meshes: the table's gradient against ``jax.grad`` of the
  reference's (run once, as a script in a subprocess with four forced
  host devices) within the recsys tolerance (rtol and atol 1e-5,
  ``tests/test_torch_multidevice.py``), and to the bit against the
  segment sum of the rows' gradients in index order (one per data shard,
  added in shard order, where the ids split over data shards). Ids hold
  -1 pads, ids past the table (dropped from the gradient, as the
  reference's fill mode drops them) and rows 0 and V - 1.
* The host's gradient of both lookups at a size past ``index_put_``'s
  parallel grain (2^15 values), on several threads with deterministic
  algorithms off: five runs equal to the bit.
* ``all_reduce_rows`` against ``all_reduce`` on CPU replicas, n = 2, 3
  and 4, to the bit (signs of zero included): rows touched by one shard,
  by several, by all and by none, ids 0 and V - 1, repeats, padded and
  empty lists, values whose sum shows the order; in place; its copy
  record, each list to the n - 1 other shards.
* The shape rule: two-tower's item and category tables at (4, 1), B
  32,768, take the touched rows; on 16x16 at B 65,536 they stay dense;
  the dry run of two-tower's train_batch on a (4, 1) mesh of ``meta``
  counts the lists and all-reduces no table.
* The four reduced recsys archs' train step on hand-placed (2, 1)
  replicas: the touched-row sum forced on every table and forced off
  give the same loss, norm, parameters and moments, to the bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side: a card host without JAX skips the file
import jax.numpy as jnp  # noqa: E402

from repro.launch.mesh import make_mesh as jax_mesh  # noqa: E402
from repro.models import embedding as jemb  # noqa: E402
from repro_torch.configs.recsys_archs import RECSYS_ARCHS, TWO_TOWER  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum_plain  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import embedding as temb  # noqa: E402
from repro_torch.models import tree_leaves  # noqa: E402
from repro_torch.parallel import (  # noqa: E402
    Sharded,
    all_reduce,
    all_reduce_rows,
    copy_record,
    rows_move_less,
)
from repro_torch.train.optimizer import init_opt_state  # noqa: E402

AXES = ("data", "model")
MESHES = ((1, 2), (2, 2))
V, D, B, L = 64, 8, 8, 6  # the table, and the ids' (B, L)
RECSYS_TOL = 1e-5  # tests/test_torch_multidevice.py
GRAIN = 1 << 15  # at::internal::GRAIN_SIZE: index_put_'s parallel loop from here on
REPLAYS = 5
ARCH_IDS = ("bert4rec", "sasrec", "din", "two-tower-retrieval")
REF_TIMEOUT_S = 300


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def lookup_inputs():
    """(table, ids, the output's gradient): ids with -1 pads, ids past the
    table, and rows 0 and V - 1."""
    rng = np.random.default_rng(28)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(-1, V + 4, (B, L)).astype(np.int32)
    ids[0, :3] = (0, V - 1, 0)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    return table, ids, g


# -- the reference side (run as a script with four host devices) ------------------
def reference_main(path: str) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    table, ids, g = lookup_inputs()
    out = {"plain": np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(jemb.embedding_lookup(t, ids) * g)))(table))}
    for shape in MESHES:
        mesh = jax_mesh(shape, AXES)
        out[_tag(shape)] = np.asarray(jax.jit(jax.grad(
            lambda t: jnp.sum(jemb.sharded_embedding_lookup(t, ids, mesh) * g)))(table))
    np.savez(path, **out)


@pytest.fixture(scope="module", autouse=True)
def reference_process(tmp_path_factory):
    """The reference script, started with the module so it runs beside the
    tests that do not need it -> (process, output path)."""
    path = tmp_path_factory.mktemp("table_grads") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(Path(__file__).parent.parent / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, __file__, str(path)], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_process):
    proc, path = reference_process
    out, _ = proc.communicate(timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, out
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# -- the port side -----------------------------------------------------------------
def cpu_mesh(shape):
    return make_mesh(shape, AXES, devices=["cpu"] * int(np.prod(shape)))


def _lookup_grad(table, ids, g, shape=None):
    """The port's gradient of sum(lookup * g) with respect to a plain
    table: unsharded, or over a CPU mesh of ``shape``."""
    t = torch.from_numpy(table).requires_grad_()
    ids_t = torch.from_numpy(ids)
    out = (temb.embedding_lookup(t, ids_t) if shape is None
           else temb.sharded_embedding_lookup(t, ids_t, cpu_mesh(shape)))
    return torch.autograd.grad(out, t, torch.from_numpy(g))[0]


def _index_order(ids, g, dp: int = 1):
    """The segment sum of the rows' gradients in index order, one per data
    shard (the ids' rows split in dp), added in shard order; ids outside
    the table dropped."""
    total = None
    for i, gi in zip(np.split(ids, dp), np.split(g, dp)):
        part = segment_sum_plain(torch.from_numpy(gi.reshape(-1, D)),
                                 torch.from_numpy(i.reshape(-1)), V)
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("shape", [None, *MESHES], ids=["unsharded", *map(_tag, MESHES)])
def test_lookup_gradient_is_the_segment_sum(reference, shape):
    """The table's gradient: within the recsys tolerance of ``jax.grad`` of
    the reference's lookup, and the segment sum in index order to the bit
    (ids past the table and -1 pads add nothing)."""
    table, ids, g = lookup_inputs()
    got = _lookup_grad(table, ids, g, shape)
    want = reference["plain" if shape is None else _tag(shape)]
    np.testing.assert_allclose(got.numpy(), want, rtol=RECSYS_TOL, atol=RECSYS_TOL)
    assert torch.equal(got, _index_order(ids, g, 1 if shape is None else shape[0]))
    assert torch.isfinite(got).all()
    assert not got[np.setdiff1d(np.arange(V), ids[(ids >= 0) & (ids < V)])].any()


@pytest.mark.parametrize("shape", [None, (2, 2)], ids=["unsharded", "2x2"])
def test_host_lookup_gradient_replays_past_the_grain(shape):
    """Past the parallel grain, on several threads, deterministic
    algorithms off: five runs of the host's lookup gradient equal to the
    bit."""
    rng = np.random.default_rng(5)
    rows, width, n = 1000, 64, 1024
    table = rng.normal(size=(rows, width)).astype(np.float32)
    ids = rng.integers(-1, rows, (n, 1)).astype(np.int32)
    g = rng.normal(size=(n, 1, width)).astype(np.float32)
    assert n * width >= 2 * GRAIN
    threads, determ = torch.get_num_threads(), torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(max(2, threads))
    torch.use_deterministic_algorithms(False)
    try:
        t = torch.from_numpy(table).requires_grad_()
        ids_t, g_t = torch.from_numpy(ids), torch.from_numpy(g)
        mesh = None if shape is None else cpu_mesh(shape)

        def grad():
            out = (temb.embedding_lookup(t, ids_t) if mesh is None
                   else temb.sharded_embedding_lookup(t, ids_t, mesh))
            return torch.autograd.grad(out, t, g_t)[0]

        runs = [grad() for _ in range(REPLAYS)]
    finally:
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(determ)
    assert all(torch.equal(r.view(torch.int32), runs[0].view(torch.int32)) for r in runs[1:])


# -- the touched-row sum ------------------------------------------------------------
def _shard_grads(n: int, rows: int = 40, width: int = 3):
    """n replicas' gradients and their row lists: each gradient the segment
    sum of values drawn over its list, so exactly +0.0 off it. Row 0 is
    touched by every shard with a list, row rows - 1 by the last, rows 1-4
    by one shard each, rows 5-9 by two or three, rows 10-19 by none; each
    list has repeats and -1 pads; shard 2's list is empty where n is 4.
    Values of 2^24 and 1 make the order of the sums show (row 0: 2^24, 1,
    then -2^24 from the last shard)."""
    rng = np.random.default_rng(n)
    empty = 2 if n == 4 else None
    lists = []
    for i in range(n):
        own = [0, 1 + i % 4, 5 + i % 5, 5 + (i + 1) % 5, 20 + i, 20 + i]
        if i == n - 1:
            own.append(rows - 1)
        if i == empty:
            own = []
        own = np.array(own + [-1] * (3 if own else 0), np.int32)
        lists.append(rng.permutation(own))
    grads = []
    for i, own in enumerate(lists):
        vals = rng.choice([2.0 ** 24, 1.0, -(2.0 ** 24), 0.5], size=(own.size, width))
        g = segment_sum_plain(torch.from_numpy(vals.astype(np.float32)), torch.from_numpy(own),
                              rows)
        if i != empty:
            g[0] = -(2.0 ** 24) if i == n - 1 else 2.0 ** 24 if i == 0 else 1.0
        grads.append(g)
    return grads, [torch.from_numpy(x) for x in lists]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_all_reduce_rows_equals_all_reduce_to_the_bit(n):
    """The touched-row sum writes the dense all-reduce's bits into every
    replica, in place, signs of zero included; the lists noted as
    ``row-lists``, each to the n - 1 other shards."""
    grads, lists = _shard_grads(n)
    want = all_reduce([g.clone() for g in grads])
    right = grads[-1]
    for g in reversed(grads[:-1]):
        right = g + right
    assert n == 2 or not torch.equal(want[0], right)  # the order shows
    given = [g.clone() for g in grads]
    with copy_record() as rec:
        got = all_reduce_rows(given, lists)
    assert all(g is x for g, x in zip(got, given))
    for g in got:
        assert torch.equal(g.view(torch.int32), want[0].view(torch.int32))
    width = grads[0].shape[1] * 4 + 4
    assert rec.bytes == {"row-lists": (n - 1) * sum(x.numel() for x in lists) * width}
    assert rec.count == n * (n - 1)


def test_all_reduce_rows_takes_empty_lists():
    """Every list empty: every replica written with zeros."""
    grads = [torch.zeros(6, 2) for _ in range(3)]
    got = all_reduce_rows([torch.full((6, 2), 0.0) for _ in range(3)],
                          [torch.zeros(0, dtype=torch.int32)] * 3)
    assert all(torch.equal(g.view(torch.int32), grads[0].view(torch.int32)) for g in got)


def test_shape_rule():
    """Two-tower's item and category tables: touched rows at (4, 1) of B
    32,768 (8,192 rows a shard, 51 item lookups a row), dense on 16x16 at
    B 65,536 (4,096 rows a shard, each 1/16 of the table's rows)."""
    cfg = TWO_TOWER.model_cfg
    items, cates, width = (cfg.n_items, cfg.embed_dim), (cfg.n_cates, cfg.embed_dim), 1 + cfg.hist_len
    assert rows_move_less(4, 8192 * width, items) and rows_move_less(4, 8192, cates)
    block = lambda t: (t[0] // 16, t[1])  # noqa: E731
    assert not rows_move_less(16, 4096 * width, block(items))
    assert not rows_move_less(16, 4096, block(cates))
    assert not rows_move_less(1, 1, items)


def test_dry_run_counts_the_row_lists_on_4x1():
    """two-tower's train_batch on a (4, 1) mesh of ``meta``: each table's
    gradient goes as each data shard's row lists, (n - 1) lists of its
    lookups' ids and rows a shard; the dense reduce-scatter and
    all-gather carry only the towers' gradients (and the item vectors'
    gather)."""
    arch = TWO_TOWER
    cfg, B_ = arch.model_cfg, arch.shapes["train_batch"].dims["batch"]
    n = 4
    rec = dryrun.run_cell(arch, "train_batch", False,
                          mesh=make_mesh((n, 1), AXES, devices=["meta"] * n))
    once = rec["collectives"]["once_bytes"]
    rows = B_ // n
    lists = n * rows * (1 + cfg.hist_len + 1)  # every shard's item and category lookups
    assert once["row-lists"] == int((n - 1) * lists * (cfg.embed_dim * 4 + 4) / n)
    towers = sum(x.numel() for k, t in tsteps.recsys.twotower_init(cfg, device="meta").items()
                 if k.endswith("tower") for x in tree_leaves(t)) * 4
    assert once["reduce-scatter"] == int((n - 1) * (towers + B_ * cfg.tower[-1] * 4) / n)


# -- a train step on hand-placed replicas --------------------------------------------
def _replicated(params, mesh):
    return {k: ({kk: _replicated_leaf(vv, mesh) for kk, vv in v.items()} if isinstance(v, dict)
                else _replicated_leaf(v, mesh)) for k, v in params.items()}


def _replicated_leaf(x, mesh):
    if isinstance(x, dict):
        return {k: _replicated_leaf(v, mesh) for k, v in x.items()}
    return Sharded.split(x.clone(), mesh.grid()[:, :1], (None, None))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_touched_rows_step_equals_the_dense_step(monkeypatch, arch_id):
    """A train step on hand-placed (2, 1) replicas with the touched-row sum
    forced on every table, and forced off: loss, grad norm, parameters and
    moments equal to the bit."""
    port = next(a for a in RECSYS_ARCHS if a.arch_id == arch_id).reduced()
    mesh = cpu_mesh((2, 1))
    built = tsteps.build_step(port, "train_batch", mesh)
    params, _, batch = tsteps.materialize_inputs(port, "train_batch", built, seed=6)
    calls = []
    orig = tsteps.all_reduce_rows
    monkeypatch.setattr(tsteps, "all_reduce_rows",
                        lambda *a: (calls.append(a[0][0].shape), orig(*a))[1])

    def run(rows: bool):
        monkeypatch.setattr(tsteps, "rows_move_less", lambda *a: rows)
        p = _replicated(params, mesh)
        p, o, m = built.fn(p, init_opt_state(p), batch)
        return (float(m["loss"]), float(m["grad_norm"])), [t.view(torch.int32)
                                                           for t in tree_leaves((p, o))]

    dense, dense_leaves = run(False)
    assert not calls
    sparse, sparse_leaves = run(True)
    tables = [k for k, v in params.items() if k.endswith("emb") and "pos" not in k]
    assert len(calls) == len(tables)  # each table
    assert sparse == dense
    assert all(torch.equal(a, b) for a, b in zip(sparse_leaves, dense_leaves))


if __name__ == "__main__":
    reference_main(sys.argv[1])
