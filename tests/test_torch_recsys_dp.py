"""The recsys built steps data-parallel over CPU meshes, as the reference's
``batch_pspec`` places them (``launch/steps.py`` ``build_recsys_step``,
``models/recsys.py`` ``DataShards``, ``parallel.py`` ``all_reduce``).

* Every reduced recsys arch's train, serve and retrieval step on (2, 1),
  (4, 1) and (2, 2) meshes of ``["cpu"] * n``: each dense call (a tower,
  DIN's head, a seqrec block's MLP) takes its data shard's B/dp rows (or
  C/dp candidates; retrieval's user side once, one row); the outputs, or
  two train steps' losses and grad norms, against the reference's built
  step on the same mesh shape (run once, as a script in a subprocess with
  eight forced host devices, its inputs carried across) under
  ``tests/test_torch_multidevice.py``'s recsys tolerances (rtol and atol
  1e-5; top-k ids equal where the scores are not tied), and against the
  port's own (1, 1) step within 1e-5.
* Replicas placed by hand (a CPU mesh shares one device, so
  ``place_params`` keeps one copy there): every table and leaf once per
  data shard. Three train steps keep every replica of every parameter and
  moment equal to the bit, give the losses, grad norms (each replicated
  leaf counted once) and parameters of the same steps on the unreplicated
  placement to the bit, replay to the bit, and copy no block of a placed
  leaf. ``all_reduce`` adds each slice in shard order and notes its two
  halves.
* The dry run on the 16x16 mesh of ``meta``: two-tower's train_batch
  broadcasts no table (its broadcast is the lookups' backward) and
  reduce-scatters and all-gathers each table's gradient once, 2 x 15/16 of
  646,400,000 B a device, beside the towers' gradients and the item
  vectors' gather.
"""

import functools
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side: a card host without JAX skips the file

from repro.configs.recsys_archs import RECSYS_ARCHS as REF_RECSYS_ARCHS  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_mesh as jax_mesh  # noqa: E402
from repro_torch.configs.recsys_archs import RECSYS_ARCHS  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import embedding, recsys, tree_leaves, tree_map  # noqa: E402
from repro_torch import parallel  # noqa: E402
from repro_torch.parallel import Sharded, all_reduce, copy_record  # noqa: E402
from repro_torch.train.optimizer import init_opt_state  # noqa: E402

AXES = ("data", "model")
ARCH_IDS = ("bert4rec", "sasrec", "din", "two-tower-retrieval")
SHAPES = {"train": "train_batch", "serve": "serve_p99", "retrieval": "retrieval_cand"}
MESHES = ((2, 1), (4, 1), (2, 2))
RECSYS_TOL = 1e-5  # tests/test_torch_multidevice.py: outputs, losses and grad norms
OWN_TOL = 1e-5  # against the port's (1, 1) step
REPLICA_STEPS = 3
REF_TIMEOUT_S = 600
CARD_BYTES = 76e9


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _key(*parts) -> str:
    return "|".join(str(p) for p in parts)


def _archs(arch_id):
    return (next(a for a in REF_RECSYS_ARCHS if a.arch_id == arch_id).reduced(),
            next(a for a in RECSYS_ARCHS if a.arch_id == arch_id).reduced())


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for name in tree for k, v in _flat(tree[name], prefix + (name,)).items()}
    return {"/".join(prefix): np.asarray(tree)}


def _nest(flat: dict) -> dict:
    out = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.from_numpy(np.array(v))
    return out


# -- the reference side (run as a script with eight host devices) -----------------
def reference_main(path: str) -> None:
    assert len(jax.devices()) == 8, jax.devices()
    out = {}
    for arch_id in ARCH_IDS:
        ref, _ = _archs(arch_id)
        for kind, shape in SHAPES.items():
            for i, mesh in enumerate(MESHES):
                jbuilt = jsteps.build_step(ref, shape, jax_mesh(mesh, AXES))
                args = jsteps.materialize_inputs(ref, shape, jbuilt, seed=1)
                if i == 0:  # the inputs do not depend on the mesh
                    for k, v in _flat(args[0]).items():
                        out[_key(arch_id, kind, "params", k)] = v
                    for k, v in args[-1].items():
                        out[_key(arch_id, kind, "batch", k)] = np.asarray(v)
                if kind == "train":
                    # compiled once: a second call on the first's placed results would
                    # compile again for their shardings
                    step = jbuilt.fn.lower(*args).compile()
                    p, o, metrics = args[0], args[1], []
                    for _ in range(2):
                        p, o, m = step(p, o, args[2])
                        metrics.append([float(m["loss"]), float(m["grad_norm"])])
                    res = (np.array(metrics),)
                else:
                    res = jbuilt.fn(*args)
                    res = tuple(res) if isinstance(res, (tuple, list)) else (res,)
                for j, r in enumerate(res):
                    out[_key(arch_id, kind, _tag(mesh), j)] = np.asarray(r)
    np.savez(path, **out)


@pytest.fixture(scope="module", autouse=True)
def reference_process(tmp_path_factory):
    """The reference script, started with the module so it runs beside the
    tests that do not need it -> (process, output path)."""
    path = tmp_path_factory.mktemp("recsys_dp") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
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


def _inputs(reference, arch_id, kind):
    """The reference's inputs, fresh tensors: (params, batch)."""
    pre = _key(arch_id, kind, "params", "")
    params = _nest({k[len(pre):]: v for k, v in reference.items() if k.startswith(pre)})
    pre = _key(arch_id, kind, "batch", "")
    batch = {k[len(pre):]: torch.from_numpy(np.array(v)) for k, v in reference.items()
             if k.startswith(pre)}
    return params, batch


def _run(arch_id, kind, mesh, params, batch):
    """The port's built step over ``mesh`` -> its outputs as numpy arrays
    (two train steps' [loss, grad norm])."""
    _, port = _archs(arch_id)
    built = tsteps.build_step(port, SHAPES[kind], mesh)
    placed = tsteps.place_params(built, tree_map(torch.clone, params))  # a step writes in place
    if kind == "train":
        opt, metrics = init_opt_state(placed), []
        for _ in range(2):
            placed, opt, m = built.fn(placed, opt, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        return (np.array(metrics),), built
    out = built.fn(placed, batch)
    return tuple(t.numpy() for t in (out if isinstance(out, tuple) else (out,))), built


@functools.cache
def _one_device(arch_id, kind):
    return _run(arch_id, kind, cpu_mesh((1, 1)), *_INPUTS[arch_id, kind])[0]


_INPUTS = {}


def _dense_rows(monkeypatch):
    """Record the rows every dense call takes: the towers, DIN's head and
    each seqrec block's MLP."""
    rows = []

    def record(name, arg):
        orig = getattr(recsys, name)

        def wrapped(*a, **k):
            rows.append(int(a[arg].shape[0]))
            return orig(*a, **k)
        monkeypatch.setattr(recsys, name, wrapped)

    record("_tower", 1)
    record("_din_head", 1)
    record("mlp_block", 1)
    return rows


def _want_rows(arch_id, kind, dp):
    """The rows of each dense call, in call order."""
    _, port = _archs(arch_id)
    cfg, dims = port.model_cfg, port.shapes[SHAPES[kind]].dims
    if kind == "retrieval":
        c = dims["n_candidates"] // dp
        if arch_id == "two-tower-retrieval":
            return [1] + [c] * dp  # the user tower once, then each shard's item tower
        if arch_id == "din":
            return [c] * dp
        return [1] * cfg.n_blocks  # the user state once; the candidates have no dense layer
    b = dims["batch"] // dp
    per_shard = {"two-tower-retrieval": 2, "din": 1}.get(arch_id) or cfg.n_blocks
    calls = [b] * per_shard * dp
    return calls * 2 if kind == "train" else calls  # train: two steps


def _assert_outputs(got, want, kind, tol, what):
    """Train: losses and grad norms within rtol ``tol``; else the outputs
    within rtol and atol ``tol``, top-k ids equal where not tied."""
    if kind == "train":
        np.testing.assert_allclose(got[0], want[0], rtol=tol, err_msg=what)
        return
    np.testing.assert_allclose(got[0], want[0], rtol=tol, atol=tol, err_msg=what)
    if len(want) == 2:  # top-k ids: equal where the scores are not tied
        untied = np.abs(np.diff(want[0][0])) > tol
        untied = np.concatenate([untied, [True]]) & np.concatenate([[True], untied])
        np.testing.assert_array_equal(got[1][0][untied], want[1][0][untied], err_msg=what)


def test_batch_the_data_shards_do_not_divide_stays_unsplit(monkeypatch):
    """The reference's rule: a batch the data shards do not divide is not
    split; the step runs it once on the lead device and gives the (1, 1)
    step's outputs."""
    _, port = _archs("din")
    port = replace(port, shapes={"s": replace(port.shapes["serve_p99"], dims={"batch": 6})})
    built = tsteps.build_step(port, "s", cpu_mesh((4, 1)))
    assert built.meta["split"] is None
    params, batch = tsteps.materialize_inputs(port, "s", built, seed=2)
    rows = _dense_rows(monkeypatch)
    got = built.fn(params, batch)
    assert rows == [6]
    one = tsteps.build_step(port, "s", cpu_mesh((1, 1)))
    assert torch.equal(got, one.fn(params, batch))


# -- replicas placed by hand ------------------------------------------------------------
def _replicated(params, mesh, names):
    """Every table once per (data shard, model shard), every other leaf once
    per data shard, copies of ``params``."""
    grid = mesh.grid()

    def leaf(name, x):
        if isinstance(x, dict):
            return {k: leaf(name, v) for k, v in x.items()}
        if name in names:
            return Sharded.split(x.full(), grid, (None, 0))
        return Sharded.split(x.clone(), grid[:, :1], (None, None))

    return {k: leaf(k, v) for k, v in params.items()}


def _rows_equal(tree) -> bool:
    """Every replica row of every replicated leaf equal to the first to the
    bit."""
    if isinstance(tree, dict):
        return all(_rows_equal(v) for v in tree.values())
    if not isinstance(tree, Sharded):
        return True
    rows, cols = tree.grid
    return all(torch.equal(tree.block(i, j), tree.block(0, j))
               for i in range(1, rows) for j in range(cols))


def _first_rows(tree) -> list:
    return tree_leaves(tree, replicas=False)


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=_tag)
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_replicas_stay_equal_to_the_bit(monkeypatch, arch_id, mesh):
    """Three train steps on replicas placed by hand against the same steps
    on ``place_params``' placement (one copy: the mesh's devices are one):
    replicas equal after every step, losses, grad norms and parameters
    equal to the bit, a replay equal in every leaf, no placed block
    copied."""
    _, port = _archs(arch_id)
    mesh = cpu_mesh(mesh)
    built = tsteps.build_step(port, "train_batch", mesh)
    names = built.meta["sharded_tables"]
    params, _, batch = tsteps.materialize_inputs(port, "train_batch", built, seed=4)

    def runs(placed):
        opt, out = init_opt_state(placed), []
        for _ in range(REPLICA_STEPS):
            placed, opt, m = built.fn(placed, opt, batch)
            assert _rows_equal(placed) and _rows_equal(opt["mu"]) and _rows_equal(opt["nu"])
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, placed, opt

    state, first = (_replicated(params, mesh, names) for _ in range(2))
    want, want_p, _ = runs(params)
    placed_blocks = {b.data_ptr() for b in tree_leaves(state)}
    copied = []
    for mod in (embedding, recsys):
        orig = mod.replicate
        monkeypatch.setattr(mod, "replicate", lambda x, devices, orig=orig: (
            copied.append(x.data_ptr()), orig(x, devices))[1])
    got, got_p, got_o = runs(state)
    assert not [p for p in copied if p in placed_blocks]  # no placed block copied
    assert got == want  # every replicated leaf counted once in the norm
    assert all(torch.equal(a, b) for a, b in zip(_first_rows(got_p), tree_leaves(want_p)))
    again, again_p, again_o = runs(first)
    assert again == got
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((again_p, again_o)),
                                                  tree_leaves((got_p, got_o))))


@pytest.mark.parametrize("chunk", [1 << 24, 2], ids=["whole", "chunked"])
def test_all_reduce_adds_each_slice_in_shard_order(monkeypatch, chunk):
    """Each replica's slice of the rows is added over the replicas in shard
    order (float32, where the order shows), in place, and every replica
    gets the same bits, whether a slice is received whole or in chunks;
    the copies are 1/n of the rows a replica a half."""
    monkeypatch.setattr(parallel, "RECEIVE_CHUNK", chunk)
    n = 3
    big = torch.tensor(2.0 ** 24)
    xs = [torch.full((5, 2), v) for v in (big, torch.tensor(1.0), -big)]
    xs[1][4] = 3.0
    want = (xs[0] + xs[1]) + xs[2]
    assert not torch.equal(want, xs[0] + (xs[1] + xs[2]))  # the order shows
    given = [x.clone() for x in xs]
    with copy_record() as rec:
        got = all_reduce(given)
    assert len(got) == n and all(torch.equal(g, want) for g in got)
    assert all(g is x for g, x in zip(got, given))  # summed in place
    total = want.numel() * 4
    assert rec.bytes == {"reduce-scatter": (n - 1) * total, "all-gather": (n - 1) * total}
    assert rec.count == 2 * n * (n - 1)


def test_all_reduce_copies_a_replica_it_cannot_write():
    """A replica that shares another's storage, or that is not contiguous
    (an expanded gradient), is summed in a copy of its own; the rest in
    place."""
    x = torch.arange(6.0).reshape(3, 2)
    e = torch.ones(2).expand(3, 2)
    want = (x + x) + e
    got = all_reduce([x, x, e])
    assert all(torch.equal(g, want) for g in got)
    assert got[0] is x and got[1] is not x and got[2] is not e
    assert torch.equal(e, torch.ones(3, 2))


def test_checkpoint_restores_every_replica(tmp_path):
    """A checkpoint of a replicated tree holds each leaf once and restores
    it into every replica of the example's placement."""
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    mesh = cpu_mesh((2, 2))
    x = torch.arange(24.0).reshape(8, 3)
    tree = {"emb": Sharded.split(x, mesh.grid(), (None, 0)),
            "w": Sharded.split(x[:2], mesh.grid()[:, :1], (None, None))}
    save_checkpoint(tmp_path, 1, tree)
    example = {"emb": Sharded.split(torch.zeros(8, 3), mesh.grid(), (None, 0)),
               "w": Sharded.split(torch.zeros(2, 3), mesh.grid()[:, :1], (None, None))}
    got, _ = restore_checkpoint(tmp_path, example)
    assert got["emb"].grid == (2, 2) and got["w"].grid == (2, 1)
    assert all(torch.equal(got["emb"].block(d, r), x[4 * r:4 * r + 4])
               for d in range(2) for r in range(2))
    assert all(torch.equal(got["w"].block(d, 0), x[:2]) for d in range(2))


# -- the dry run on 16x16 -------------------------------------------------------------
def test_twotower_train_copies_no_table_on_16x16():
    """two-tower-retrieval's train_batch on the 16x16 mesh of ``meta``: each
    table block and tower held once per data shard, the step broadcasts no
    table (its broadcast is the lookups' ``sum_to_lead`` backward, equal
    to their all-reduce) and reduces none; each table's gradient is
    reduce-scattered and all-gathered once over its 16 replicas, 15/16 of
    a block a device each way, beside the towers' gradients and the item
    vectors (and log Q) gathered onto every data shard; the mean device's
    peak under the card's 76 GB."""
    arch = get_arch("two-tower-retrieval")
    cfg, B = arch.model_cfg, arch.shapes["train_batch"].dims["batch"]
    dp = tp = 16
    n_dev, f32 = dp * tp, 4
    rec = dryrun.run_cell(arch, "train_batch", False,
                          mesh=make_mesh((dp, tp), AXES, devices=["meta"] * (dp * tp)))
    once = rec["collectives"]["once_bytes"]
    assert "reduce" not in once and once["broadcast"] == once["all-reduce"]
    blocks = (cfg.n_items + cfg.n_cates) // tp * cfg.embed_dim * f32  # a shard's two blocks
    assert blocks == 646_400_000
    assert once["broadcast"] < blocks // 10
    tables = (dp - 1) * blocks // dp  # a device's share, each way
    init = recsys.twotower_init(cfg, device="meta")
    towers = sum(x.numel() for k, t in init.items() if k.endswith("tower")
                 for x in tree_leaves(t)) * f32
    vectors = B * cfg.tower[-1] * f32  # each data shard gathers every item vector
    # over the mesh, n - 1 copies of each replicated or gathered whole
    mesh_total = (dp - 1) * ((cfg.n_items + cfg.n_cates) * cfg.embed_dim * f32 + towers + vectors)
    assert once["reduce-scatter"] == int(mesh_total / n_dev)
    assert once["all-gather"] == int((mesh_total + (dp - 1) * B * f32) / n_dev)  # and log Q
    assert 2 * tables == 1_212_000_000
    assert 0 < once["reduce-scatter"] - tables < 5e6  # the towers' and item vectors' share
    assert rec["memory"]["peak_per_device_gib"] * 2**30 < CARD_BYTES


# -- every arch and kind against the reference (waits for its script) ----------------
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_recsys_step_is_data_parallel(reference, monkeypatch, arch_id, kind, mesh):
    """Each data shard's dense layers take its own rows; the outputs match
    the reference's built step on the same mesh shape and the port's
    (1, 1) step."""
    _INPUTS.setdefault((arch_id, kind), _inputs(reference, arch_id, kind))
    own = _one_device(arch_id, kind)
    rows = _dense_rows(monkeypatch)
    got, built = _run(arch_id, kind, cpu_mesh(mesh), *_INPUTS[arch_id, kind])
    dp = mesh[0]
    assert built.meta["split"] == ("candidates" if kind == "retrieval" else "rows")
    assert rows == _want_rows(arch_id, kind, dp)
    want = tuple(reference[_key(arch_id, kind, _tag(mesh), j)] for j in range(len(got)))
    _assert_outputs(got, want, kind, RECSYS_TOL, f"{arch_id} {kind} {mesh}: the reference")
    _assert_outputs(got, own, kind, OWN_TOL, f"{arch_id} {kind} {mesh}: the port's (1, 1)")


if __name__ == "__main__":
    reference_main(sys.argv[1])
