"""The multi-device model paths: the port's row-sharded tables, expert
parallelism, edge-sharded EGNN, compressed all-reduce means and sharded
built train steps on CPU meshes, against the reference's ``shard_map``s on
forced host devices and against the port's own unsharded results.

The reference needs several JAX devices, which a process fixes when it
first imports JAX, so the module fixture runs this file as a script in a
subprocess with eight forced host devices; the script writes the
reference's outputs to an ``.npz``. Both sides draw the same inputs from
numpy seeds and the same weights from the reference's init (JAX keys,
carried to the port with ``carry_params``). The port runs in the test
process on ``["cpu"] * n`` meshes at (1, 2), (1, 4) and (2, 2):

* ``sharded_embedding_lookup``: bitwise (each id has one owner; ids past
  the table give zeros, as the reference's sharded lookup does), and
  bitwise the port's unsharded lookup on ids inside the table;
* ``sharded_embedding_bag``, weighted and unweighted, 50 terms a bag:
  rtol 1e-5, atol 1e-5 (float32 sums in other orders);
* the four recsys archs' serve scores and train losses, din's and
  two-tower's retrieval (top-k ids equal where scores are not tied):
  rtol 1e-5, atol 1e-5 (``tests/test_torch_recsys.py``);
* ``moe_block`` with tp 2 and 4, float32 (rtol/atol 1e-4, aux 1e-6,
  ``tests/test_torch_lm.py``'s block tolerances) and bf16 (cosine
  >= 0.995, ``tests/test_torch_lm.py``'s bf16 floor);
* the edge-sharded EGNN's forward, loss and gradients: rtol 1e-4, atol
  1e-5 (``tests/test_torch_gnn.py``);
* ``int8_allreduce_mean`` without a generator: equal to the reference's
  compiled ``key=None`` path (XLA fuses each rank's dequantize into the
  mean's add, one rounding each); ``topk_allreduce_mean``: values and
  error state;
* the reduced two-tower and EGNN built train steps, two steps each, over
  each mesh: loss and grad norm within rtol 1e-5
  (``tests/test_torch_train_steps.py``) of the reference's step over a
  (2, 2) mesh, and of the port's unsharded step.

The reference's weights are drawn once, on its side, and read back from
its ``.npz``.

Also the collectives' explicit backward (``replicate``/``sum_to_lead``/
``split_rows``) and the guards the reference keeps.
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
import jax.numpy as jnp  # noqa: E402

from repro.configs.gnn_archs import EGNN_ARCH as REF_EGNN_ARCH  # noqa: E402
from repro.configs.recsys_archs import RECSYS_ARCHS as REF_RECSYS_ARCHS  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_mesh as jax_mesh  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import recsys as jr  # noqa: E402
from repro_torch.configs.gnn_archs import EGNN_ARCH  # noqa: E402
from repro_torch.configs.recsys_archs import RECSYS_ARCHS  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import carry_params, tree_leaves, value_and_grad  # noqa: E402
from repro_torch.models import embedding as temb  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import recsys as tr  # noqa: E402
from repro_torch.parallel import MeshPlan, Sharded, replicate, split_rows, sum_to_lead  # noqa: E402
from repro_torch.train import grad_compression as tgc  # noqa: E402

MESHES = ((1, 2), (1, 4), (2, 2))
AXES = ("data", "model")
RECSYS_IDS = ("bert4rec", "sasrec", "din", "two-tower-retrieval")
INITS = {"bert4rec": "seqrec", "sasrec": "seqrec", "din": "din", "two-tower-retrieval": "twotower"}
SERVE = {"seqrec": "seqrec_score", "din": "din_forward", "twotower": "twotower_score"}
LOSS = {"seqrec": "seqrec_loss", "din": "din_loss", "twotower": "twotower_loss"}
RETRIEVE = {"din": "din_retrieval", "two-tower-retrieval": "twotower_retrieve"}
V, D, S = 64, 8, 50  # the bag's table and terms
B, C, K = 8, 256, 20  # recsys batch, retrieval candidates, top-k
RECSYS_TOL = 1e-5
GNN_RTOL, GNN_ATOL = 1e-4, 1e-5
MOE_TOL, AUX_TOL, COS_BF16 = 1e-4, 1e-6, 0.995
STEP_RTOL = 1e-5
TOPK = 5
STEPS = {"two-tower-retrieval": "train_batch", "egnn": "full_graph_sm"}
STEP_MESH = (2, 2)  # the reference's built steps run once, over data and model shards
EDGE_ARGS = ("feats", "coords", "src", "dst", "edge_mask")
REF_TIMEOUT_S = 600


def _key(*parts) -> str:
    return "/".join(str(p) for p in parts)


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


# -- inputs, drawn the same on both sides --------------------------------------------
def table_inputs():
    rng = np.random.default_rng(7)
    table = rng.normal(size=(V, D)).astype(np.float32)
    look = rng.integers(-1, V + 8, (B, 6)).astype(np.int32)  # -1 pads, some past the table
    bag = rng.integers(0, V, (B, S)).astype(np.int32)
    bag[rng.random((B, S)) < 0.2] = -1
    weights = rng.uniform(0.5, 1.5, (B, S)).astype(np.float32)
    return table, look, bag, weights


def recsys_cfg(arch_id):
    return next(a for a in REF_RECSYS_ARCHS if a.arch_id == arch_id).reduced().model_cfg


def recsys_batches(arch_id, cfg):
    """(serve, train, retrieval) batches of numpy arrays; histories padded
    with -1 after a random length of at least one."""
    rng = np.random.default_rng(len(arch_id) + 1)

    def hist(n, L, hi):
        h = rng.integers(0, hi, (n, L)).astype(np.int32)
        for row, cut in zip(h, rng.integers(1, L + 1, n)):
            row[cut:] = -1
        return h

    ints = lambda hi, *s: rng.integers(0, hi, s).astype(np.int32)  # noqa: E731
    floats = lambda *s: rng.normal(0, 0.5, s).astype(np.float32)  # noqa: E731
    kind = INITS[arch_id]
    if kind == "seqrec":
        serve = {"hist": hist(B, cfg.seq_len, cfg.n_items), "candidates": ints(cfg.n_items, B, 100)}
        train = {"hist": hist(B, cfg.seq_len, cfg.n_items), "target": ints(cfg.n_items, B),
                 "negatives": ints(cfg.n_items, B, 16)}
        return serve, train, None
    if kind == "din":
        def rows(n):
            return {"hist_items": hist(n, cfg.seq_len, cfg.n_items),
                    "hist_cates": ints(cfg.n_cates, n, cfg.seq_len),
                    "target_item": ints(cfg.n_items, n), "target_cate": ints(cfg.n_cates, n),
                    "user_feats": floats(n, cfg.d_user)}
        serve, train = rows(B), dict(rows(B), labels=(rng.random(B) < 0.5).astype(np.float32))
        retr = {"hist_items": hist(1, cfg.seq_len, cfg.n_items),
                "hist_cates": ints(cfg.n_cates, 1, cfg.seq_len), "cand_items": ints(cfg.n_items, C),
                "cand_cates": ints(cfg.n_cates, C), "user_feats": floats(1, cfg.d_user)}
        return serve, train, retr
    serve = {"hist": hist(B, cfg.hist_len, cfg.n_items), "user_feats": floats(B, cfg.d_user),
             "item": ints(cfg.n_items, B), "cate": ints(cfg.n_cates, B)}
    train = dict(serve, log_q=floats(B))
    retr = {"hist": hist(1, cfg.hist_len, cfg.n_items), "user_feats": floats(1, cfg.d_user),
            "cand_items": ints(cfg.n_items, C), "cand_cates": ints(cfg.n_cates, C)}
    return serve, train, retr


def moe_inputs():
    return np.random.default_rng(5).normal(0, 1.0, (2, 8, 16)).astype(np.float32)


def gnn_cfg():
    ref = REF_EGNN_ARCH.reduced()
    return replace(ref.model_cfg, d_feat=ref.shapes["full_graph_sm"].dims["d_feat"])


def gnn_inputs():
    dims = REF_EGNN_ARCH.reduced().shapes["full_graph_sm"].dims
    rng = np.random.default_rng(11)
    N, E = dims["n_nodes"], 64  # E divides every mesh
    mask = np.ones(E, np.float32)
    mask[3 * E // 4:] = 0.0  # padding edges, src = dst = 0, in the last shards
    src = (rng.integers(0, N, E) * (mask > 0)).astype(np.int32)
    dst = (rng.integers(0, N, E) * (mask > 0)).astype(np.int32)
    batch = {"feats": rng.normal(size=(N, dims["d_feat"])).astype(np.float32),
             "coords": rng.normal(size=(N, 3)).astype(np.float32),
             "src": src, "dst": dst, "edge_mask": mask,
             "node_mask": (rng.random(N) < 0.8).astype(np.float32),
             "targets": rng.normal(size=N).astype(np.float32)}
    return batch


# The reference's weights, drawn once with JAX keys on the reference side and
# read back from its .npz here (the tree's layout from ``jax.eval_shape``).
MOE_CFG = jmoe.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=1.25)
INIT_FNS = {
    **{a: (lambda a=a: getattr(jr, f"{INITS[a]}_init")(recsys_cfg(a), jax.random.key(len(a))))
       for a in RECSYS_IDS},
    "egnn": lambda: jgnn.init_params(gnn_cfg(), jax.random.key(3)),
    "moe": lambda: jmoe.init_moe(jax.random.key(3), 16, MOE_CFG),
}


def init_and_save(out, name):
    params = INIT_FNS[name]()
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[_key("init", name, i)] = np.asarray(leaf)
    return params


def saved_init(reference, name):
    treedef = jax.tree.structure(jax.eval_shape(INIT_FNS[name]))
    return jax.tree.unflatten(treedef, [reference[_key("init", name, i)]
                                        for i in range(treedef.num_leaves)])


def allreduce_inputs(n):
    rng = np.random.default_rng(n)
    return (rng.normal(size=(n * 4, 16)).astype(np.float32),
            rng.normal(0, 0.1, (n * 4, 16)).astype(np.float32))


def step_archs(name):
    if name == "egnn":
        return REF_EGNN_ARCH.reduced(), EGNN_ARCH.reduced()
    return (next(a for a in REF_RECSYS_ARCHS if a.arch_id == name).reduced(),
            next(a for a in RECSYS_ARCHS if a.arch_id == name).reduced())


# -- the reference side (run as a script with eight host devices) -----------------
def reference_main(path: str) -> None:
    from jax.sharding import PartitionSpec as P

    from repro.models import embedding as jemb
    from repro.train import grad_compression as jgc
    from repro.kernels.common import shard_map_compat as shard_map

    assert len(jax.devices()) == 8, jax.devices()
    out = {}
    table, look, bag, weights = table_inputs()
    recsys = {a: (recsys_cfg(a), init_and_save(out, a), recsys_batches(a, recsys_cfg(a)))
              for a in RECSYS_IDS}
    gcfg, gparams, gbatch = gnn_cfg(), init_and_save(out, "egnn"), gnn_inputs()
    moe_params, x_moe = init_and_save(out, "moe"), moe_inputs()
    for shape in MESHES:
        mesh = jax_mesh(shape, AXES)
        t = _tag(shape)
        outs = jax.jit(lambda a, i, b, w: (
            jemb.sharded_embedding_lookup(a, i, mesh), jemb.sharded_embedding_bag(a, b, mesh),
            jemb.sharded_embedding_bag(a, b, mesh, w)))(table, look, bag, weights)
        for name, v in zip(("lookup", "bag", "bag_w"), outs):
            out[_key(name, t)] = np.asarray(v)
        cand = P(("data",)) if shape[0] > 1 else P()
        for arch_id, (cfg, params, (serve, train, retr)) in recsys.items():
            kind = INITS[arch_id]

            def run(p, sb, tb, rb, cfg=cfg, kind=kind, arch_id=arch_id):
                res = (getattr(jr, SERVE[kind])(cfg, p, sb, mesh, ("data",)),
                       getattr(jr, LOSS[kind])(cfg, p, tb, mesh, ("data",)))
                if rb is None:
                    return res
                return (*res, *getattr(jr, RETRIEVE[arch_id])(cfg, p, rb, K, mesh, (),
                                                              cand_pspec=cand))
            res = jax.jit(run)(params, serve, train, retr)
            for name, v in zip(("serve", "loss", "retr_vals", "retr_ids"), res):
                out[_key(name, arch_id, t)] = np.asarray(v)
        for dtype in ("float32", "bfloat16"):
            dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
            y, aux = jax.jit(lambda p, x: jmoe.moe_block(
                p, x, cfg=MOE_CFG, mesh=mesh, dp_axes=("data",)))(
                jax.tree.map(lambda a: jnp.asarray(a, dt), moe_params), jnp.asarray(x_moe, dt))
            out[_key("moe", dtype, t, "y")] = np.asarray(y, np.float32)
            out[_key("moe", dtype, t, "aux")] = np.asarray(aux, np.float32)
        fwd, (loss, grads) = jax.jit(lambda p, b: (
            jgnn.forward(gcfg, p, *(b[k] for k in EDGE_ARGS), mesh=mesh, edge_axes=AXES),
            jax.value_and_grad(lambda p: jgnn.loss_fn(gcfg, p, b, mesh=mesh,
                                                      edge_axes=AXES))(p)))(gparams, gbatch)
        for name, v in zip(("h", "coords", "energy"), fwd):
            out[_key("gnn", t, name)] = np.asarray(v)
        out[_key("gnn", t, "loss")] = np.asarray(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[_key("gnn", t, "grad", i)] = np.asarray(g)
        x, err = allreduce_inputs(shape[0] * shape[1])
        spec = P(AXES)
        res = jax.jit(shard_map(
            lambda v, e: (jgc.int8_allreduce_mean(v, AXES),
                          *jgc.topk_allreduce_mean(v, e, TOPK, AXES)), mesh=mesh,
            in_specs=(spec, spec), out_specs=(P(), P(), spec)))(x, err)
        for name, v in zip(("int8", "topk", "topk_err"), res):
            out[_key(name, t)] = np.asarray(v)
    for name, shape_name in STEPS.items():
        ref, _ = step_archs(name)
        jbuilt = jsteps.build_step(ref, shape_name, jax_mesh(STEP_MESH, AXES))
        jp, jo, batch = jsteps.materialize_inputs(ref, shape_name, jbuilt, seed=1)
        for i in range(2):
            jp, jo, m = jbuilt.fn(jp, jo, batch)
            out[_key("step", name, i)] = np.array([float(m["loss"]), float(m["grad_norm"])])
    np.savez(path, **out)


# -- the port side -----------------------------------------------------------------
def cpu_mesh(shape):
    return make_mesh(shape, AXES, devices=["cpu"] * int(np.prod(shape)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _carry(params):
    return carry_params(jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("multidevice") / "reference.npz"
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
def recsys_models(reference):
    return {a: (recsys_cfg(a), _carry(saved_init(reference, a)), recsys_batches(a, recsys_cfg(a)))
            for a in RECSYS_IDS}


MESH_IDS = [_tag(s) for s in MESHES]


# -- embeddings ---------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_sharded_lookup_is_bitwise(reference, shape):
    table, look, _, _ = table_inputs()
    got = temb.sharded_embedding_lookup(_t(table), _t(look), cpu_mesh(shape))
    np.testing.assert_array_equal(got.numpy(), reference[_key("lookup", _tag(shape))])
    inside = look < V
    want = temb.embedding_lookup(_t(table), _t(np.where(inside, look, 0))).numpy()
    np.testing.assert_array_equal(got.numpy()[inside], want[inside])
    assert not got.numpy()[look >= V].any()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_sharded_bag(reference, shape, weighted):
    table, _, bag, weights = table_inputs()
    w = _t(weights) if weighted else None
    got = temb.sharded_embedding_bag(_t(table), _t(bag), cpu_mesh(shape), w)
    want = reference[_key("bag_w" if weighted else "bag", _tag(shape))]
    np.testing.assert_allclose(got.numpy(), want, rtol=RECSYS_TOL, atol=RECSYS_TOL)
    own = temb.embedding_bag_sum(_t(table), _t(bag), w)
    np.testing.assert_allclose(got.numpy(), own.numpy(), rtol=RECSYS_TOL, atol=RECSYS_TOL)


def test_sharded_bag_gradient_is_the_unsharded_one():
    """Each shard's backward fills its own rows: the table's gradient
    through the shards equals the unsharded bag's to the bit (every row
    has one owner, and its terms come in (b, s) order in both)."""
    table, _, bag, weights = table_inputs()
    g_out = torch.from_numpy(np.random.default_rng(1).normal(size=(B, D)).astype(np.float32))
    grads = []
    for mesh in (None, cpu_mesh((1, 4))):
        t = _t(table).requires_grad_(True)
        out = (temb.embedding_bag_sum(t, _t(bag), _t(weights)) if mesh is None
               else temb.sharded_embedding_bag(t, _t(bag), mesh, _t(weights)))
        (out * g_out).sum().backward()
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])


def test_sharded_bag_keeps_the_reference_guards():
    table, _, bag, _ = table_inputs()
    mesh = cpu_mesh((1, 2))
    with pytest.raises(ValueError, match="split over 2"):
        temb.sharded_embedding_bag(_t(table[:63]), _t(bag), mesh)
    with pytest.raises(ValueError, match="'model'"):
        temb.sharded_embedding_lookup(_t(table), _t(bag), mesh, ids_pspec=("model", None))


def test_sharded_rows_are_views_on_one_device():
    table = torch.arange(32.0).reshape(8, 4)
    rows = Sharded.of(table, ["cpu"] * 4)
    assert rows.shape == (8, 4) and rows.rows_per_shard == 2
    assert all(s.data_ptr() == table[2 * i:].data_ptr() for i, s in enumerate(rows.shards))
    assert torch.equal(torch.cat(rows.shards), table)


# -- recsys -------------------------------------------------------------------------
def _batch_t(b):
    return {k: _t(v) for k, v in b.items()}


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_sharded_recsys_score_and_loss(reference, recsys_models, arch_id, shape):
    cfg, pp, (serve, train, _) = recsys_models[arch_id]
    kind, mesh, t = INITS[arch_id], cpu_mesh(shape), _tag(shape)
    got = getattr(tr, SERVE[kind])(cfg, pp, _batch_t(serve), mesh, ("data",))
    np.testing.assert_allclose(_np(got), reference[_key("serve", arch_id, t)],
                               rtol=RECSYS_TOL, atol=RECSYS_TOL)
    own = getattr(tr, SERVE[kind])(cfg, pp, _batch_t(serve))
    np.testing.assert_allclose(_np(got), _np(own), rtol=RECSYS_TOL, atol=RECSYS_TOL)
    loss = getattr(tr, LOSS[kind])(cfg, pp, _batch_t(train), mesh, ("data",))
    np.testing.assert_allclose(_np(loss), reference[_key("loss", arch_id, t)],
                               rtol=RECSYS_TOL, atol=RECSYS_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch_id", sorted(RETRIEVE))
def test_sharded_retrieval(reference, recsys_models, arch_id, shape):
    """Candidates split over the data axis where it is larger than 1 (the
    reference's ``cand_pspec``): top-k ids equal where scores are not tied."""
    cfg, pp, (_, _, retr) = recsys_models[arch_id]
    cand = (("data",),) if shape[0] > 1 else ()
    vals, ids = getattr(tr, RETRIEVE[arch_id])(cfg, pp, _batch_t(retr), K, cpu_mesh(shape), (),
                                              cand_pspec=cand)
    t = _tag(shape)
    want_v, want_i = reference[_key("retr_vals", arch_id, t)], \
        reference[_key("retr_ids", arch_id, t)]
    np.testing.assert_allclose(_np(vals), want_v, rtol=RECSYS_TOL, atol=RECSYS_TOL)
    untied = np.abs(np.diff(want_v[0])) > RECSYS_TOL
    untied = np.concatenate([untied, [True]]) & np.concatenate([[True], untied])
    np.testing.assert_array_equal(ids.numpy()[0][untied], want_i[0][untied])


# -- MoE ------------------------------------------------------------------------------
def _moe_over(p, x, cfg, mesh):
    """``moe_block`` over ``mesh``'s plan, the batch split over its data
    shards as a transformer layer hands it over -> (y, aux)."""
    plan = MeshPlan(mesh, ("data",))
    ys, aux = tmoe.moe_block(p, plan.split_batch(x), cfg=cfg, plan=plan)
    return torch.cat(ys), aux


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_expert_parallel_moe_block(reference, shape, dtype):
    cfg, x = tmoe.MoEConfig(**vars(MOE_CFG)), moe_inputs()
    tdt = getattr(torch, dtype)
    tp = carry_params(jax.tree.map(np.asarray, saved_init(reference, "moe")), device="cpu",
                      dtype=tdt)
    y, aux = _moe_over(tp, _t(x).to(tdt), cfg, cpu_mesh(shape))
    t = _tag(shape)
    want_y, want_aux = reference[_key("moe", dtype, t, "y")], reference[_key("moe", dtype, t, "aux")]
    own, _ = _moe_over(tp, _t(x).to(tdt), cfg, cpu_mesh((shape[0], 1)))
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), want_y, rtol=MOE_TOL, atol=MOE_TOL)
        np.testing.assert_allclose(_np(aux), want_aux, rtol=AUX_TOL, atol=AUX_TOL)
        np.testing.assert_allclose(_np(y), _np(own), rtol=MOE_TOL, atol=MOE_TOL)
    else:
        for other in (want_y, _np(own)):
            a, b = _np(y).ravel().astype(np.float64), other.ravel().astype(np.float64)
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= COS_BF16
        np.testing.assert_allclose(_np(aux), want_aux, rtol=1e-2)


# -- EGNN -------------------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_edge_sharded_egnn(reference, shape):
    cfg = tgnn.EGNNConfig(**vars(gnn_cfg()))
    pp, tb = _carry(saved_init(reference, "egnn")), {k: _t(v) for k, v in gnn_inputs().items()}
    mesh, t = cpu_mesh(shape), _tag(shape)
    args = [tb[k] for k in EDGE_ARGS]
    got = tgnn.forward(cfg, pp, *args, mesh=mesh, edge_axes=AXES)
    own = tgnn.forward(cfg, pp, *args)
    for name, g, o in zip(("h", "coords", "energy"), got, own):
        np.testing.assert_allclose(_np(g), reference[_key("gnn", t, name)], rtol=GNN_RTOL,
                                   atol=GNN_ATOL, err_msg=name)
        np.testing.assert_allclose(_np(g), _np(o), rtol=GNN_RTOL, atol=GNN_ATOL, err_msg=name)
    loss, grads = value_and_grad(
        lambda p: tgnn.loss_fn(cfg, p, tb, mesh=mesh, edge_axes=AXES), pp)
    np.testing.assert_allclose(_np(loss), reference[_key("gnn", t, "loss")], rtol=GNN_RTOL,
                               atol=GNN_ATOL)
    for i, g in enumerate(tree_leaves(grads)):
        np.testing.assert_allclose(_np(g), reference[_key("gnn", t, "grad", i)], rtol=GNN_RTOL,
                                   atol=GNN_ATOL, err_msg=f"grad leaf {i}")


def test_egnn_edges_must_split_over_the_mesh(reference):
    tb = {k: _t(v)[:-2] if k in ("src", "dst", "edge_mask") else _t(v)
          for k, v in gnn_inputs().items()}
    with pytest.raises(ValueError, match="do not split over 4"):
        tgnn.loss_fn(tgnn.EGNNConfig(**vars(gnn_cfg())), _carry(saved_init(reference, "egnn")),
                     tb, mesh=cpu_mesh((1, 4)), edge_axes=AXES)


# -- compressed all-reduce means -----------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_int8_allreduce_mean_is_the_reference(reference, shape):
    n = shape[0] * shape[1]
    x, _ = allreduce_inputs(n)
    got = tgc.int8_allreduce_mean(list(_t(x).chunk(n)), "cpu")
    np.testing.assert_array_equal(got.numpy(), reference[_key("int8", _tag(shape))])


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_topk_allreduce_mean_is_the_reference(reference, shape):
    n = shape[0] * shape[1]
    x, err = allreduce_inputs(n)
    mean, errs = tgc.topk_allreduce_mean(list(_t(x).chunk(n)), list(_t(err).chunk(n)), TOPK,
                                         "cpu")
    t = _tag(shape)
    np.testing.assert_array_equal(mean.numpy(), reference[_key("topk", t)])
    np.testing.assert_array_equal(torch.cat(errs).numpy(), reference[_key("topk_err", t)])


# -- built train steps ---------------------------------------------------------------------
@functools.cache
def _step_inputs(name):
    """The reference's (params, opt state, batch) for ``name``'s step: JAX
    arrays, which ``_carry`` copies, so a step's in-place update leaves
    them as they are."""
    ref, _ = step_archs(name)
    jbuilt = jsteps.build_step(ref, STEPS[name], jax_mesh((1, 1), AXES))
    return jsteps.materialize_inputs(ref, STEPS[name], jbuilt, seed=1)


def _port_steps(name, mesh):
    _, port = step_archs(name)
    p, o, batch = (_carry(a) for a in _step_inputs(name))
    built = tsteps.build_step(port, STEPS[name], mesh)
    p = tsteps.place_params(built, p)
    o = {"mu": tsteps.place_params(built, o["mu"]), "nu": tsteps.place_params(built, o["nu"]),
         "step": o["step"]}
    got = []
    for _ in range(2):
        p, o, m = built.fn(p, o, batch)
        got.append([float(m["loss"]), float(m["grad_norm"])])
    return np.array(got), built, p


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", sorted(STEPS))
def test_sharded_built_train_step(reference, name, shape):
    got, built, params = _port_steps(name, cpu_mesh(shape))
    want = np.stack([reference[_key("step", name, i)] for i in range(2)])
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    own, _, _ = _port_steps(name, cpu_mesh((1, 1)))
    np.testing.assert_allclose(got, own, rtol=STEP_RTOL)
    if name != "egnn":
        assert built.meta["sharded_tables"] == ("item_emb",)
        assert isinstance(params["item_emb"], Sharded)
        assert len(params["item_emb"].shards) == shape[1]


def test_adamw_updates_each_shard_where_it_lives():
    """AdamW over a ``Sharded`` leaf: each shard updated in place (the
    one table's rows on one device) as the whole tensor would be (no
    clipping, whose scale follows the norm's rounding), the global norm
    within rounding of the unsharded one."""
    from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state

    rng = np.random.default_rng(3)
    table, grad = (torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)) for _ in range(2))
    cfg = AdamWConfig(lr=1e-2, grad_clip=1e9)
    full = {"emb": table.clone()}
    full_opt = init_opt_state(full)
    _, _, want_norm = adamw_update(cfg, full, {"emb": grad}, full_opt)
    sharded_table = table.clone()
    params = {"emb": Sharded.of(sharded_table, ["cpu"] * 4)}
    opt = init_opt_state(params)
    _, opt, norm = adamw_update(cfg, params, {"emb": Sharded.of(grad, ["cpu"] * 4)}, opt)
    assert torch.equal(sharded_table, full["emb"])  # the views were written in place
    assert torch.equal(torch.cat(opt["mu"]["emb"].shards), full_opt["mu"]["emb"])
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)


def test_lm_step_runs_experts_over_a_model_axis_of_one_device():
    """granite-moe (reduced) through its built prefill step on a (1, 4)
    mesh of one device: the experts over 4 ranks, the logits within the
    float32 tolerance of the (1, 1) step; and the same over a (1, 2) mesh,
    its attention and vocabulary tensor-parallel too."""
    from repro_torch.configs.lm_archs import LM_ARCHS

    arch = next(a for a in LM_ARCHS if a.arch_id == "granite-moe-1b-a400m").reduced()
    arch = replace(arch, model_cfg=replace(arch.model_cfg, dtype="float32"))
    b1 = tsteps.build_step(arch, "prefill_32k", cpu_mesh((1, 1)))
    b4 = tsteps.build_step(arch, "prefill_32k", cpu_mesh((1, 4)))
    params, tokens = tsteps.materialize_inputs(arch, "prefill_32k", b1, seed=1)
    params = {k: v for k, v in params.items()}
    want, _ = b1.fn(params, tokens)
    got, _ = b4.fn(params, tokens)
    np.testing.assert_allclose(_np(got), _np(want), rtol=MOE_TOL, atol=MOE_TOL)
    b2 = tsteps.build_step(arch, "prefill_32k", cpu_mesh((1, 2)))
    got, _ = b2.fn(tsteps.place_params(b2, params), tokens)
    np.testing.assert_allclose(_np(got), _np(want), rtol=MOE_TOL, atol=MOE_TOL)


# -- the collectives ----------------------------------------------------------------------
def test_collectives_backward_is_explicit():
    """``replicate``'s gradient adds the shards' in shard order, and
    ``sum_to_lead``'s hands each part the sum's; ``split_rows``'s
    concatenates the blocks'."""
    x = torch.arange(6.0, requires_grad=True)
    parts = replicate(x, ["cpu"] * 3)
    total = sum_to_lead([p * (i + 1) for i, p in enumerate(parts)], "cpu")
    total.backward(torch.ones(6))
    assert torch.equal(x.grad, torch.full((6,), 6.0))
    assert torch.equal(total.detach(), x.detach() * 6)
    w = torch.arange(8.0, requires_grad=True)
    blocks = split_rows(w, ["cpu"] * 4)
    assert [tuple(b.shape) for b in blocks] == [(2,)] * 4
    sum((b * i).sum() for i, b in enumerate(blocks)).backward()
    assert torch.equal(w.grad, torch.tensor([0, 0, 1, 1, 2, 2, 3, 3.0]))


if __name__ == "__main__":
    reference_main(sys.argv[1])
