"""The port's recsys serving path against the reference package.

The four recsys models' reduced configs run on the reference's own
weights (``carry_params``) and seeded numpy batches, through the jitted
JAX functions and through the port on the CPU, where the two-tower bag
takes the embedding-bag kernel's plain version. Tolerance: rtol 1e-5,
atol 1e-5 on scores and states (float32 throughout; the two packages add
in different orders); retrieval's top-k ids must be equal. The bag
itself: rtol 1e-6, atol 1e-5 in float32 and 2e-2 in bfloat16, as
``test_torch_embedding_bag.py`` holds the kernel's entry point.

``-m cuda`` holds the two-tower path on a card (the CUDA bag kernel) to
its CPU run; it skips without one. The reference imports are optional so
that the card test can run on a host without JAX; here they are always
present.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.recsys_archs import N_NEG, RECSYS_ARCHS, RECSYS_SHAPES
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import carry_params
from repro_torch.models import embedding as temb
from repro_torch.models import recsys as tr

try:
    import jax
    import jax.numpy as jnp
    from repro.configs.recsys_archs import N_NEG as REF_N_NEG
    from repro.configs.recsys_archs import RECSYS_ARCHS as REF_ARCHS
    from repro.configs.recsys_archs import RECSYS_SHAPES as REF_SHAPES
    from repro.models import embedding as jemb
    from repro.models import recsys as jr
    from repro.launch import steps as jsteps
except ImportError:  # a card host without JAX runs only the card test
    jax = None

RTOL = ATOL = 1e-5
CPU = "cpu"
ARCH_IDS = [a.arch_id for a in RECSYS_ARCHS]
INITS = {"bert4rec": "seqrec", "sasrec": "seqrec", "din": "din", "two-tower-retrieval": "twotower"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.fixture
def ref():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _model(arch_id):
    """Reduced configs and the reference's weights, carried to the port."""
    ref = next(a for a in REF_ARCHS if a.arch_id == arch_id).reduced()
    port = next(a for a in RECSYS_ARCHS if a.arch_id == arch_id).reduced()
    init = getattr(jr, f"{INITS[arch_id]}_init")
    params = init(ref.model_cfg, jax.random.key(len(arch_id)))
    return ref.model_cfg, port.model_cfg, params, carry_params(
        jax.tree.map(np.asarray, params), device=CPU)


def _batch(arch_id, cfg, kind, B, C, seed=0):
    """A serve (B rows) or retrieval (C candidates) batch, histories
    padded with -1 after a random length of at least one."""
    rng = np.random.default_rng(seed)

    def hist(n, S, hi):
        ids = rng.integers(0, hi, (n, S)).astype(np.int32)
        lengths = rng.integers(1, S + 1, n)
        ids[np.arange(S)[None, :] >= lengths[:, None]] = -1
        return ids

    kind_ = INITS[arch_id]
    if kind_ == "seqrec":
        n = B if kind == "serve" else 1
        return {"hist": hist(n, cfg.seq_len, cfg.n_items),
                "candidates": rng.integers(0, cfg.n_items, (n, 100 if kind == "serve" else C))
                .astype(np.int32)}
    if kind_ == "din":
        n = B if kind == "serve" else 1
        h = hist(n, cfg.seq_len, cfg.n_items)
        b = {"hist_items": h, "hist_cates": np.where(h >= 0, rng.integers(
            0, cfg.n_cates, h.shape), -1).astype(np.int32),
             "user_feats": rng.normal(0, 0.5, (n, cfg.d_user)).astype(np.float32)}
        if kind == "serve":
            b["target_item"] = rng.integers(0, cfg.n_items, B).astype(np.int32)
            b["target_cate"] = rng.integers(0, cfg.n_cates, B).astype(np.int32)
        else:
            b["cand_items"] = rng.integers(0, cfg.n_items, C).astype(np.int32)
            b["cand_cates"] = rng.integers(0, cfg.n_cates, C).astype(np.int32)
        return b
    n = B if kind == "serve" else 1
    b = {"hist": hist(n, cfg.hist_len, cfg.n_items),
         "user_feats": rng.normal(0, 0.5, (n, cfg.d_user)).astype(np.float32)}
    if kind == "serve":
        b["item"] = rng.integers(0, cfg.n_items, B).astype(np.int32)
        b["cate"] = rng.integers(0, cfg.n_cates, B).astype(np.int32)
    else:
        b["cand_items"] = rng.integers(0, cfg.n_items, C).astype(np.int32)
        b["cand_cates"] = rng.integers(0, cfg.n_cates, C).astype(np.int32)
    return b


def _both(arch_id, kind, B=8, C=256, seed=0):
    rc, pc, params, pp = _model(arch_id)
    b = _batch(arch_id, rc, kind, B, C, seed)
    return rc, pc, params, pp, {k: jnp.asarray(v) for k, v in b.items()}, \
        {k: _t(v) for k, v in b.items()}


# -- embeddings -------------------------------------------------------------------
def test_embedding_lookup_pads_and_fill(ref):
    table = np.random.default_rng(0).normal(size=(50, 6)).astype(np.float32)
    ids = np.array([[3, -1, 49], [50, 0, 77]], np.int32)  # 50 and 77 are past the table
    want = np.asarray(jax.jit(jemb.embedding_lookup)(jnp.asarray(table), jnp.asarray(ids)))
    got = temb.embedding_lookup(_t(table), _t(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[1, 0]).all() and (got[0, 1] == 0).all()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(9,), (3, 4)])
def test_embedding_bag_sum_with_pads(ref, lead, dtype, weighted):
    rng = np.random.default_rng(len(lead) + weighted)
    S, V, D = 7, 300, 24
    ids = rng.integers(-1, V, lead + (S,)).astype(np.int32)
    ids[..., :2][ids[..., :2] < 0] = 5
    ids.reshape(-1, S)[0] = -1  # an all-pad bag
    table = rng.normal(size=(V, D)).astype(np.float32)
    w = rng.normal(size=ids.shape).astype(np.float32) if weighted else None
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax.jit(jemb.embedding_bag_sum)(jnp.asarray(table, jd), jnp.asarray(ids),
                                           None if w is None else jnp.asarray(w))
    before = embedding_bag.launches
    got = temb.embedding_bag_sum(_t(table).to(getattr(torch, dtype)), _t(ids),
                                 None if w is None else _t(w))
    assert embedding_bag.launches == before  # the CPU runs the plain version
    assert got.shape == lead + (D,) and got.dtype == getattr(torch, dtype)
    tol = (1e-6, 1e-5) if dtype == "float32" else (2e-2, 2e-2)
    _close(got, want, *tol)
    assert (got.reshape(-1, D)[0] == 0).all()


def test_embedding_bag_sum_ignores_ids_past_the_table(ref):
    """The departure: the kernel's rule (an id past the table adds
    nothing) where the reference's ``jnp.take`` fills NaN."""
    table = np.ones((10, 4), np.float32)
    ids = np.array([[1, 2, 10]], np.int32)
    want = np.asarray(jemb.embedding_bag_sum(jnp.asarray(table), jnp.asarray(ids)))
    got = temb.embedding_bag_sum(_t(table), _t(ids)).numpy()
    assert np.isnan(want).all()
    np.testing.assert_array_equal(got, np.full((1, 4), 2.0, np.float32))


# -- models -----------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", ["bert4rec", "sasrec"])
def test_seqrec_serve(ref, arch_id):
    rc, pc, params, pp, jb, tb = _both(arch_id, "serve")
    want_u = jax.jit(functools.partial(jr.seqrec_user_state, rc))(params, jb["hist"])
    _close(tr.seqrec_user_state(pc, pp, tb["hist"]), want_u)
    want = jax.jit(functools.partial(jr.seqrec_score, rc))(params, jb)
    got = tr.seqrec_score(pc, pp, tb)
    assert got.shape == (8, 100)
    _close(got, want)


@pytest.mark.parametrize("arch_id", ["bert4rec", "sasrec"])
def test_seqrec_retrieval_top_k(ref, arch_id):
    rc, pc, params, pp, jb, tb = _both(arch_id, "retrieval")
    want = np.asarray(jax.jit(functools.partial(jr.seqrec_score, rc))(params, jb))
    got = tr.seqrec_score(pc, pp, tb)
    _close(got, want)
    wv, wi = jax.lax.top_k(jnp.asarray(want), 100)
    gv, gi = tr.top_k_scores(got, 100)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gv, wv)


def test_din_serve(ref):
    rc, pc, params, pp, jb, tb = _both("din", "serve")
    want = jax.jit(functools.partial(jr.din_forward, rc))(params, jb)
    got = tr.din_forward(pc, pp, tb)
    assert got.shape == (8,)
    _close(got, want)


def test_din_retrieval(ref):
    rc, pc, params, pp, jb, tb = _both("din", "retrieval")
    wv, wi = jax.jit(functools.partial(jr.din_retrieval, rc, top_k=100))(params, jb)
    gv, gi = tr.din_retrieval(pc, pp, tb, 100)
    assert gi.dtype == torch.int32 and gi.shape == (1, 100)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gv, wv)


def test_twotower_towers_and_score(ref):
    rc, pc, params, pp, jb, tb = _both("two-tower-retrieval", "serve")
    want_u = jax.jit(functools.partial(jr.twotower_user, rc))(params, jb)
    _close(tr.twotower_user(pc, pp, tb), want_u)
    want_v = jax.jit(functools.partial(jr.twotower_item, rc))(params, jb["item"], jb["cate"])
    _close(tr.twotower_item(pc, pp, tb["item"], tb["cate"]), want_v)
    want = jax.jit(functools.partial(jr.twotower_score, rc))(params, jb)
    _close(tr.twotower_score(pc, pp, tb), want)


def test_twotower_retrieve(ref):
    rc, pc, params, pp, jb, tb = _both("two-tower-retrieval", "retrieval")
    wv, wi = jax.jit(functools.partial(jr.twotower_retrieve, rc, top_k=100))(params, jb)
    gv, gi = tr.twotower_retrieve(pc, pp, tb, 100)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gv, wv)


def test_retrieval_ties_keep_the_lower_candidate(ref):
    """Repeated candidates score the same; both packages list them in
    candidate order, as ``lax.top_k`` does."""
    rc, pc, params, pp, jb, tb = _both("two-tower-retrieval", "retrieval")
    for name in ("cand_items", "cand_cates"):
        tb[name][1::2] = tb[name][0::2]
        jb[name] = jnp.asarray(tb[name].numpy())
    wv, wi = jr.twotower_retrieve(rc, params, jb, 20)
    gv, gi = tr.twotower_retrieve(pc, pp, tb, 20)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert (gi.numpy()[0, 0::2] + 1 == gi.numpy()[0, 1::2]).all()


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_sharded_tables_wait_for_the_multi_device_slice(ref, arch_id):
    """Row-sharded tables, once pinned to raise, on a (1, 2) CPU mesh: the
    serve scores against the reference's unsharded ones (each lookup is
    its one owner's row; the two-tower bag adds two shards' partials). The
    reference's own sharded path is in ``tests/test_torch_multidevice.py``."""
    rc, pc, params, pp, jb, tb = _both(arch_id, "serve")
    mesh = make_mesh((1, 2), ("data", "model"), devices=[CPU] * 2)
    name = {"bert4rec": "seqrec_score", "sasrec": "seqrec_score", "din": "din_forward",
            "two-tower-retrieval": "twotower_score"}[arch_id]
    want = jax.jit(functools.partial(getattr(jr, name), rc))(params, jb)
    _close(getattr(tr, name)(pc, pp, tb, mesh), want)


def test_placement_rule_is_the_reference_rule(ref):
    """``recsys.row_sharded`` and the reference's ``_recsys_param_pspecs``
    shard the same tables, full width and reduced, at tp 1 to 16 (the
    reference shards only where tp > 1, its ``table_sharded``)."""

    class ShapeOnly:  # what _recsys_param_pspecs reads of a mesh
        def __init__(self, tp):
            self.shape = {"data": 1, "model": tp}
            self.axis_names = ("data", "model")

    for arch in REF_ARCHS:
        init = getattr(jr, f"{INITS[arch.arch_id]}_init")
        for a in (arch, arch.reduced()):
            abs_params = jax.eval_shape(lambda: init(a.model_cfg, jax.random.key(0)))
            for tp in (1, 2, 4, 16):
                specs = jsteps._recsys_param_pspecs(abs_params, ShapeOnly(tp))
                for name, leaf in abs_params.items():
                    if hasattr(leaf, "shape"):
                        want = tp > 1 and specs[name] == jax.sharding.PartitionSpec("model", None)
                        assert tr.row_sharded(name, leaf.shape, tp) == want, (a.arch_id, name, tp)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_full_width_configs(ref, arch_id):
    ref = next(a for a in REF_ARCHS if a.arch_id == arch_id)
    port = next(a for a in RECSYS_ARCHS if a.arch_id == arch_id)
    assert vars(port.model_cfg) == vars(ref.model_cfg)
    assert port.source == ref.source and port.family == ref.family
    assert {k: v.dims for k, v in port.shapes.items()} == {k: v.dims for k, v in ref.shapes.items()}
    red_p, red_r = port.reduced(), ref.reduced()
    assert vars(red_p.model_cfg) == vars(red_r.model_cfg)
    assert {k: v.dims for k, v in red_p.shapes.items()} == \
        {k: v.dims for k, v in red_r.shapes.items()}
    init = getattr(tr, f"{INITS[arch_id]}_init")
    got = init(red_p.model_cfg, 0, device="meta")
    want = jax.eval_shape(lambda: getattr(jr, f"{INITS[arch_id]}_init")(
        red_r.model_cfg, jax.random.key(0)))
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(lambda s: s.shape, want)
    assert N_NEG == REF_N_NEG
    assert {k: v.dims for k, v in RECSYS_SHAPES.items()} == {k: v.dims for k, v in REF_SHAPES.items()}


def test_carry_params_keeps_names_stacks_and_bits(ref):
    _, _, params, pp = _model("bert4rec")
    host = jax.tree.map(np.asarray, params)
    flat_p = jax.tree_util.tree_leaves_with_path(pp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    flat_h = jax.tree_util.tree_leaves_with_path(host)
    assert [p for p, _ in flat_p] == [p for p, _ in flat_h]
    for (_, got), (_, want) in zip(flat_p, flat_h):
        np.testing.assert_array_equal(got.numpy(), want)
    bf = carry_params(jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), params),
                      device=CPU)
    assert bf["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bf["item_emb"].float().numpy(),
                                  np.asarray(params["item_emb"].astype(jnp.bfloat16), np.float32))


@pytest.mark.cuda
def test_twotower_on_the_card_matches_its_cpu_run_cuda(cuda):
    """The two-tower serve and retrieval steps on a card, the bag through
    csrc/embedding_bag.cu (one launch per user tower), against the port's
    CPU run on the same weights: user vectors bit for bit equal to the
    tower fed by the plain bag on the card, scores within the CPU
    tolerance, top-k ids equal."""
    from repro_torch.kernels.embedding_bag import embedding_bag_plain

    cfg = next(a for a in RECSYS_ARCHS if a.arch_id == "two-tower-retrieval").reduced().model_cfg
    host = tr.twotower_init(cfg, 0, device=CPU)
    pd = _to(host, cuda)
    for kind in ("serve", "retrieval"):
        b = {k: _t(v) for k, v in _batch("two-tower-retrieval", cfg, kind, 64, 512).items()}
        bd = {k: v.to(cuda) for k, v in b.items()}
        before = embedding_bag.launches
        u = tr.twotower_user(cfg, pd, bd)
        assert embedding_bag.launches == before + 1
        hist = embedding_bag_plain(bd["hist"], pd["item_emb"])
        u_plain = tr._tower(pd["user_tower"], torch.cat([hist, bd["user_feats"]], dim=-1))
        assert torch.equal(u, u_plain)
        if kind == "serve":
            _close(tr.twotower_score(cfg, pd, bd).cpu(), tr.twotower_score(cfg, host, b).numpy())
        else:
            gv, gi = tr.twotower_retrieve(cfg, pd, bd, 100)
            wv, wi = tr.twotower_retrieve(cfg, host, b, 100)
            assert torch.equal(gi.cpu(), wi)
            _close(gv.cpu(), wv.numpy())
