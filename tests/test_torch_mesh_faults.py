"""The port's mesh placements that follow the reference where they once
departed from it, on CPU meshes and on meshes of ``meta`` entries.

* Attention split inside heads (``models/transformer.py`` ``_Plan``,
  ``param_pspecs``, ``cache_pspecs``; ``launch/steps.py``
  ``place_caches``): the reduced qwen (4 heads, n_kv 4, d_head 16, seq
  96 / 64) on a (1, 8) CPU mesh, where 8 columns are half a head and
  ``n_kv % 8 != 0`` shards the cache's sequence axis: its train, prefill
  and decode (bf16 and int8 caches) built steps against the reference's
  built (1, 1) step, the weights carried across, under
  ``tests/test_torch_lm_parallel.py``'s tolerances (logits by cosine
  >= 0.995 and argmax agreement >= 0.9, caches by cosine >= 0.995, two
  train steps' losses within rtol 2e-3 and grad norms within 3e-2); in
  float32 against the port's own (1, 1) steps within rtol and atol 1e-5;
  a (1, 8) train step run twice from one state equal in every leaf. The
  placement of the sequence split (each shard's block its positions) and
  of the unsplit cache where the sequence does not divide.
* The dry run on the 16x16 mesh of ``meta`` entries: qwen1.5-32b's
  decode_32k holds the arguments the shapes reckon on a device, under the
  card's 76 GB; two-tower-retrieval's serve_p99 copies no table block
  (its tables placed once per data shard), its all-reduce 92,160 B a
  device and its scores' gather onto the lead device 7 B.
* The recsys serving steps on (2, 2) CPU meshes: with each table placed
  once per data shard, every output equal to the bit to the step whose
  tables are replicated from the first data shard inside the step, and
  no table byte copied.
"""

import functools
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side: a card host without JAX skips the file

from repro.configs.lm_archs import LM_ARCHS as REF_LM_ARCHS  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_mesh as jax_mesh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.lm_archs import LM_ARCHS  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import carry_params, embedding, tree_leaves, tree_map  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.parallel import Sharded, copy_record  # noqa: E402
from repro_torch.train.optimizer import init_opt_state  # noqa: E402

AXES = ("data", "model")
QWEN = "qwen1.5-32b"
TP = 8  # half a head of the reduced qwen's 16-wide heads a shard
KINDS = ("train", "prefill", "decode", "decode_int8")
SHAPES = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k",
          "decode_int8": "decode_32k"}
COS_BF16, ARGMAX_BF16 = 0.995, 0.9
LOSS_RTOL, GNORM_RTOL = 2e-3, 3e-2
OWN_TOL = 1e-5
CARD_BYTES = 76e9  # the most a dry run's device may hold: the card's 80 GB less a margin
RECSYS_SERVE = (("two-tower-retrieval", "serve_p99"), ("two-tower-retrieval", "retrieval_cand"),
                ("din", "serve_p99"), ("din", "retrieval_cand"), ("bert4rec", "serve_p99"),
                ("sasrec", "serve_p99"))


def cpu_mesh(shape):
    return make_mesh(shape, AXES, devices=["cpu"] * int(np.prod(shape)))


def meta_mesh(shape):
    return make_mesh(shape, AXES, devices=["meta"] * int(np.prod(shape)))


def _archs(dtype=None):
    ref = next(a for a in REF_LM_ARCHS if a.arch_id == QWEN).reduced()
    port = next(a for a in LM_ARCHS if a.arch_id == QWEN).reduced()
    if dtype is not None:
        ref = replace(ref, model_cfg=replace(ref.model_cfg, dtype=dtype))
        port = replace(port, model_cfg=replace(port.model_cfg, dtype=dtype))
    return ref, port


def _np(x):
    if isinstance(x, Sharded):
        x = x.full()
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _cosine(a, b) -> float:
    a, b = _np(a).ravel().astype(np.float64), _np(b).ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# -- the reduced qwen on (1, 8) against the reference's (1, 1) step -------------------
@functools.cache
def reference_cell(kind):
    """(the reference's outputs, its inputs carried to the port): two
    train steps' (loss, grad norm), or the serving step's (logits,
    caches), on a (1, 1) mesh."""
    ref, _ = _archs()
    os.environ["REPRO_KV_INT8"] = "1" if kind == "decode_int8" else "0"
    try:
        jbuilt = jsteps.build_step(ref, SHAPES[kind], jax_mesh((1, 1), AXES))
        jargs = jsteps.materialize_inputs(ref, SHAPES[kind], jbuilt, seed=1)
    finally:
        os.environ.pop("REPRO_KV_INT8")
    carried = tuple(carry_params(jax.tree.map(np.asarray, a), device="cpu") for a in jargs)
    if kind == "train":
        jp, jo, out = jargs[0], jargs[1], []
        for _ in range(2):
            jp, jo, m = jbuilt.fn(jp, jo, jargs[2])
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return np.array(out), carried
    logits, caches = jbuilt.fn(*jargs)
    return (np.asarray(logits, np.float32),
            {k: np.asarray(v, np.float32) for k, v in caches.items()}), carried


def _run_port(port, kind, mesh, args):
    built = tsteps.build_step(port, SHAPES[kind], mesh)
    params = tsteps.place_params(built, tree_map(torch.clone, args[0]))
    if kind == "train":
        opt, out = init_opt_state(params), []
        for _ in range(2):
            params, opt, m = built.fn(params, opt, args[2])
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return np.array(out)
    if kind == "prefill":
        return built.fn(params, args[1])
    return built.fn(params, args[1], tsteps.place_caches(built, args[2]), args[3])


@pytest.mark.parametrize("kind", KINDS)
def test_split_inside_heads_matches_reference(kind, monkeypatch):
    """The reduced qwen's built step on (1, 8), its attention split inside
    heads and its cache by positions, against the reference's (1, 1)
    step."""
    _, port = _archs()
    monkeypatch.setenv("REPRO_KV_INT8", "1" if kind == "decode_int8" else "0")
    want, carried = reference_cell(kind)
    mesh = cpu_mesh((1, TP))
    got = _run_port(port, kind, mesh, carried)
    if kind == "train":
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=GNORM_RTOL)
        return
    logits, caches = got
    assert _cosine(logits, want[0]) >= COS_BF16
    assert float((_np(logits).argmax(-1) == want[0].argmax(-1)).mean()) >= ARGMAX_BF16
    assert sorted(caches) == sorted(want[1])
    for k in ("k", "v"):
        assert isinstance(caches[k], Sharded) and caches[k].grid == (1, TP)
        assert caches[k].axes == (1, 2), k  # positions over the model shards
        assert _np(caches[k]).shape == want[1][k].shape
        assert _cosine(caches[k], want[1][k]) >= COS_BF16, k


def _f32_inputs(kind, mesh):
    _, port = _archs("float32")
    cfg = port.model_cfg
    built = tsteps.build_step(port, SHAPES[kind], mesh)
    dims = port.shapes[SHAPES[kind]].dims
    B, S = dims["global_batch"], dims["seq_len"]
    rng = np.random.default_rng(3)
    params = ttf.init_params(cfg, 3, device="cpu")
    if kind == "prefill":
        return cfg, built, params, torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                                    .astype(np.int32))
    cache = ttf.init_cache(cfg, B, S, dtype=torch.float32, quantized=kind == "decode_int8",
                           device="cpu")
    for v in cache.values():
        v.copy_(torch.from_numpy(rng.integers(-50, 50, v.shape) if v.dtype == torch.int8
                                 else rng.normal(0, 0.5, v.shape)))
    token = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32))
    return cfg, built, params, (token, cache)


@pytest.mark.parametrize("kind", KINDS)
def test_split_inside_heads_matches_one_device_f32(kind, monkeypatch):
    """In float32 the (1, 8) step equals the port's own (1, 1) step within
    1e-5: a train step's loss and every gradient, prefill's logits and
    cache, a decode step's (at a position inside the fifth shard's block)
    logits and cache."""
    monkeypatch.setenv("REPRO_BF16_GATHER", "0")
    mesh, one = cpu_mesh((1, TP)), cpu_mesh((1, 1))
    if kind == "train":
        _, port = _archs("float32")
        cfg = port.model_cfg
        b1 = tsteps.build_step(port, "train_4k", one)
        params, _, batch = tsteps.materialize_inputs(port, "train_4k", b1, seed=3)
        sharded = tsteps.place_params(tsteps.build_step(port, "train_4k", mesh), params)
        got = ttf.lm_grads_microbatched(cfg, sharded, batch["tokens"], batch["targets"], 1,
                                        mesh, bf16_gather=False)
        want = ttf.lm_grads_microbatched(cfg, params, batch["tokens"], batch["targets"], 1,
                                         one, bf16_gather=False)
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=OWN_TOL)
        for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
            np.testing.assert_allclose(_np(got[1]["layers"]["attn"][name]),
                                       _np(want[1]["layers"]["attn"][name]),
                                       rtol=OWN_TOL, atol=OWN_TOL, err_msg=name)
        for name in ("embed", "lm_head"):
            np.testing.assert_allclose(_np(got[1][name]), _np(want[1][name]), rtol=OWN_TOL,
                                       atol=OWN_TOL, err_msg=name)
        return
    cfg, built, params, inputs = _f32_inputs(kind, mesh)
    sharded = tsteps.place_params(built, params)
    if kind == "prefill":
        got_l, got_c = ttf.prefill(cfg, sharded, inputs, mesh)
        want_l, want_c = ttf.prefill(cfg, params, inputs, one)
    else:
        token, cache = inputs
        position = 4 * cache["k"].shape[2] // TP + 5
        whole = {k: v.clone() for k, v in cache.items()}
        got_l, got_c = ttf.decode_step(cfg, sharded, token, tsteps.place_caches(built, cache),
                                       position, mesh)
        want_l, want_c = ttf.decode_step(cfg, params, token, whole, position, one)
    np.testing.assert_allclose(_np(got_l), _np(want_l), rtol=OWN_TOL, atol=OWN_TOL)
    assert sorted(got_c) == sorted(want_c)
    for k in got_c:
        np.testing.assert_allclose(_np(got_c[k]), _np(want_c[k]), rtol=OWN_TOL, atol=OWN_TOL,
                                   err_msg=k)


def test_split_inside_heads_train_step_replays_to_the_bit():
    """Two runs of the (1, 8) train step from one state: every parameter
    block, moment and metric equal to the bit."""
    _, port = _archs()
    built = tsteps.build_step(port, "train_4k", cpu_mesh((1, TP)))
    runs = []
    for _ in range(2):
        p, o, batch = tsteps.materialize_inputs(port, "train_4k", built, seed=5)
        assert isinstance(p["layers"]["attn"]["wq"], Sharded)
        p, o, m = built.fn(p, o, batch)
        runs.append((tree_leaves((p, o)), (float(m["loss"]), float(m["grad_norm"]))))
    (a, ma), (b, mb) = runs
    assert ma == mb and len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- the placement of the sequence split ----------------------------------------------
@pytest.mark.parametrize("seq_len", [96, 100])
def test_sequence_split_cache_placement(seq_len):
    """At tp 8 the reduced qwen's cache shards its sequence axis where the
    sequence divides (shard r holds positions [r S / 8, (r + 1) S / 8) of
    every kv head, the reference's spec) and is not split over the model
    shards where it does not; a decode step on either placement equals
    the (1, 1) step in float32."""
    ref, port = _archs("float32")
    cfg = port.model_cfg
    for quantized in (False, True):
        want = jtf.cache_pspecs(ref.model_cfg, TP, ("data",), seq_len=seq_len,
                                quantized=quantized)
        got = ttf.cache_pspecs(cfg, TP, ("data",), seq_len=seq_len, quantized=quantized)
        assert got == jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    split = seq_len % TP == 0
    assert got["k"] == ((None, "data", "model", None, None) if split
                        else (None, "data", None, None, None))
    port = replace(port, shapes={"d": replace(port.shapes["decode_32k"], dims={
        "seq_len": seq_len, "global_batch": 4})})
    mesh, one = cpu_mesh((1, TP)), cpu_mesh((1, 1))
    built = tsteps.build_step(port, "d", mesh)
    assert built.meta["cache_pspecs"]["k"] == got["k"]
    rng = np.random.default_rng(7)
    whole = ttf.init_cache(cfg, 4, seq_len, dtype=torch.float32, device="cpu")
    for v in whole.values():
        v.copy_(torch.from_numpy(rng.normal(0, 0.5, v.shape)))
    placed = tsteps.place_caches(built, {k: v.clone() for k, v in whole.items()})
    for k, c in placed.items():
        if split:
            blk = seq_len // TP
            assert isinstance(c, Sharded) and c.grid == (1, TP) and c.axes == (1, 2)
            for r in range(TP):
                assert torch.equal(c.block(0, r), whole[k][:, :, r * blk:(r + 1) * blk])
        else:
            assert torch.equal(c, whole[k])
    params = ttf.init_params(cfg, 3, device="cpu")
    token = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32))
    position = seq_len - 3
    got_l, got_c = ttf.decode_step(cfg, tsteps.place_params(built, params), token, placed,
                                   position, mesh)
    want_l, want_c = ttf.decode_step(cfg, params, token, whole, position, one)
    np.testing.assert_allclose(_np(got_l), _np(want_l), rtol=OWN_TOL, atol=OWN_TOL)
    for k in want_c:
        np.testing.assert_allclose(_np(got_c[k]), _np(want_c[k]), rtol=OWN_TOL, atol=OWN_TOL)


# -- the dry run on 16x16 -------------------------------------------------------------
def test_qwen_decode_fits_a_card_on_16x16():
    """qwen1.5-32b's decode_32k on the 16x16 mesh of ``meta``: a device
    (each data shard's first) holds its vocab blocks of the embedding and
    head, the final norm, every layer's norms and 1/16 of its attention
    and MLP weights (bf16), the token ids, and 1/16 of its data shard's
    k and v caches by positions: 25.9 GB, where the whole attention and
    cache once put 360.6 GB on it."""
    arch = get_arch(QWEN)
    cfg = arch.model_cfg
    dims = arch.shapes["decode_32k"].dims
    B, S = dims["global_batch"], dims["seq_len"]
    tp = dp = 16
    D, F, L, dh = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.head_dim
    bf16 = 2
    per_layer = (2 * D  # ln1, ln2
                 + 4 * D * (cfg.n_heads * dh // tp)  # wq, wk, wv, wo column / row blocks
                 + 3 * (cfg.n_heads * dh // tp)  # bq, bk, bv
                 + 3 * D * (F // tp)) * bf16  # the MLP's blocks
    weights = L * per_layer + (2 * cfg.vocab_padded // tp * D + D) * bf16
    cache = 2 * L * (B // dp) * (S // tp) * cfg.n_kv * dh * bf16
    token = B * 4
    rec = dryrun.run_cell(arch, "decode_32k", False, layer_probe=False,
                          mesh=meta_mesh((dp, tp)))
    assert rec["memory"]["argument_bytes"] == weights + cache + token == 25_875_712_512
    assert rec["memory"]["argument_bytes"] <= CARD_BYTES
    assert rec["memory"]["peak_per_device_gib"] is not None
    assert rec["collectives"]["once_bytes"]["all-to-all"] > 0


def test_twotower_serve_copies_no_table_on_16x16():
    """two-tower-retrieval's serve_p99 on the 16x16 mesh of ``meta``: its
    tables placed once per data shard, the step copies nothing of a table
    (it broadcast 1,206,000,000 B a device when each block was replicated
    inside the step); the partial bags meet in 92,160 B a device, and the
    16 data shards' scores (B 512, 32 float32 each) on the lead device:
    15 x 128 B over the mesh, 7 B a device (the record's whole bytes)."""
    arch = get_arch("two-tower-retrieval")
    rec = dryrun.run_cell(arch, "serve_p99", False, mesh=meta_mesh((16, 16)))
    once = rec["collectives"]["once_bytes"]
    B, dp, n_dev = arch.shapes["serve_p99"].dims["batch"], 16, 256
    assert once == {"all-reduce": 92_160, "gather": int((dp - 1) * (B // dp) * 4 / n_dev)}
    assert once["gather"] == 7
    cfg = arch.model_cfg
    assert 92_160 < cfg.n_items // 16 * cfg.embed_dim * 4  # far below a block of item_emb


# -- the recsys serving steps on (2, 2) CPU meshes ------------------------------------
def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("arch_id,shape", RECSYS_SERVE)
def test_recsys_serving_tables_once_per_data_shard(arch_id, shape, monkeypatch):
    """A reduced recsys serving step on a (2, 2) CPU mesh with each
    row-sharded table placed once per data shard (the layout
    ``place_params`` gives where the data shards' devices differ): every
    output equal to the bit to the step on the tables ``place_params``
    places here (one row, each block replicated over the data shards
    inside the step where the ids split over them), the same all-reduce,
    and no block of a placed table copied."""
    arch = get_arch(arch_id).reduced()
    mesh = cpu_mesh((2, 2))
    built = tsteps.build_step(arch, shape, mesh)
    params, batch = tsteps.materialize_inputs(arch, shape, built, seed=11)
    names = built.meta["sharded_tables"]
    assert names and all(params[k].grid == (1, 2) for k in names)
    replicas = {k: Sharded.split(v.full(), mesh.grid(), (None, 0)) if k in names else v
                for k, v in params.items()}
    assert all(replicas[k].grid == (2, 2) for k in names)
    copied = []
    replicate = embedding.replicate
    monkeypatch.setattr(embedding, "replicate",
                        lambda x, devices: (copied.append(x.data_ptr()), replicate(x, devices))[1])

    def run(tables):
        copied.clear()
        with copy_record() as rec:
            out = _outputs(built.fn(tables, batch))
        blocks = {b.data_ptr() for k in names for b in tables[k].shards}
        return out, rec.bytes, [p for p in copied if p in blocks]

    want, before, old_copies = run(params)
    got, after, new_copies = run(replicas)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert after.get("all-reduce") == before.get("all-reduce")
    assert new_copies == []
    if shape == "serve_p99":  # the ids split over the data shards: the old path copied blocks
        assert old_copies and after.get("broadcast", 0) < before["broadcast"]
