"""The LM's tensor parallelism and FSDP (``models/transformer.py`` over a
mesh, ``launch/steps.py`` ``fsdpify``/``place_params``/``place_caches``,
``parallel.py`` ``gather_blocks``/``Sharded``) on CPU meshes, against the
reference.

* Placement: for the five full-width configs, the port's
  ``param_pspecs`` (and ``fsdpify`` of it) at tp 1, 2, 4, 16 and fs 1, 2,
  16, and ``cache_pspecs``, equal to the reference's leaf for leaf except
  the departures ``DEPARTURES`` lists, each asserted: kv projections
  kept whole where q heads split but kv heads do not (phi and granite at
  tp 16), and the cache split by the kv heads each shard reads (shared),
  where the reference splits its sequence axis.
* Parity: the five reduced archs' built train, prefill and decode (bf16
  and int8 cache) steps over (1, 2), (1, 4) and (2, 2) meshes of the CPU,
  on the reference's inputs (its weights carried across), against the
  reference's built (1, 1) step with ``tests/test_torch_steps.py``'s and
  ``tests/test_torch_train_steps.py``'s tolerances: logits by cosine
  >= 0.995 and argmax agreement >= 0.9, caches by cosine >= 0.995, two
  train steps' losses within rtol 2e-3 and grad norms within 3e-2. An
  MoE over model shards computes in float32 for its logits' check (both
  sides, the same bf16 weights): within rtol and atol 1e-5 of the
  reference's float32 step, logits and caches (``REF_F32_TOL``); in bf16
  a router can flip a top-k choice on the last bit of the split
  attention output, which moves a whole row. An MoE's capacity is per data
  shard, so with two data shards its serving oracle is the reference's
  (1, 1) step on each shard's rows, and its train step is held to the
  reference's own (2, 2) step. Each cell is also held to the port's own
  (1, 1) step in float32 (``REPRO_BF16_GATHER=0``) within rtol and atol
  1e-5: a train step's first loss and grad norm and every gradient
  (for an MoE with two data shards, the mean of the (1, 1) gradients of
  each shard's rows), prefill's logits and cache, a decode step's logits
  and cache on a float32 cache.
* ("pod", "data", "model") meshes: the float32 train step and prefill
  within 1e-5 of the (1, 1) steps, FSDP over the data axis alone.
* The reference's own sharded step: the stablelm, phi and granite train
  steps over a (2, 2) mesh of forced host devices, run as this file in a
  subprocess, two steps within the tolerances above.
* ``gather_blocks``' explicit backward; a (2, 2) train step replayed from
  one state, equal in every leaf; checkpoints of sharded states (whole
  arrays under the leaf's name: restored across meshes, read by the
  reference's ``restore_checkpoint``) and a supervised (2, 2) run that
  resumes from an injected failure with the uninterrupted run's losses.
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

from repro.configs.lm_archs import LM_ARCHS as REF_LM_ARCHS  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_mesh as jax_mesh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.configs.lm_archs import LM_ARCHS  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import carry_params, tree_leaves, tree_map  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.parallel import MeshPlan, Sharded, gather_blocks  # noqa: E402
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.train.optimizer import init_opt_state  # noqa: E402

AXES = ("data", "model")
MESHES = ((1, 2), (1, 4), (2, 2))
ARCH_IDS = [a.arch_id for a in LM_ARCHS]
MOE_IDS = ("phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m")
KINDS = ("train", "prefill", "decode", "decode_int8")
SHAPES = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k",
          "decode_int8": "decode_32k"}
COS_BF16, ARGMAX_BF16 = 0.995, 0.9
# An MoE over model shards against the reference's step, both in float32
# compute: the reduced phi and granite at (1, 2), (1, 4) and (2, 2) differ
# by at most 2.2e-6 (logits up to 4.1) and 3.9e-6 (caches).
REF_F32_TOL = 1e-5
LOSS_RTOL, GNORM_RTOL = 2e-3, 3e-2
OWN_RTOL = OWN_ATOL = 1e-5
REF_MESH = (2, 2)  # the reference's own sharded train steps
REF_ARCHS = ("stablelm-1.6b",) + MOE_IDS
REF_TIMEOUT_S = 600

# The placements where the port departs from the reference: (arch, tp) ->
# the leaves whose "model" entry the port drops, and the cache's spec.
DEPARTURES = {
    ("phi3.5-moe-42b-a6.6b", 16): ("wk", "wv"),
    ("granite-moe-1b-a400m", 16): ("wk", "wv"),
}
CACHE_DEPARTURES = {  # the port's head axis entry where it differs
    ("phi3.5-moe-42b-a6.6b", 16): "model",
    ("granite-moe-1b-a400m", 16): "model",
}


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def cpu_mesh(shape):
    return make_mesh(shape, AXES, devices=["cpu"] * int(np.prod(shape)))


def _archs(arch_id, dtype=None):
    ref = next(a for a in REF_LM_ARCHS if a.arch_id == arch_id).reduced()
    port = next(a for a in LM_ARCHS if a.arch_id == arch_id).reduced()
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


def _agreement(a, b) -> float:
    return float((_np(a).argmax(-1) == _np(b).argmax(-1)).mean())


def _carry(tree):
    return carry_params(jax.tree.map(np.asarray, tree), device="cpu")


# -- the reference's own (2, 2) train steps, run as a script with 8 host devices ---
def reference_main(path: str) -> None:
    assert len(jax.devices()) == 8, jax.devices()
    out = {}
    for arch_id in REF_ARCHS:
        ref, _ = _archs(arch_id)
        jbuilt = jsteps.build_step(ref, "train_4k", jax_mesh(REF_MESH, AXES))
        jp, jo, batch = jsteps.materialize_inputs(ref, "train_4k", jbuilt, seed=1)
        steps = []
        for _ in range(2):
            jp, jo, m = jbuilt.fn(jp, jo, batch)
            steps.append((float(m["loss"]), float(m["grad_norm"])))
        out[arch_id] = np.array(steps)
    np.savez(path, **out)


@pytest.fixture(scope="module", autouse=True)
def reference_process(tmp_path_factory):
    """The reference script, started with the module so it runs beside the
    in-process tests -> (process, output path)."""
    path = tmp_path_factory.mktemp("lm_parallel") / "reference.npz"
    # one thread: it shares the host with the tests it runs beside
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
def reference_sharded(reference_process):
    proc, path = reference_process
    out, _ = proc.communicate(timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, out
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# -- the reference's (1, 1) steps, each compiled once ---------------------------------
def _reference_inputs(ref, kind, jbuilt):
    """The reference's seeded inputs for ``jbuilt``; a float32 model's
    bf16 decode cache in float32, as its decode writes it."""
    jargs = jsteps.materialize_inputs(ref, SHAPES[kind], jbuilt, seed=1)
    if ref.model_cfg.dtype == "float32" and kind.startswith("decode"):
        cache = {k: v.astype(jax.numpy.float32) if v.dtype == jax.numpy.bfloat16 else v
                 for k, v in jargs[2].items()}
        jargs = (jargs[0], jargs[1], cache, jargs[3])
    return jargs


@functools.cache
def reference_cell(arch_id, kind, dtype=None):
    """(the reference's outputs, its inputs carried to the port) for one
    reduced cell on a (1, 1) mesh, its compute in ``dtype`` where given."""
    ref, _ = _archs(arch_id, dtype)
    os.environ["REPRO_KV_INT8"] = "1" if kind == "decode_int8" else "0"
    try:
        jbuilt = jsteps.build_step(ref, SHAPES[kind], jax_mesh((1, 1), AXES))
        jargs = _reference_inputs(ref, kind, jbuilt)
    finally:
        os.environ.pop("REPRO_KV_INT8")
    carried = tuple(_carry(a) for a in jargs)
    if kind == "train":
        jp, jo, out = jargs[0], jargs[1], []
        for _ in range(2):
            jp, jo, m = jbuilt.fn(jp, jo, jargs[2])
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return np.array(out), carried
    logits, caches = jbuilt.fn(*jargs)
    return (np.asarray(logits, np.float32), {k: np.asarray(v, np.float32)
                                             for k, v in caches.items()}), carried


@functools.cache
def reference_halves(arch_id, kind, dtype=None):
    """An MoE's serving oracle over two data shards: the reference's (1, 1)
    prefill or decode on each half of the batch, concatenated."""
    ref, _ = _archs(arch_id, dtype)
    cfg, mesh = ref.model_cfg, jax_mesh((1, 1), AXES)
    os.environ["REPRO_KV_INT8"] = "1" if kind == "decode_int8" else "0"
    try:
        jbuilt = jsteps.build_step(ref, SHAPES[kind], mesh)
        jargs = _reference_inputs(ref, kind, jbuilt)
    finally:
        os.environ.pop("REPRO_KV_INT8")
    half = jargs[1].shape[0] // 2
    logits, caches = [], []
    for h in range(2):
        rows = slice(h * half, (h + 1) * half)
        if kind == "prefill":
            lg, c = jax.jit(lambda p, t: jtf.prefill(cfg, p, t, mesh, ("data",)))(
                jargs[0], jargs[1][rows])
        else:
            c_half = {k: v[:, rows] for k, v in jargs[2].items()}
            lg, c = jax.jit(lambda p, t, c: jtf.decode_step(cfg, p, t, c, 0, mesh, ("data",)))(
                jargs[0], jargs[1][rows], c_half)
        logits.append(np.asarray(lg, np.float32))
        caches.append({k: np.asarray(v, np.float32) for k, v in c.items()})
    return np.concatenate(logits), {k: np.concatenate([c[k] for c in caches], axis=1)
                                    for k in caches[0]}


# -- placement -------------------------------------------------------------------
class _Shape:
    def __init__(self, **shape):
        self.shape = shape


def _ref_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _drop_model(tree, names):
    """The reference's spec tree with "model" dropped from ``names``'
    attention leaves: what the port's rules give there."""
    P = jax.sharding.PartitionSpec

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key in names:
            return P(*(None if e == "model" else e for e in node))
        return node

    return walk(tree)


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_placement_matches_reference(arch_id, tp):
    ref = next(a for a in REF_LM_ARCHS if a.arch_id == arch_id).model_cfg
    port = next(a for a in LM_ARCHS if a.arch_id == arch_id).model_cfg
    ref_abs = jax.eval_shape(functools.partial(jtf.init_params, ref), jax.random.key(0))
    port_abs = ttf.init_params(port, device="meta")
    dropped = DEPARTURES.get((arch_id, tp), ())
    ref_specs = _drop_model(jtf.param_pspecs(ref, tp), dropped)
    got = ttf.param_pspecs(port, tp)
    assert got == _ref_tuples(ref_specs)
    if dropped:  # the departure is real: the reference splits those leaves
        raw = _ref_tuples(jtf.param_pspecs(ref, tp))["layers"]["attn"]
        assert all("model" in raw[k] and "model" not in got["layers"]["attn"][k]
                   for k in dropped if k in raw)
    for fs in (1, 2, 16):
        mesh = _Shape(data=fs, model=tp)
        want = _ref_tuples(jsteps.fsdpify(ref_specs, ref_abs, mesh))
        assert tsteps.fsdpify(got, port_abs, mesh) == want, fs
    dp = ("data",)
    for quantized in (False, True):
        want = _ref_tuples(jtf.cache_pspecs(ref, tp, dp, seq_len=32768, quantized=quantized))
        got_c = ttf.cache_pspecs(port, tp, dp, seq_len=32768, quantized=quantized)
        if (arch_id, tp) in CACHE_DEPARTURES:
            head = CACHE_DEPARTURES[(arch_id, tp)]
            assert want["k"] == (None, "data", "model", None, None)  # the reference seq-shards
            want = {k: (None, "data", None, head, None)[:len(v)] for k, v in want.items()}
        assert got_c == want


# -- parity ------------------------------------------------------------------------
def _place_all(built, args, kind):
    # a leaf the step keeps whole is placed as it is, and a train step
    # updates it in place: the cached inputs stay as the reference drew them
    params = tsteps.place_params(built, tree_map(torch.clone, args[0]))
    if kind == "train":
        return params, init_opt_state(params), args[2]
    if kind == "prefill":
        return params, args[1]
    return params, args[1], tsteps.place_caches(built, args[2]), args[3]


def _run_port(port, kind, mesh, args):
    """The port's built step over ``mesh`` on the carried inputs ->
    [(loss, grad_norm)] x 2, or (logits, caches)."""
    built = tsteps.build_step(port, SHAPES[kind], mesh)
    placed = _place_all(built, args, kind)
    if kind == "train":
        p, o, batch = placed
        out = []
        for _ in range(2):
            p, o, m = built.fn(p, o, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        assert isinstance(p["layers"]["attn"]["wq"], Sharded) or mesh.devices.size == 1
        return np.array(out)
    return built.fn(*placed)


def _assert_serving(got, want, logits_cosine=True):
    logits, caches = got
    want_l, want_c = want
    if logits_cosine:
        assert _cosine(logits, want_l) >= COS_BF16
    assert _agreement(logits, want_l) >= ARGMAX_BF16
    assert sorted(caches) == sorted(want_c)
    for k in ("k", "v"):
        assert _np(caches[k]).shape == want_c[k].shape
        assert _cosine(caches[k], want_c[k]) >= COS_BF16, k


def _own_f32(arch_id, kind, mesh, monkeypatch):
    """The port's float32 step over ``mesh`` against its own (1, 1) step."""
    monkeypatch.setenv("REPRO_BF16_GATHER", "0")
    _, port = _archs(arch_id, dtype="float32")
    cfg = port.model_cfg
    split = arch_id in MOE_IDS and mesh.shape["data"] > 1  # capacity per data shard
    one = cpu_mesh((1, 1))
    if kind == "train":
        b1 = tsteps.build_step(port, "train_4k", one)
        params, _, batch = tsteps.materialize_inputs(port, "train_4k", b1, seed=3)
        bs = tsteps.build_step(port, "train_4k", mesh)
        sharded = tsteps.place_params(bs, params)

        def grads(p, m, tok, tgt):
            return ttf.lm_grads_microbatched(cfg, p, tok, tgt, 1, m, ("data",),
                                             bf16_gather=False)

        loss, g = grads(sharded, mesh, batch["tokens"], batch["targets"])
        if split:
            halves = [grads(params, one, t, y) for t, y in
                      zip(batch["tokens"].chunk(2), batch["targets"].chunk(2))]
            want_loss = (halves[0][0] + halves[1][0]) / 2
            want_g = tree_map(lambda a, b: (a + b) / 2, halves[0][1], halves[1][1])
        else:
            want_loss, want_g = grads(params, one, batch["tokens"], batch["targets"])
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=OWN_RTOL)
        flat = {k: _np(v) for k, v in _named(g)}
        for name, w in _named(want_g):
            np.testing.assert_allclose(flat[name], _np(w), rtol=OWN_RTOL, atol=OWN_ATOL,
                                       err_msg=name)
        # and the built step's first loss and grad norm
        o1, os_ = init_opt_state(params), init_opt_state(sharded)
        params1 = tree_map(torch.clone, params)
        _, _, m1 = b1.fn(params1, o1, batch)
        _, _, ms = bs.fn(sharded, os_, batch)
        if not split:
            np.testing.assert_allclose([float(ms["loss"]), float(ms["grad_norm"])],
                                       [float(m1["loss"]), float(m1["grad_norm"])],
                                       rtol=OWN_RTOL)
        return
    params = ttf.init_params(cfg, 3, device="cpu")
    B = port.shapes[SHAPES[kind]].dims["global_batch"]
    S = port.shapes[SHAPES[kind]].dims["seq_len"]
    rng = np.random.default_rng(3)
    bs = tsteps.build_step(port, SHAPES[kind], mesh)
    sharded = tsteps.place_params(bs, params)
    rows = [slice(0, B // 2), slice(B // 2, B)] if split else [slice(0, B)]
    if kind == "prefill":
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
        got_l, got_c = ttf.prefill(cfg, sharded, tokens, mesh)
        wants = [ttf.prefill(cfg, params, tokens[r], one) for r in rows]
    else:
        quantized = kind == "decode_int8"
        cache = ttf.init_cache(cfg, B, S, dtype=torch.float32, quantized=quantized,
                               device="cpu")
        for k, v in cache.items():
            v.copy_(torch.from_numpy(rng.integers(-50, 50, v.shape) if v.dtype == torch.int8
                                     else rng.normal(0, 0.5, v.shape)))
        token = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32))
        position = S // 2
        whole = {k: v.clone() for k, v in cache.items()}
        placed = tsteps.place_caches(bs, cache)
        got_l, got_c = ttf.decode_step(cfg, sharded, token, placed, position, mesh)
        wants = [ttf.decode_step(cfg, params, token[r],
                                 {k: v[:, r].clone() for k, v in whole.items()}, position, one)
                 for r in rows]
    want_l = torch.cat([w[0] for w in wants])
    np.testing.assert_allclose(_np(got_l), _np(want_l), rtol=OWN_RTOL, atol=OWN_ATOL)
    for k in got_c:
        want = torch.cat([w[1][k] for w in wants], dim=1)
        np.testing.assert_allclose(_np(got_c[k]), _np(want), rtol=OWN_RTOL, atol=OWN_ATOL,
                                   err_msg=k)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", MESHES, ids=[_tag(s) for s in MESHES])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_sharded_lm_step(arch_id, shape, kind, monkeypatch):
    """The reduced arch's built step over the mesh against the reference's
    (1, 1) step (for an MoE over two data shards, see the module
    docstring), then the float32 step against the port's own (1, 1)."""
    _, port = _archs(arch_id)
    mesh = cpu_mesh(shape)
    monkeypatch.setenv("REPRO_KV_INT8", "1" if kind == "decode_int8" else "0")
    want, carried = reference_cell(arch_id, kind)
    got = _run_port(port, kind, mesh, carried)
    moe_dp = arch_id in MOE_IDS and shape[0] > 1
    if kind == "train":
        if not moe_dp:  # an MoE over two data shards: test_reference_sharded_train_step
            np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=LOSS_RTOL)
            np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=GNORM_RTOL)
    else:
        moe_tp = arch_id in MOE_IDS and shape[1] > 1
        _assert_serving(got, reference_halves(arch_id, kind) if moe_dp else want,
                        logits_cosine=not moe_tp)
        if moe_tp:  # held to the reference in float32
            want32, carried32 = reference_cell(arch_id, kind, "float32")
            if moe_dp:
                want32 = reference_halves(arch_id, kind, "float32")
            _, port32 = _archs(arch_id, dtype="float32")
            logits, caches = _run_port(port32, kind, mesh, carried32)
            np.testing.assert_allclose(_np(logits), want32[0], rtol=REF_F32_TOL,
                                       atol=REF_F32_TOL)
            for k in ("k", "v"):
                np.testing.assert_allclose(_np(caches[k]), want32[1][k], rtol=REF_F32_TOL,
                                           atol=REF_F32_TOL, err_msg=k)
    _own_f32(arch_id, kind, mesh, monkeypatch)


@pytest.mark.parametrize("arch_id", REF_ARCHS)
def test_reference_sharded_train_step(reference_sharded, arch_id):
    """Two train steps over a (2, 2) mesh against the reference's own
    (2, 2) step (its GSPMD placement, FSDP over two data shards)."""
    _, port = _archs(arch_id)
    _, carried = reference_cell(arch_id, "train")
    got = _run_port(port, "train", cpu_mesh(REF_MESH), carried)
    want = reference_sharded[arch_id]
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=GNORM_RTOL)


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2)], ids=["2x1x2", "1x2x2"])
def test_pod_mesh_lm_steps(shape, monkeypatch):
    """A ("pod", "data", "model") mesh: the batch over pod x data, FSDP
    over the data axis only (the first pod's rows hold the blocks), TP over
    model; float32 train step and prefill within 1e-5 of the (1, 1)
    steps."""
    monkeypatch.setenv("REPRO_BF16_GATHER", "0")
    _, port = _archs("stablelm-1.6b", dtype="float32")
    mesh = make_mesh(shape, ("pod", "data", "model"), devices=["cpu"] * int(np.prod(shape)))
    got, want = [], []
    for m, out in ((mesh, got), (cpu_mesh((1, 1)), want)):
        b = tsteps.build_step(port, "train_4k", m)
        p, o, batch = tsteps.materialize_inputs(port, "train_4k", b, seed=2)
        if m is mesh:
            assert p["embed"].grid == (shape[1], 2)  # FSDP rows: the data axis alone
        _, _, metrics = b.fn(p, o, batch)
        pre = tsteps.build_step(port, "prefill_32k", m)
        logits, _ = pre.fn(*tsteps.materialize_inputs(port, "prefill_32k", pre, seed=2))
        out.extend([np.array([float(metrics["loss"]), float(metrics["grad_norm"])]), _np(logits)])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=OWN_RTOL, atol=OWN_ATOL)


def test_decode_takes_whole_caches_on_one_device():
    """A whole cache (``init_cache``'s) serves a mesh whose shards share
    its device, each shard writing its batch rows and kv heads in place:
    the same logits and cache as the placed blocks give."""
    _, port = _archs("granite-moe-1b-a400m")
    mesh = cpu_mesh((2, 2))
    built = tsteps.build_step(port, "decode_32k", mesh)
    params, token, caches, position = tsteps.materialize_inputs(port, "decode_32k", built, seed=4)
    whole = {k: v.full() for k, v in caches.items()}
    assert all(isinstance(v, Sharded) and v.grid == (2, 2) for v in caches.values())
    want_l, want_c = built.fn(params, token, caches, position)
    got_l, got_c = built.fn(params, token, whole, position)
    assert torch.equal(got_l, want_l)
    assert all(torch.equal(got_c[k], want_c[k].full()) for k in want_c)


def test_serving_keeps_a_replica_per_data_shard():
    """A weight the data axes do not split is placed once per data shard
    where the data shards' devices differ, serving or training (FSDP rows
    are split, not replicated), and the plan hands data shard d its own
    replica, no copy between rows."""
    x = torch.arange(24.0).reshape(4, 6)
    spread = make_mesh((2, 2), AXES, devices=["cpu", "cpu", "meta", "meta"])
    served = tsteps.place_leaf(x, (None, "model"), spread)
    assert served.grid == (2, 2) and served.axes == (None, 1)
    assert [b.device.type for b in served.shards] == ["cpu", "cpu", "meta", "meta"]
    assert torch.equal(served.full(), x)
    fsdp = tsteps.place_leaf(x, ("data", "model"), spread)
    assert fsdp.grid == (2, 2) and fsdp.axes == (0, 1)
    assert isinstance(tsteps.place_leaf(x, (None, None), spread), Sharded)
    one = cpu_mesh((2, 2))  # one device: no replica
    assert tsteps.place_leaf(x, (None, "model"), one).grid == (1, 2)
    rows = Sharded.split(x, one.grid(), (None, 1))
    views = MeshPlan(one, ("data",)).views(rows, 2, 1, [(0, 3), (3, 6)])
    for d in range(2):
        for r in range(2):
            assert views[d][r].data_ptr() == rows.block(d, r).data_ptr()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_sharded_serving_on_replica_rows(kind):
    """A (2, 2) serving step whose every weight is a replica per data
    shard gives the logits and caches of the same step on weights kept
    once."""
    _, port = _archs("stablelm-1.6b")
    mesh = cpu_mesh((2, 2))
    built = tsteps.build_step(port, SHAPES[kind], mesh)
    args = tsteps.materialize_inputs(port, SHAPES[kind], built, seed=6)
    grid = mesh.grid()

    def replicas(x):
        if isinstance(x, Sharded):
            return Sharded.split(x.full(), grid, (None, x.axes[1]), x.spans)
        return Sharded.split(x, grid[:, :1], (None, None))

    def walk(tree):
        return {k: walk(v) for k, v in tree.items()} if isinstance(tree, dict) else replicas(tree)

    rest = args[1:]
    if kind == "decode":
        rest = (args[1], tree_map(torch.clone, args[2]), args[3])
    want_l, want_c = built.fn(*args)
    got_l, got_c = built.fn(walk(args[0]), *rest)
    assert torch.equal(got_l, want_l)
    assert all(torch.equal(_np_t(got_c[k]), _np_t(want_c[k])) for k in want_c)


def _np_t(x):
    return x.full() if isinstance(x, Sharded) else x


# -- the collective, the replay ---------------------------------------------------------
def test_gather_blocks_backward_is_explicit():
    """The all-gather's gradient: each block's slice of every device's
    gradient, added in device order (the reduce-scatter)."""
    a = torch.arange(4.0).reshape(2, 2).requires_grad_(True)
    b = torch.arange(4.0, 10.0).reshape(2, 3).requires_grad_(True)
    outs = gather_blocks([a, b], 1, ["cpu"] * 3)
    assert all(torch.equal(o, torch.cat([a, b], 1).detach()) for o in outs)
    sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
    assert torch.equal(a.grad, torch.full((2, 2), 6.0))
    assert torch.equal(b.grad, torch.full((2, 3), 6.0))
    (one,) = gather_blocks([a.detach()], 0, ["cpu"])
    assert one.data_ptr() == a.data_ptr()  # one block on its own device: a view


def test_sharded_rows_full_and_like_round_trip():
    x = torch.arange(48.0).reshape(4, 3, 4)
    grid = np.full((2, 2), torch.device("cpu"), dtype=object)
    s = Sharded.split(x, grid, (0, 2))
    assert s.shape == (4, 3, 4) and s.grid == (2, 2)
    assert all(b.is_contiguous() and b.shape == (2, 3, 2) for b in s.shards)
    assert torch.equal(s.full(), x) and torch.equal(s.like(x * 2).full(), x * 2)
    shared = Sharded.split(x, grid, (0, 2), spans=[(0, 1), (0, 1)])  # a shared head
    assert shared.shape == (4, 3, 1) and torch.equal(shared.full(), x[..., :1])


def test_sharded_train_step_replays_to_the_bit():
    _, port = _archs("granite-moe-1b-a400m")
    mesh = cpu_mesh((2, 2))
    runs = []
    for _ in range(2):
        built = tsteps.build_step(port, "train_4k", mesh)
        p, o, batch = tsteps.materialize_inputs(port, "train_4k", built, seed=5)
        assert isinstance(p["embed"], Sharded) and p["embed"].grid == (2, 2)
        metrics = []
        for _ in range(2):
            p, o, m = built.fn(p, o, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, [t.clone() for t in tree_leaves((p, o))]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# -- checkpoints of sharded states -------------------------------------------------------
def test_checkpoint_of_sharded_rows(tmp_path):
    """A ``Sharded`` leaf is saved whole under its name and restored into
    its blocks (it was a pickled object array that would not load)."""
    t = torch.arange(32.0).reshape(8, 4)
    save_checkpoint(tmp_path, 1, {"emb": Sharded.of(t, ["cpu", "cpu"])})
    manifest = (tmp_path / "step_00000001" / "manifest.json").read_text()
    assert '"shape": [8, 4]' in manifest and '"dtype": "float32"' in manifest
    example = {"emb": Sharded.of(torch.zeros(8, 4), ["cpu", "cpu"])}
    restored, _ = restore_checkpoint(tmp_path, example, device="cpu")
    assert isinstance(restored["emb"], Sharded)
    assert torch.equal(restored["emb"].full(), t)


def _lm_state(mesh, seed=1):
    _, port = _archs("stablelm-1.6b")
    built = tsteps.build_step(port, "train_4k", mesh)
    p, o, batch = tsteps.materialize_inputs(port, "train_4k", built, seed=seed)
    return built, p, o, batch


def _whole(tree):
    return [_np(x) for _, x in _named(tree)]


@pytest.mark.parametrize("direction", ["2x2_to_1x1", "1x1_to_2x2"])
def test_sharded_lm_state_restores_on_another_mesh(tmp_path, direction):
    src, dst = ((2, 2), (1, 1)) if direction == "2x2_to_1x1" else ((1, 1), (2, 2))
    built, p, o, batch = _lm_state(cpu_mesh(src))
    p, o, _ = built.fn(p, o, batch)
    save_checkpoint(tmp_path, 1, {"params": p, "opt": o})
    _, ex_p, ex_o, _ = _lm_state(cpu_mesh(dst), seed=9)
    restored, _ = restore_checkpoint(tmp_path, {"params": ex_p, "opt": ex_o})
    for a, b in zip(_whole({"params": p, "opt": o}), _whole(restored)):
        np.testing.assert_array_equal(a, b)
    layout = restored["params"]["layers"]["mlp"]["w_up"]
    assert isinstance(layout, Sharded) == (dst == (2, 2))


def test_reference_reads_a_sharded_checkpoint(tmp_path):
    _, p, o, _ = _lm_state(cpu_mesh((2, 2)))
    save_checkpoint(tmp_path, 3, {"params": p, "opt": o})
    ref, _ = _archs("stablelm-1.6b")
    jbuilt = jsteps.build_step(ref, "train_4k", jax_mesh((1, 1), AXES))
    jp, jo, _ = jsteps.materialize_inputs(ref, "train_4k", jbuilt, seed=1)
    restored, manifest = jckpt.restore_checkpoint(tmp_path, {"params": jp, "opt": jo})
    assert manifest["step"] == 3
    got = jax.tree.leaves(restored)
    assert len(got) == len(_named({"params": p, "opt": o}))
    for g, (_, w) in zip(got, _named({"params": p, "opt": o})):
        np.testing.assert_array_equal(np.asarray(g), _np(w))


def test_supervised_sharded_run_resumes_exactly(tmp_path):
    """A (2, 2) supervised run with a failure at step 7 and checkpoints
    every 5 steps: one restart, and the losses from the restored step on
    equal the uninterrupted run's."""
    kw = dict(steps=12, ckpt_every=5, device="cpu", mesh_shape=(2, 2))
    clean = ttrain.train_arch("stablelm-1.6b", ckpt_dir=str(tmp_path / "clean"), **kw)
    failed = ttrain.train_arch("stablelm-1.6b", ckpt_dir=str(tmp_path / "faulty"),
                               inject_failures={7: "node_loss"}, **kw)
    assert clean.restarts == 0 and failed.restarts == 1
    assert failed.losses[:7] == clean.losses[:7]
    assert failed.losses[7:] == clean.losses[5:]


if __name__ == "__main__":
    reference_main(sys.argv[1])
