"""Step builders: (arch x shape x mesh) -> step + abstract inputs (the
reference's ``launch/steps.py``).

For every cell of the four families (LM train, prefill and decode; the
EGNN's train steps; recsys train, serve and retrieval; the search arch's
QT1 serve step) :func:`build_step` returns a :class:`BuiltStep`: the step
function, its abstract arguments as tensors on the ``meta`` device (the
torch counterpart of ``jax.eval_shape``: shapes and types, no memory) and
metadata for the roofline (model params, layers, tokens or edges or
postings; ``n_micro`` and ``bf16_gather`` for LM training). The step runs
on the mesh's device; the port has no sharding annotations, so a mesh
matters through its data shards (the MoE capacity dispatch runs once per
shard, the microbatch rule divides by them) and through its model axis,
over which the reference shards experts, embedding tables and the GNN's
edges, which raises until the multi-device model slice; the search step
alone runs doc-sharded over a mesh of several devices, as the serving
path does. :func:`materialize_inputs` makes concrete inputs: the port's
own seeded init (float32 masters and ``init_opt_state`` for training,
bf16 weights for LM serving) and the reference's synthetic batch, the
same numpy draws in the same order.

A train step is ``(params, opt_state, batch) -> (params, opt_state,
{"loss", "grad_norm"})``. It updates ``params`` and the moments in place
and returns them: the reference's jitted step donates them, and at full
width there is no room for a second copy.

``build_lm_layer_probe`` raises ``NotImplementedError`` naming the slice
that ports it. ``REPRO_KV_INT8=1`` (the quantized decode cache),
``REPRO_PAD_HEADS=1``, ``REPRO_MICRO_STACK_GIB``, ``REPRO_BF16_GATHER``
and ``REPRO_SEARCH_COMPRESSED`` are read where the reference reads them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.configs.recsys_archs import N_NEG
from repro_torch.kernels.common import SENTINEL
from repro_torch.launch.mesh import dp_axes_of, dp_size, tp_size
from repro_torch.models import gnn, n_params, recsys, transformer, value_and_grad
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state

F32 = torch.float32
I32 = torch.int32
META = torch.device("meta")
NP_INTS = {torch.int32: np.int32, torch.int8: np.int8}
MULTI_DEVICE_SLICE = "the multi-device model slice"
SEARCH_MODES = ("", "offsets", "delta")  # REPRO_SEARCH_COMPRESSED


@dataclass
class BuiltStep:
    fn: Any  # the step: call it with concrete arguments
    args: tuple  # abstract (meta-device tensor) trees, positional
    meta: dict = field(default_factory=dict)


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _device(mesh) -> torch.device:
    """The one device a model step runs on; a mesh over several devices
    needs the multi-device model slice."""
    devices = mesh.unique_devices()
    if len(devices) != 1:
        raise NotImplementedError(
            f"a model step over {len(devices)} devices comes with {MULTI_DEVICE_SLICE}")
    return devices[0]


# ==========================================================================
# LM family
# ==========================================================================
def pad_heads_cfg(cfg, tp: int):
    """Round the head count up to a TP multiple (Qwen-32B: 40 -> 48 on
    TP=16). Numerically equivalent when the pad-head projections are
    zero."""
    if cfg.n_heads % tp == 0:
        return cfg
    pad_to = -(-cfg.n_heads // tp) * tp
    kv = cfg.n_kv if cfg.n_kv % tp == 0 or cfg.n_kv != cfg.n_heads else pad_to
    return replace(cfg, n_heads=pad_to, n_kv=kv, d_head=cfg.head_dim)


def build_lm_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    cfg = arch.model_cfg
    dp_ax = dp_axes_of(mesh)
    tp = tp_size(mesh)
    if os.environ.get("REPRO_PAD_HEADS", "0") == "1":
        cfg = pad_heads_cfg(cfg, tp)
    dims = shape.dims
    B, S = dims["global_batch"], dims["seq_len"]
    meta = {
        "model_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "n_layers": cfg.n_layers,
        "tokens": B * S if shape.kind != "decode" else B,
        "device": _device(mesh),
    }
    if shape.kind == "train":
        params_abs = transformer.init_params(cfg, device=META)
        # reduced (smoke/example) configs train faster with a higher LR
        opt_cfg = AdamWConfig(lr=1e-3) if cfg.d_model <= 128 else AdamWConfig()
        # microbatching: bound the remat residual stack (L x Bmicro x S x D
        # bf16) per device, the reference's rule and budget
        stack_gib = float(os.environ.get("REPRO_MICRO_STACK_GIB", "2"))
        b_local = max(B // dp_size(mesh), 1)
        stack_bytes = lambda bm: cfg.n_layers * bm * S * cfg.d_model * 2  # noqa: E731
        micro_local = b_local
        while micro_local > 1 and stack_bytes(micro_local) > stack_gib * 2**30:
            micro_local //= 2
        n_micro = b_local // micro_local
        meta["n_micro"] = n_micro
        bf16_gather = os.environ.get("REPRO_BF16_GATHER", "1") != "0"
        meta["bf16_gather"] = bf16_gather

        def step(params, opt_state, batch):
            loss, grads = transformer.lm_grads_microbatched(
                cfg, params, batch["tokens"], batch["targets"], n_micro, mesh, dp_ax,
                bf16_gather=bf16_gather)
            params, opt_state, gnorm = adamw_update(opt_cfg, params, grads, opt_state)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm}

        batch_abs = {"tokens": _abstract((B, S), I32), "targets": _abstract((B, S), I32)}
        return BuiltStep(step, (params_abs, init_opt_state(params_abs), batch_abs), meta)

    # serving: bf16 params (production serving never keeps f32 masters)
    params_abs = transformer.init_params(cfg, device=META, dtype=torch.bfloat16)
    if shape.kind == "prefill":
        def step(params, tokens):
            return transformer.prefill(cfg, params, tokens, mesh, dp_ax)

        return BuiltStep(step, (params_abs, _abstract((B, S), I32)), meta)

    # decode: one new token against an S-long KV cache.
    kv_int8 = os.environ.get("REPRO_KV_INT8", "0") == "1"
    meta["kv_cache"] = "int8" if kv_int8 else "bf16"
    cache_abs = transformer.init_cache(cfg, B, S, quantized=kv_int8, device=META)

    def step(params, token, caches, position):
        return transformer.decode_step(cfg, params, token, caches, position, mesh, dp_ax)

    return BuiltStep(step, (params_abs, _abstract((B, 1), I32), cache_abs,
                            _abstract((), I32)), meta)


def build_lm_layer_probe(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    raise NotImplementedError(
        "the single-layer probe feeds the HLO roofline analysis, which comes with the "
        "profiler-driven analysis slice")


# ==========================================================================
# GNN family (EGNN)
# ==========================================================================
GNN_EDGE_MULTIPLE = 512  # the reference pads the edge axis to shard over 256 or 512 devices


def build_gnn_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    """The EGNN train step: the batched (block-diagonal, ``molecule``)
    or the unbatched loss, autograd, then AdamW (lr 1e-3, no weight
    decay) in place. The unbatched edge axis is padded to a multiple of
    512 (pad edges carry mask 0), as the reference pads it."""
    dims = shape.dims
    cfg = replace(arch.model_cfg, d_feat=dims["d_feat"])
    params_abs = gnn.init_params(cfg, device=META)
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.0)
    meta = {
        "n_layers": cfg.n_layers,
        "model_params": n_params(params_abs),
        "n_edges": dims["n_edges"] * dims.get("batch", 1),
        "device": _device(mesh),
    }
    batched = bool(dims.get("batched"))
    lead = (dims["batch"],) if batched else ()
    N, E = dims["n_nodes"], dims["n_edges"]
    if not batched:
        E = -(-E // GNN_EDGE_MULTIPLE) * GNN_EDGE_MULTIPLE
    nodes, edges = lead + (N,), lead + (E,)
    batch_abs = {
        "feats": _abstract(nodes + (dims["d_feat"],), F32),
        "coords": _abstract(nodes + (3,), F32),
        "src": _abstract(edges, I32),
        "dst": _abstract(edges, I32),
        "edge_mask": _abstract(edges, F32),
        "node_mask": _abstract(nodes, F32),
        "targets": _abstract(nodes, F32),
    }

    def loss(p, batch):
        if batched:
            return gnn.batched_loss(cfg, p, batch)
        return gnn.loss_fn(cfg, p, batch, mesh=mesh, edge_axes=tuple(mesh.axis_names))

    def step(params, opt_state, batch):
        value, grads = value_and_grad(loss, params, batch)
        params, opt_state, gnorm = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": value, "grad_norm": gnorm}

    return BuiltStep(step, (params_abs, init_opt_state(params_abs), batch_abs), meta)


# ==========================================================================
# search family (the paper's engine)
# ==========================================================================
def build_search_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    """The QT1 serve step over the arch's (B, K, L) posting rows.
    ``REPRO_SEARCH_COMPRESSED``, read here: unset or empty for the raw
    payload (three int32 streams), ``offsets`` for uint8 fragment offsets
    beside the int32 keys, ``delta`` for offsets and block-delta16 uint16
    keys. The step runs on the mesh's first device, or doc-sharded over a
    mesh of several (``core/torch_search.py``)."""
    from repro_torch.core.torch_search import (
        make_qt1_serve_step,
        make_qt1_serve_step_compressed,
    )

    cfg = arch.model_cfg
    dims = shape.dims
    B, L, K = dims["batch"], dims["postings"], cfg.n_keys
    mode = os.environ.get("REPRO_SEARCH_COMPRESSED", "")
    if mode not in SEARCH_MODES:
        raise ValueError(f"REPRO_SEARCH_COMPRESSED={mode!r}: want one of {SEARCH_MODES}")
    meta = {"n_layers": 1, "model_params": 0, "postings": B * K * L,
            "search_mode": mode or "baseline", "device": mesh.devices.flat[0]}
    vec = (_abstract((B,), F32), _abstract((B,), F32))
    if mode == "delta":
        fn = make_qt1_serve_step_compressed(top_k=cfg.top_k, delta_g=True, mesh=mesh)
        args = (_abstract((B, K, L // 64), I32), _abstract((B, K, L), torch.uint16),
                _abstract((B, K, L), torch.uint8), _abstract((B, K, L), torch.uint8)) + vec
    elif mode == "offsets":
        fn = make_qt1_serve_step_compressed(top_k=cfg.top_k, delta_g=False, mesh=mesh)
        args = (_abstract((B, K, 1), I32), _abstract((B, K, L), I32),
                _abstract((B, K, L), torch.uint8), _abstract((B, K, L), torch.uint8)) + vec
    else:
        fn = make_qt1_serve_step(top_k=cfg.top_k, mesh=mesh)
        args = tuple(_abstract((B, K, L), I32) for _ in range(3)) + vec
    return BuiltStep(fn, args, meta)


# ==========================================================================
# RecSys family
# ==========================================================================
def _arch_kind(cfg) -> str:
    return ("seqrec" if isinstance(cfg, recsys.SeqRecConfig)
            else "din" if isinstance(cfg, recsys.DINConfig)
            else "twotower")


_INITS = {"seqrec": recsys.seqrec_init, "din": recsys.din_init,
          "twotower": recsys.twotower_init}


def _tables_sharded(params_abs, tp: int) -> bool:
    """Whether the reference row-shards an embedding table over the model
    axis (``_recsys_param_pspecs``): rows divisible by tp and at least
    64 per shard."""
    return tp > 1 and any(
        "emb" in name and t.dim() == 2 and t.shape[0] % tp == 0 and t.shape[0] >= 64 * tp
        for name, t in params_abs.items() if isinstance(t, torch.Tensor))


def _recsys_batch(cfg, arch_kind: str, kind: str, dims: dict) -> dict:
    """The reference's train, serve and retrieval batches, as abstract
    tensors."""
    B = dims["batch"]
    i32 = lambda *s: _abstract(s, I32)  # noqa: E731
    f32 = lambda *s: _abstract(s, F32)  # noqa: E731
    if arch_kind == "seqrec":
        S = cfg.seq_len
        if kind == "train":
            return {"hist": i32(B, S), "target": i32(B), "negatives": i32(B, N_NEG)}
        if kind == "serve":
            return {"hist": i32(B, S), "candidates": i32(B, 100)}
        return {"hist": i32(1, S), "candidates": i32(1, dims["n_candidates"])}
    if arch_kind == "din":
        S = cfg.seq_len
        if kind == "retrieval":
            C = dims["n_candidates"]
            return {"hist_items": i32(1, S), "hist_cates": i32(1, S), "cand_items": i32(C),
                    "cand_cates": i32(C), "user_feats": f32(1, cfg.d_user)}
        batch = {"hist_items": i32(B, S), "hist_cates": i32(B, S), "target_item": i32(B),
                 "target_cate": i32(B), "user_feats": f32(B, cfg.d_user)}
        if kind == "train":
            batch["labels"] = f32(B)
        return batch
    if kind == "retrieval":
        C = dims["n_candidates"]
        return {"hist": i32(1, cfg.hist_len), "user_feats": f32(1, cfg.d_user),
                "cand_items": i32(C), "cand_cates": i32(C)}
    batch = {"hist": i32(B, cfg.hist_len), "user_feats": f32(B, cfg.d_user),
             "item": i32(B), "cate": i32(B)}
    if kind == "train":
        batch["log_q"] = f32(B)
    return batch


def build_recsys_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    cfg = arch.model_cfg
    dp_ax = dp_axes_of(mesh)
    kind = shape.kind
    arch_kind = _arch_kind(cfg)
    params_abs = _INITS[arch_kind](cfg, device=META)
    use_mesh = mesh if _tables_sharded(params_abs, tp_size(mesh)) else None
    meta = {
        "n_layers": getattr(cfg, "n_blocks", 1),
        "model_params": n_params(params_abs),
        "device": _device(mesh),
    }
    batch_abs = _recsys_batch(cfg, arch_kind, kind, shape.dims)

    if kind == "train":
        opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.0)
        loss_fn = {"seqrec": recsys.seqrec_loss, "din": recsys.din_loss,
                   "twotower": recsys.twotower_loss}[arch_kind]

        def step(params, opt_state, batch):
            loss, grads = value_and_grad(
                lambda p: loss_fn(cfg, p, batch, use_mesh, dp_ax), params)
            params, opt_state, gnorm = adamw_update(opt_cfg, params, grads, opt_state)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm}

        return BuiltStep(step, (params_abs, init_opt_state(params_abs), batch_abs), meta)

    if kind == "serve":
        serve_fn = {
            "seqrec": lambda p, b: recsys.seqrec_score(cfg, p, b, use_mesh, dp_ax),
            "din": lambda p, b: recsys.din_forward(cfg, p, b, use_mesh, dp_ax),
            "twotower": lambda p, b: recsys.twotower_score(cfg, p, b, use_mesh, dp_ax),
        }[arch_kind]
        return BuiltStep(serve_fn, (params_abs, batch_abs), meta)

    # retrieval (B=1): one user against the candidate axis
    if arch_kind == "seqrec":
        retr = lambda p, b: recsys.seqrec_score(cfg, p, b, use_mesh, ())  # noqa: E731
    elif arch_kind == "din":
        retr = lambda p, b: recsys.din_retrieval(cfg, p, b, 100, use_mesh, ())  # noqa: E731
    else:
        retr = lambda p, b: recsys.twotower_retrieve(cfg, p, b, 100, use_mesh, ())  # noqa: E731
    return BuiltStep(retr, (params_abs, batch_abs), meta)


# ==========================================================================
# dispatch + concrete-input materialization
# ==========================================================================
def build_step(arch: ArchSpec, shape_name: str, mesh) -> BuiltStep:
    shape = arch.shapes[shape_name]
    builder = {
        "lm": build_lm_step,
        "gnn": build_gnn_step,
        "recsys": build_recsys_step,
        "search": build_search_step,
    }[arch.family]
    return builder(arch, shape, mesh)


def _synth(tree, arch: ArchSpec, rng, device, dims=None):
    """The reference's synthetic leaves, drawn from ``rng`` in its order
    (dict keys sorted): integers in the family's id range (a GNN's
    ``src``/``dst`` below the shape's ``n_nodes``; wrapping into narrow
    types as numpy's cast does), zero for a scalar; ones for a float leaf
    named ``*mask*`` and zeros for ``log_q``, neither drawn; N(0, 0.5) for
    the other floats."""
    cfg = arch.model_cfg

    def leaf(name, x):
        if not x.is_floating_point():
            hi = 4
            if arch.family == "lm":
                hi = cfg.vocab
            elif arch.family == "gnn":
                hi = dims["n_nodes"] if name in ("src", "dst") else 4
            elif arch.family == "recsys":
                hi = getattr(cfg, "n_cates", 4) if "cate" in name else getattr(cfg, "n_items", 4)
            if x.dim() == 0:
                # a step's position is a host value: it picks the cache rows to write
                return torch.zeros((), dtype=x.dtype)
            a = rng.integers(0, max(hi, 2), tuple(x.shape)).astype(NP_INTS[x.dtype])
            return torch.from_numpy(a).to(device)
        if "mask" in name:
            return torch.ones(tuple(x.shape), dtype=x.dtype, device=device)
        if name == "log_q":
            return torch.zeros(tuple(x.shape), dtype=x.dtype, device=device)
        a = rng.normal(0, 0.5, tuple(x.shape)).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=x.dtype)

    if isinstance(tree, dict):
        drawn = {}
        for k in sorted(tree):
            drawn[k] = (_synth(tree[k], arch, rng, device, dims) if isinstance(tree[k], dict)
                        else leaf(k, tree[k]))
        return {k: drawn[k] for k in tree}
    return leaf("", tree)


def materialize_batch(arch: ArchSpec, shape_name: str, built: BuiltStep, seed: int = 0):
    """The step's arguments after the parameters (a train step's: after
    the optimizer state), synthesised on the step's device from
    ``np.random.default_rng(seed)`` as the reference draws them."""
    rng = np.random.default_rng(seed)
    shape = arch.shapes[shape_name]
    if arch.family == "search":
        return _search_inputs(arch, shape, rng, built.meta["device"])
    first = 2 if shape.kind == "train" else 1
    return tuple(_synth(a, arch, rng, built.meta["device"], shape.dims)
                 for a in built.args[first:])


def _search_inputs(arch: ArchSpec, shape: ShapeSpec, rng, device) -> tuple:
    """The reference's search inputs, its numpy draws in its order: per
    query row, a sorted base of L/2 distinct keys below 4L, and per key a
    sorted subset of L/4 to L/2 of them with fragment bounds 0-4 either
    side, padded with SENTINEL; idf sums U(1, 5) and span 3. For a
    compressed mode, the payload ``compress_qt1_batch`` makes of them (the
    reference hands its compressed steps the raw arrays whatever the
    mode)."""
    from repro_torch.core.torch_search import QT1Batch, compress_qt1_batch

    B, K, L = shape.dims["batch"], arch.model_cfg.n_keys, shape.dims["postings"]
    g = np.full((B, K, L), SENTINEL, np.int32)
    lo = g.copy()
    hi = g.copy()
    for b in range(B):
        base = np.sort(rng.choice(L * 4, size=L // 2, replace=False)).astype(np.int32)
        for k in range(K):
            n = rng.integers(L // 4, L // 2)
            sub = np.sort(rng.choice(base, size=n, replace=False))
            g[b, k, :n] = sub
            lo[b, k, :n] = sub - rng.integers(0, 5, n).astype(np.int32)
            hi[b, k, :n] = sub + rng.integers(0, 5, n).astype(np.int32)
    idf = rng.uniform(1, 5, B).astype(np.float32)
    span = np.full(B, 3.0, np.float32)
    mode = os.environ.get("REPRO_SEARCH_COMPRESSED", "")
    args = (g, lo, hi, idf, span)
    if mode:
        args = compress_qt1_batch(QT1Batch(g, lo, hi, idf, span, 1), delta_g=mode == "delta")
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args)


def materialize_inputs(arch: ArchSpec, shape_name: str, built: BuiltStep, seed: int = 0):
    """Concrete inputs for a built step on its device: the port's init
    seeded with ``seed`` (float32 masters and ``init_opt_state`` for
    training; serving LMs in bf16, as the reference casts them) and
    :func:`materialize_batch`."""
    cfg = arch.model_cfg
    device = built.meta["device"]
    train = arch.shapes[shape_name].kind == "train"
    if arch.family == "lm":
        dtype = torch.float32 if train else torch.bfloat16
        params = transformer.init_params(cfg, seed, device=device, dtype=dtype)
    elif arch.family == "recsys":
        params = _INITS[_arch_kind(cfg)](cfg, seed, device=device)
    elif arch.family == "gnn":
        dims = arch.shapes[shape_name].dims
        params = gnn.init_params(replace(cfg, d_feat=dims["d_feat"]), seed, device=device)
    else:  # search: the posting arrays only
        return materialize_batch(arch, shape_name, built, seed)
    state = (params, init_opt_state(params)) if train else (params,)
    return state + materialize_batch(arch, shape_name, built, seed)
