"""Step builders, serving half: (arch x shape x mesh) -> step + abstract
inputs (the reference's ``launch/steps.py``).

For every serving cell (LM prefill and decode, recsys serve and
retrieval) :func:`build_step` returns a :class:`BuiltStep`: the step
function, its abstract arguments as tensors on the ``meta`` device (the
torch counterpart of ``jax.eval_shape``: shapes and types, no memory) and
metadata for the roofline (model params, layers, tokens). The step runs
on the mesh's device; the port has no sharding annotations, so a mesh
matters through its data shards (the MoE capacity dispatch runs once per
shard) and through its model axis, over which the reference shards
experts and embedding tables, which raises until the multi-device model
slice. :func:`materialize_inputs` makes concrete inputs: the port's own
seeded init and the reference's synthetic batch, the same numpy draws in
the same order.

The train branches, ``build_lm_layer_probe``, ``build_gnn_step`` and
``build_search_step`` raise ``NotImplementedError`` naming the slice that
ports them. ``REPRO_KV_INT8=1`` (the quantized decode cache) and
``REPRO_PAD_HEADS=1`` are read where the reference reads them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.launch.mesh import dp_axes_of, tp_size
from repro_torch.models import n_params, recsys, transformer

F32 = torch.float32
I32 = torch.int32
META = torch.device("meta")
NP_INTS = {torch.int32: np.int32, torch.int8: np.int8}
TRAIN_SLICE = "the training slice"
MULTI_DEVICE_SLICE = "the multi-device model slice"


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
        raise NotImplementedError(f"LM train steps come with {TRAIN_SLICE}")

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


def build_gnn_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    raise NotImplementedError("GNN steps come with the GNN slice (after training)")


def build_search_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    raise NotImplementedError(
        "the search family's step builder comes with the GNN slice, beside "
        "configs/proximity_search.py and the registry")


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
    """The reference's serve and retrieval batches, as abstract tensors."""
    B = dims["batch"]
    i32 = lambda *s: _abstract(s, I32)  # noqa: E731
    f32 = lambda *s: _abstract(s, F32)  # noqa: E731
    if arch_kind == "seqrec":
        S = cfg.seq_len
        if kind == "serve":
            return {"hist": i32(B, S), "candidates": i32(B, 100)}
        return {"hist": i32(1, S), "candidates": i32(1, dims["n_candidates"])}
    if arch_kind == "din":
        S = cfg.seq_len
        if kind == "retrieval":
            C = dims["n_candidates"]
            return {"hist_items": i32(1, S), "hist_cates": i32(1, S), "cand_items": i32(C),
                    "cand_cates": i32(C), "user_feats": f32(1, cfg.d_user)}
        return {"hist_items": i32(B, S), "hist_cates": i32(B, S), "target_item": i32(B),
                "target_cate": i32(B), "user_feats": f32(B, cfg.d_user)}
    if kind == "retrieval":
        C = dims["n_candidates"]
        return {"hist": i32(1, cfg.hist_len), "user_feats": f32(1, cfg.d_user),
                "cand_items": i32(C), "cand_cates": i32(C)}
    return {"hist": i32(B, cfg.hist_len), "user_feats": f32(B, cfg.d_user),
            "item": i32(B), "cate": i32(B)}


def build_recsys_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    cfg = arch.model_cfg
    dp_ax = dp_axes_of(mesh)
    kind = shape.kind
    if kind == "train":
        raise NotImplementedError(f"recsys train steps come with {TRAIN_SLICE}")
    arch_kind = _arch_kind(cfg)
    params_abs = _INITS[arch_kind](cfg, device=META)
    use_mesh = mesh if _tables_sharded(params_abs, tp_size(mesh)) else None
    meta = {
        "n_layers": getattr(cfg, "n_blocks", 1),
        "model_params": n_params(params_abs),
        "device": _device(mesh),
    }
    batch_abs = _recsys_batch(cfg, arch_kind, kind, shape.dims)

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


def _synth(tree, arch: ArchSpec, rng, device):
    """The reference's synthetic serving leaves, drawn from ``rng`` in its
    order (dict keys sorted): integers in the family's id range (wrapping
    into narrow types as numpy's cast does), zero for a scalar, N(0, 0.5)
    for floats."""
    cfg = arch.model_cfg

    def leaf(name, x):
        if not x.is_floating_point():
            hi = 4
            if arch.family == "lm":
                hi = cfg.vocab
            elif arch.family == "recsys":
                hi = getattr(cfg, "n_cates", 4) if "cate" in name else getattr(cfg, "n_items", 4)
            if x.dim() == 0:
                # a step's position is a host value: it picks the cache rows to write
                return torch.zeros((), dtype=x.dtype)
            a = rng.integers(0, max(hi, 2), tuple(x.shape)).astype(NP_INTS[x.dtype])
            return torch.from_numpy(a).to(device)
        a = rng.normal(0, 0.5, tuple(x.shape)).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=x.dtype)

    if isinstance(tree, dict):
        drawn = {}
        for k in sorted(tree):
            drawn[k] = (_synth(tree[k], arch, rng, device) if isinstance(tree[k], dict)
                        else leaf(k, tree[k]))
        return {k: drawn[k] for k in tree}
    return leaf("", tree)


def materialize_batch(arch: ArchSpec, shape_name: str, built: BuiltStep, seed: int = 0):
    """The step's arguments after the parameters, synthesised on the
    step's device from ``np.random.default_rng(seed)`` as the reference
    draws them."""
    rng = np.random.default_rng(seed)
    return tuple(_synth(a, arch, rng, built.meta["device"]) for a in built.args[1:])


def materialize_inputs(arch: ArchSpec, shape_name: str, built: BuiltStep, seed: int = 0):
    """Concrete inputs for a built step on its device: the port's init
    seeded with ``seed`` (serving LMs in bf16, as the reference casts
    them) and :func:`materialize_batch`."""
    cfg = arch.model_cfg
    device = built.meta["device"]
    if arch.family == "lm":
        params = transformer.init_params(cfg, seed, device=device, dtype=torch.bfloat16)
    elif arch.family == "recsys":
        params = _INITS[_arch_kind(cfg)](cfg, seed, device=device)
    else:
        raise NotImplementedError(f"{arch.family} inputs come with the slice that ports its steps")
    return (params,) + materialize_batch(arch, shape_name, built, seed)
