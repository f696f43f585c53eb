"""Decoder-only transformer LM covering the assigned dense + MoE configs
(StableLM-2-1.6B, CodeQwen1.5-7B, Qwen1.5-32B, Phi-3.5-MoE, Granite-MoE);
the reference's ``models/transformer.py``, serving side.

* the stacked layer axis is walked by a Python loop where the reference
  runs ``lax.scan``;
* GQA with optional QKV bias (Qwen) and partial rotary (StableLM);
* MoE blocks via :mod:`repro_torch.models.moe`: the dense oracle without
  a mesh, capacity dispatch on one;
* entry points: ``forward``, ``prefill``, ``decode_step``, with bf16 and
  int8 (``quantized=True``) KV caches from ``init_cache``.

The reference's sharding rules (``param_pspecs``, ``cache_pspecs``,
``_constrain``) only place arrays on a JAX mesh and have no counterpart
here; ``lm_loss`` and the microbatched gradients come with the training
slice. ``decode_step`` writes into the caches it is given and returns
them: the reference's step donates its caches, and a full-width cache
(26 GB at 32k tokens) leaves no room for a second copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models import layer_slice, make_generator, model_device, normal, torch_dtype
from repro_torch.models.layers import (
    apply_norm,
    attention_block,
    init_attention,
    init_mlp,
    init_norm,
    mlp_block,
)
from repro_torch.models.moe import MoEConfig, init_moe, moe_block, moe_block_dense_ref


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # or "layernorm"
    rotary_pct: float = 1.0
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    remat: bool = True
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Megatron-style vocab padding: embedding/lm-head tensors round the
        vocab up to a multiple of 256. Logical vocab stays cfg.vocab."""
        return -(-self.vocab // 256) * 256

    def param_count(self) -> int:
        D, H, Kv, Dh, F, V, L = (
            self.d_model, self.n_heads, self.n_kv, self.head_dim,
            self.d_ff, self.vocab, self.n_layers,
        )
        attn = D * H * Dh + 2 * D * Kv * Dh + H * Dh * D
        if self.qkv_bias:
            attn += H * Dh + 2 * Kv * Dh
        if self.moe is not None:
            E, Fe = self.moe.n_experts, self.moe.d_ff_expert
            ffn = D * E + E * (2 * D * Fe + Fe * D)
        else:
            ffn = 3 * D * F
        norms = 2 * D * (2 if self.norm == "layernorm" else 1)
        embed = V * D * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + norms) + embed + D

    def active_param_count(self) -> int:
        """For MoE: params touched per token (6*N_active*D flops rule)."""
        if self.moe is None:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        E, Fe, k = self.moe.n_experts, self.moe.d_ff_expert, self.moe.top_k
        total = self.param_count()
        ffn_all = L * E * 3 * D * Fe
        ffn_active = L * k * 3 * D * Fe
        return total - ffn_all + ffn_active


def _layer_init(cfg: TransformerConfig, *, generator, device, stack=()):
    p = {
        "ln1": init_norm(cfg.d_model, cfg.norm, device=device, stack=stack),
        "ln2": init_norm(cfg.d_model, cfg.norm, device=device, stack=stack),
        "attn": init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.qkv_bias,
                               generator=generator, device=device, stack=stack),
    }
    if cfg.moe is not None:
        p["moe"] = init_moe(cfg.d_model, cfg.moe, generator=generator, device=device, stack=stack)
    else:
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, generator=generator, device=device, stack=stack)
    return p


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def init_params(cfg: TransformerConfig, generator=0, *, device=None, dtype=torch.float32):
    """Random weights with the reference's shapes, names and scales,
    drawn from ``generator`` (a ``torch.Generator`` or a seed) on
    ``device`` (the card unless the caller names another; ``"meta"``
    gives shapes only). Layer parameters are stacked along a leading
    ``n_layers`` axis. ``dtype`` casts every floating parameter (serving
    keeps bf16 weights, as the reference's step builder does)."""
    device = model_device(device)
    gen = make_generator(generator, device)
    params = {
        "embed": normal((cfg.vocab_padded, cfg.d_model), 0.02, gen, device),
        "layers": _layer_init(cfg, generator=gen, device=device, stack=(cfg.n_layers,)),
        "final_norm": init_norm(cfg.d_model, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_padded), 1.0 / np.sqrt(cfg.d_model),
                                   gen, device)
    return _cast(params, dtype)


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------
def _block(cfg: TransformerConfig, mesh, dp_axes):
    def block(x, p_l, cache_l=None, position=0):
        h, new_cache = attention_block(
            p_l["attn"],
            apply_norm(x, p_l["ln1"], cfg.norm),
            n_heads=cfg.n_heads,
            n_kv=cfg.n_kv,
            d_head=cfg.head_dim,
            rotary_pct=cfg.rotary_pct,
            cache=cache_l,
            position=position,
        )
        x = x + h
        z = apply_norm(x, p_l["ln2"], cfg.norm)
        if cfg.moe is not None:
            if mesh is not None:
                y, aux = moe_block(p_l["moe"], z, cfg=cfg.moe, mesh=mesh, dp_axes=dp_axes)
            else:
                y, aux = moe_block_dense_ref(p_l["moe"], z, cfg=cfg.moe), 0.0
        else:
            y, aux = mlp_block(p_l["mlp"], z), 0.0
        return x + y, new_cache, aux

    return block


def _embed(cfg: TransformerConfig, params, tokens):
    """The token rows of the embedding in the compute type (the reference
    casts the table, then gathers: the same values)."""
    return params["embed"][tokens.long()].to(torch_dtype(cfg.dtype))


def _logits(cfg: TransformerConfig, params, x):
    x = apply_norm(x, params["final_norm"], cfg.norm)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return x @ head.to(x.dtype)


def forward(cfg: TransformerConfig, params, tokens, mesh=None, dp_axes=("data",)):
    """tokens (B, S) -> (logits (B, S, V), mean aux loss over layers)."""
    x = _embed(cfg, params, tokens)
    block = _block(cfg, mesh, dp_axes)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, _, a = block(x, layer_slice(params["layers"], i))
        aux = aux + a
    return _logits(cfg, params, x), aux / cfg.n_layers


def prefill(cfg: TransformerConfig, params, tokens, mesh=None, dp_axes=("data",)):
    """tokens (B, S) -> (last-position logits (B, V), stacked KV cache
    {"k", "v"} of (L, B, S, Hkv, Dh) in the compute type)."""
    x = _embed(cfg, params, tokens)
    block = _block(cfg, mesh, dp_axes)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, cache, _ = block(x, layer_slice(params["layers"], i))
        ks.append(cache["k"])
        vs.append(cache["v"])
    return _logits(cfg, params, x[:, -1:])[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(cfg: TransformerConfig, params, token, caches, position, mesh=None,
                dp_axes=("data",)):
    """token (B, 1) + caches (L-stacked k/v (L, B, Smax, Hkv, Dh), and
    k_scale/v_scale for the int8 cache) + position (an int or a 0-d
    tensor) -> (logits (B, V), the caches, updated in place)."""
    position = int(position)
    x = _embed(cfg, params, token)
    block = _block(cfg, mesh, dp_axes)
    for i in range(cfg.n_layers):
        x, _, _ = block(x, layer_slice(params["layers"], i),
                        cache_l=layer_slice(caches, i), position=position)
    return _logits(cfg, params, x)[:, 0], caches


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               quantized: bool = False, *, device=None):
    """Zeroed KV caches on ``device`` (the card unless the caller names
    another): k/v (L, B, max_len, Hkv, Dh) in ``dtype``, or int8 k/v with
    float32 k_scale/v_scale (L, B, max_len, Hkv) when ``quantized``."""
    device = model_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    if quantized:
        sshape = shape[:-1]
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
    dtype = torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
