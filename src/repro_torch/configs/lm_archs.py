"""The five assigned LM-family architectures (exact published configs)."""

from __future__ import annotations

from dataclasses import replace

from repro_torch.configs.base import ArchSpec, LM_FULL_ATTENTION_SKIP, LM_SHAPES, ShapeSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def _reduce_lm(spec: ArchSpec) -> ArchSpec:
    cfg = spec.model_cfg
    moe = cfg.moe
    if moe is not None:
        moe = MoEConfig(n_experts=4, top_k=min(moe.top_k, 2), d_ff_expert=64,
                        capacity_factor=moe.capacity_factor)
    small = replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=max(1, min(cfg.n_kv, 2)) if cfg.n_kv < cfg.n_heads else 4,
        d_head=16,
        d_ff=128,
        vocab=512,
        moe=moe,
        remat=False,
    )
    shapes = {
        "train_4k": ShapeSpec("train_4k", "train", {"seq_len": 64, "global_batch": 4}),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill", {"seq_len": 96, "global_batch": 2}),
        "decode_32k": ShapeSpec("decode_32k", "decode", {"seq_len": 96, "global_batch": 4}),
    }
    return ArchSpec(spec.arch_id + "-smoke", "lm", small, shapes, dict(spec.skips), None, spec.source)


def _lm(arch_id: str, cfg: TransformerConfig, source: str) -> ArchSpec:
    shapes = {k: v for k, v in LM_SHAPES.items() if k != "long_500k"}
    return ArchSpec(
        arch_id=arch_id,
        family="lm",
        model_cfg=cfg,
        shapes=shapes,
        skips={"long_500k": LM_FULL_ATTENTION_SKIP},
        reduce_fn=_reduce_lm,
        source=source,
    )


STABLELM_1_6B = _lm(
    "stablelm-1.6b",
    TransformerConfig(
        name="stablelm-1.6b",
        n_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=5632, vocab=100352,
        qkv_bias=False, norm="layernorm", rotary_pct=0.25, tie_embeddings=False,
    ),
    "hf:stabilityai/stablelm-2-1_6b",
)

CODEQWEN_7B = _lm(
    "codeqwen1.5-7b",
    TransformerConfig(
        name="codeqwen1.5-7b",
        n_layers=32, d_model=4096, n_heads=32, n_kv=32, d_ff=13440, vocab=92416,
        qkv_bias=True, norm="rmsnorm", rotary_pct=1.0,
    ),
    "hf:Qwen/CodeQwen1.5-7B",
)

QWEN_32B = _lm(
    "qwen1.5-32b",
    TransformerConfig(
        name="qwen1.5-32b",
        n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392, vocab=152064,
        qkv_bias=True, norm="rmsnorm", rotary_pct=1.0,
    ),
    "hf:Qwen/Qwen1.5-32B (QKV bias per Qwen1.5 family)",
)

PHI35_MOE = _lm(
    "phi3.5-moe-42b-a6.6b",
    TransformerConfig(
        name="phi3.5-moe-42b-a6.6b",
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400, vocab=32064,
        qkv_bias=False, norm="layernorm", rotary_pct=1.0,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    ),
    "hf:microsoft/Phi-3.5-MoE-instruct",
)

GRANITE_MOE = _lm(
    "granite-moe-1b-a400m",
    TransformerConfig(
        name="granite-moe-1b-a400m",
        n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512, vocab=49155,
        qkv_bias=False, norm="rmsnorm", rotary_pct=1.0, tie_embeddings=True,
        moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    ),
    "hf:ibm-granite/granite-3.0-1b-a400m-base",
)

LM_ARCHS = [STABLELM_1_6B, CODEQWEN_7B, QWEN_32B, PHI35_MOE, GRANITE_MOE]
