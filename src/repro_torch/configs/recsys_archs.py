"""The four assigned recsys architectures + their shared shape set."""

from __future__ import annotations

from dataclasses import replace

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.recsys import DINConfig, SeqRecConfig, TwoTowerConfig

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65_536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_048_576}),
}

_SMOKE_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 32}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 8}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 64}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 256}),
}

N_NEG = 255  # sampled-softmax negatives for sequential recommenders


def _reduce_seqrec(spec: ArchSpec) -> ArchSpec:
    cfg = replace(spec.model_cfg, n_items=1024, embed_dim=16, n_blocks=1, n_heads=2, seq_len=12)
    return ArchSpec(spec.arch_id + "-smoke", "recsys", cfg, dict(_SMOKE_SHAPES), {}, None, spec.source)


def _reduce_din(spec: ArchSpec) -> ArchSpec:
    cfg = replace(spec.model_cfg, n_items=1024, n_cates=64, embed_dim=8, seq_len=10)
    return ArchSpec(spec.arch_id + "-smoke", "recsys", cfg, dict(_SMOKE_SHAPES), {}, None, spec.source)


def _reduce_tt(spec: ArchSpec) -> ArchSpec:
    cfg = replace(spec.model_cfg, n_items=1024, n_cates=64, embed_dim=16, tower=(32, 24, 16), hist_len=8)
    return ArchSpec(spec.arch_id + "-smoke", "recsys", cfg, dict(_SMOKE_SHAPES), {}, None, spec.source)


BERT4REC = ArchSpec(
    "bert4rec", "recsys",
    SeqRecConfig(name="bert4rec", n_items=1_048_576, embed_dim=64, n_blocks=2,
                 n_heads=2, seq_len=200, causal=False),
    dict(RECSYS_SHAPES), reduce_fn=_reduce_seqrec,
    source="arXiv:1904.06690 (BERT4Rec: d=64, 2 blocks, 2 heads, seq 200)",
)

SASREC = ArchSpec(
    "sasrec", "recsys",
    SeqRecConfig(name="sasrec", n_items=1_048_576, embed_dim=50, n_blocks=2,
                 n_heads=1, seq_len=50, causal=True),
    dict(RECSYS_SHAPES), reduce_fn=_reduce_seqrec,
    source="arXiv:1808.09781 (SASRec: d=50, 2 blocks, 1 head, seq 50)",
)

DIN = ArchSpec(
    "din", "recsys",
    DINConfig(name="din", n_items=10_000_000, n_cates=100_000, embed_dim=18,
              seq_len=100, attn_mlp=(80, 40), mlp=(200, 80)),
    dict(RECSYS_SHAPES), reduce_fn=_reduce_din,
    source="arXiv:1706.06978 (DIN: d=18, attn MLP 80-40, MLP 200-80, seq 100)",
)

TWO_TOWER = ArchSpec(
    "two-tower-retrieval", "recsys",
    TwoTowerConfig(name="two-tower-retrieval", n_items=10_000_000, n_cates=100_000,
                   embed_dim=256, tower=(1024, 512, 256), hist_len=50),
    dict(RECSYS_SHAPES), reduce_fn=_reduce_tt,
    source="RecSys'19 (YouTube two-tower, sampled softmax + logQ)",
)

RECSYS_ARCHS = [BERT4REC, DIN, TWO_TOWER, SASREC]
