"""Architecture/shape registry for the dry-run and smoke tests.

Every assigned architecture gets an ArchSpec with:
  * model_cfg — the exact published configuration;
  * shapes — its assigned input-shape cells (kind: train/prefill/decode/
    serve/retrieval), each lowered by launch/steps.py;
  * skips — cells that are inapplicable (with the reason recorded, e.g.
    long_500k on pure full-attention LMs, per the brief);
  * reduced() — a structurally identical small config for CPU smoke tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval
    dims: dict


@dataclass
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | search
    model_cfg: Any
    shapes: dict
    skips: dict = field(default_factory=dict)  # shape name -> reason
    reduce_fn: Callable | None = None
    source: str = ""

    def reduced(self):
        assert self.reduce_fn is not None
        return self.reduce_fn(self)


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
}

LM_FULL_ATTENTION_SKIP = (
    "long_500k requires sub-quadratic attention; this arch is pure full "
    "(GQA) attention — skipped per brief, see DESIGN.md §6"
)
