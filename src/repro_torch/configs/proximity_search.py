"""The paper's own engine as a dry-runnable architecture (family 'search').

Shapes mirror the serving regimes of the recsys set: a latency-bound
online batch, a bulk offline batch, and a heavy cell with long posting
lists (frequent stop-lemma triples) — the paper's worst case."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchSpec, ShapeSpec


@dataclass(frozen=True)
class SearchConfig:
    name: str = "proximity-search"
    max_distance: int = 5
    top_k: int = 16
    n_keys: int = 2  # (f,s,t) keys per query (queries of 3-5 words)


SEARCH_SHAPES = {
    "qt1_serve": ShapeSpec("qt1_serve", "search", {"batch": 4096, "postings": 65_536}),
    "qt1_p99": ShapeSpec("qt1_p99", "search", {"batch": 512, "postings": 65_536}),
    "qt1_bulk": ShapeSpec("qt1_bulk", "search", {"batch": 32_768, "postings": 65_536}),
    "qt1_heavy": ShapeSpec("qt1_heavy", "search", {"batch": 256, "postings": 1_048_576}),
}

_SMOKE = {
    "qt1_serve": ShapeSpec("qt1_serve", "search", {"batch": 8, "postings": 256}),
    "qt1_heavy": ShapeSpec("qt1_heavy", "search", {"batch": 2, "postings": 1024}),
}


def _reduce(spec: ArchSpec) -> ArchSpec:
    return ArchSpec(spec.arch_id + "-smoke", "search", spec.model_cfg, dict(_SMOKE), {}, None, spec.source)


SEARCH_ARCH = ArchSpec(
    "proximity-search", "search", SearchConfig(), dict(SEARCH_SHAPES),
    reduce_fn=_reduce, source="this paper (Veretennikov 2020)",
)
