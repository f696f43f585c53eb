"""Central --arch registry."""

from __future__ import annotations

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.gnn_archs import GNN_ARCHS
from repro_torch.configs.lm_archs import LM_ARCHS
from repro_torch.configs.proximity_search import SEARCH_ARCH
from repro_torch.configs.recsys_archs import RECSYS_ARCHS

ALL_ARCHS: list[ArchSpec] = LM_ARCHS + GNN_ARCHS + RECSYS_ARCHS + [SEARCH_ARCH]

ARCHS: dict[str, ArchSpec] = {a.arch_id: a for a in ALL_ARCHS}

ASSIGNED_ARCH_IDS = [a.arch_id for a in LM_ARCHS + GNN_ARCHS + RECSYS_ARCHS]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown --arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
