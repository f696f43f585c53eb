"""EGNN architecture + its four assigned graph shapes."""

from __future__ import annotations

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.gnn import EGNNConfig

# sampled-subgraph sizes for minibatch_lg (Reddit: 232,965 nodes,
# 114,615,892 edges, d=602; seeds=1024, fanout 15-10):
#   nodes <= 1024 * (1 + 15 + 150) = 170,  -> pad to 172032
#   edges <= 1024 * (15 + 150)      = 168,960 -> pad to 172032
_MINIBATCH_NODES = 172_032
_MINIBATCH_EDGES = 172_032

EGNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train",
        {"n_nodes": 2_708, "n_edges": 10_556, "d_feat": 1_433, "batched": False},
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train",
        {"n_nodes": _MINIBATCH_NODES, "n_edges": _MINIBATCH_EDGES, "d_feat": 602,
         "batched": False, "sampled": True, "seeds": 1024, "fanout": (15, 10)},
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "train",
        {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100, "batched": False},
    ),
    "molecule": ShapeSpec(
        "molecule", "train",
        {"n_nodes": 30, "n_edges": 64, "d_feat": 16, "batch": 128, "batched": True},
    ),
}


def _reduce_egnn(spec: ArchSpec) -> ArchSpec:
    shapes = {
        "full_graph_sm": ShapeSpec("full_graph_sm", "train",
                                   {"n_nodes": 40, "n_edges": 120, "d_feat": 24, "batched": False}),
        "minibatch_lg": ShapeSpec("minibatch_lg", "train",
                                  {"n_nodes": 64, "n_edges": 128, "d_feat": 24, "batched": False,
                                   "sampled": True, "seeds": 4, "fanout": (3, 2)}),
        "molecule": ShapeSpec("molecule", "train",
                              {"n_nodes": 8, "n_edges": 16, "d_feat": 8, "batch": 4, "batched": True}),
    }
    cfg = EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16, d_feat=24)
    return ArchSpec(spec.arch_id + "-smoke", "gnn", cfg, shapes, {}, None, spec.source)


EGNN_ARCH = ArchSpec(
    arch_id="egnn",
    family="gnn",
    model_cfg=EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_feat=1433),
    shapes=EGNN_SHAPES,
    reduce_fn=_reduce_egnn,
    source="arXiv:2102.09844 (EGNN, E(n)-equivariant)",
)

GNN_ARCHS = [EGNN_ARCH]
