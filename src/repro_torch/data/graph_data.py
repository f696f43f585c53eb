"""Graph data pipeline (the reference's ``data/graph_data.py``, numpy
only, copied): synthetic graph generators + the fanout neighbor sampler
required by the minibatch_lg shape (seeds=1024, fanout 15-10,
GraphSAGE-style layered sampling over a CSR adjacency). The same seeds
give the reference's arrays."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,)
    n_nodes: int

    @classmethod
    def random(cls, n_nodes: int, avg_degree: int, seed: int = 0) -> "CSRGraph":
        rng = np.random.default_rng(seed)
        # power-law-ish degrees (Zipf-bounded)
        deg = np.minimum(
            rng.zipf(1.6, n_nodes).astype(np.int64) + avg_degree // 2, 50 * avg_degree
        )
        deg = (deg * (avg_degree / max(deg.mean(), 1))).astype(np.int64)
        deg = np.maximum(deg, 1)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = rng.integers(0, n_nodes, int(indptr[-1])).astype(np.int32)
        return cls(indptr, indices, n_nodes)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]


def sample_fanout_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanout: tuple,
    rng: np.random.Generator,
    pad_nodes: int,
    pad_edges: int,
):
    """Layered fanout sampling (GraphSAGE): hop h samples up to fanout[h]
    neighbors per frontier node. Returns a padded edge-list subgraph with
    relabelled node ids, masks marking real entries, and the seed mask.

    Vectorized: per hop, neighbor draws are a single gather of random
    offsets into the CSR index range of every frontier node."""
    node_ids = list(seeds.astype(np.int64))
    id_of = {int(v): i for i, v in enumerate(node_ids)}
    src_l, dst_l = [], []
    frontier = seeds.astype(np.int64)
    for f in fanout:
        if frontier.size == 0:
            break
        starts = graph.indptr[frontier]
        degs = graph.indptr[frontier + 1] - starts
        k = np.minimum(degs, f)
        total = int(k.sum())
        if total == 0:
            break
        owner = np.repeat(np.arange(frontier.size), k)
        # random offsets within each node's adjacency range
        u = rng.random(total)
        offs = (u * degs[owner]).astype(np.int64)
        nbrs = graph.indices[starts[owner] + offs].astype(np.int64)
        new_frontier = []
        for s_node, d_node in zip(frontier[owner].tolist(), nbrs.tolist()):
            if d_node not in id_of:
                id_of[d_node] = len(node_ids)
                node_ids.append(d_node)
                new_frontier.append(d_node)
            src_l.append(id_of[s_node])
            dst_l.append(id_of[d_node])
        frontier = np.array(new_frontier, np.int64)
    n_real = len(node_ids)
    e_real = len(src_l)
    if n_real > pad_nodes or e_real > pad_edges:
        raise ValueError(f"subgraph exceeds padding: {n_real}/{pad_nodes} nodes, {e_real}/{pad_edges} edges")
    src = np.zeros(pad_edges, np.int32)
    dst = np.zeros(pad_edges, np.int32)
    src[:e_real] = src_l
    dst[:e_real] = dst_l
    edge_mask = np.zeros(pad_edges, np.float32)
    edge_mask[:e_real] = 1.0
    node_mask = np.zeros(pad_nodes, np.float32)
    node_mask[:n_real] = 1.0
    nodes = np.zeros(pad_nodes, np.int64)
    nodes[:n_real] = node_ids
    seed_mask = np.zeros(pad_nodes, np.float32)
    seed_mask[: seeds.size] = 1.0  # seeds are the first node ids by construction
    return {
        "nodes": nodes,
        "src": src,
        "dst": dst,
        "edge_mask": edge_mask,
        "node_mask": node_mask,
        "seed_mask": seed_mask,
        "n_real_nodes": n_real,
        "n_real_edges": e_real,
    }


def minibatch_stream(
    graph: CSRGraph,
    feats: np.ndarray,
    targets: np.ndarray,
    batch_nodes: int,
    fanout: tuple,
    pad_nodes: int,
    pad_edges: int,
    seed: int = 0,
):
    """Infinite generator of sampled-training batches (minibatch_lg)."""
    rng = np.random.default_rng(seed)
    while True:
        seeds = rng.choice(graph.n_nodes, size=batch_nodes, replace=False)
        sub = sample_fanout_subgraph(graph, seeds, fanout, rng, pad_nodes, pad_edges)
        yield {
            "feats": feats[sub["nodes"]] * sub["node_mask"][:, None],
            "coords": rng.normal(size=(pad_nodes, 3)).astype(np.float32),
            "src": sub["src"],
            "dst": sub["dst"],
            "edge_mask": sub["edge_mask"],
            "node_mask": sub["node_mask"],
            "targets": targets[sub["nodes"]] * sub["node_mask"],
        }
