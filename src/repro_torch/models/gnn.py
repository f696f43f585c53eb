"""EGNN — E(n)-equivariant graph network (Satorras et al., arXiv:2102.09844),
the reference's ``models/gnn.py``.

Message passing is a gather of the edges' endpoints, an edge MLP and a
segment sum by ``src``. Every scatter of a step, forward and backward,
goes through :mod:`repro_torch.kernels.segment_sum`: the three segment
sums of a layer through ``segment_sum`` (the reference's
``jax.ops.segment_sum``), and the gathers ``h[src]``, ``h[dst]``,
``x[src]``, ``x[dst]`` through ``gather_rows``, whose backward is the
segment sum by the same ids (XLA differentiates the reference's gathers
into scatter-adds). On a card that is the port's sorted segment-sum
kernel, so a step's sums have one order, the CPU's, in every run. The
sort of ``src`` and of ``dst`` is made once per call of :func:`forward`
and serves every layer and both passes. Padding edges carry src = dst = 0
and mask 0.

Parameters are the reference's tree: ``embed``, ``readout`` and the
layers stacked along a first axis (``edge_mlp``, ``coord_mlp``,
``node_mlp``, each ``l1``/``l2`` dense layers). :func:`init_params` is the
port's own seeded init; ``carry_params`` brings the reference's weights
across. :func:`forward` loops over the unstacked layers, as the
reference's ``scan(unroll=True)`` does. :func:`batched_forward` runs a
batch of small graphs as one block-diagonal graph (node ids offset by
graph), where the reference vmaps: each node's sums have the same terms
in the same order. The edge-sharded path (a ``mesh`` of more than one
entry) raises until the multi-device model slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels.segment_sum import gather_rows, segment_plan, segment_sum
from repro_torch.models import make_generator, model_device, unstack
from repro_torch.models.layers import dense, init_dense


@dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 16


def _mlp2_init(d_in, d_h, d_out, gen, device):
    return {"l1": init_dense(d_in, d_h, generator=gen, device=device),
            "l2": init_dense(d_h, d_out, generator=gen, device=device)}


def _mlp2(p, x):
    return dense(p["l2"], F.silu(dense(p["l1"], x)))


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: EGNNConfig, generator=0, *, device=None):
    """The EGNN's parameters, float32, drawn from a generator seeded with
    ``generator`` on ``device`` (the card unless the caller names another;
    ``"meta"`` for shapes only), the layers stacked."""
    device = model_device(device)
    gen = make_generator(generator, device)
    h = cfg.d_hidden
    layers = [{"edge_mlp": _mlp2_init(2 * h + 1, h, h, gen, device),
               "coord_mlp": _mlp2_init(h, h, 1, gen, device),
               "node_mlp": _mlp2_init(2 * h, h, h, gen, device)}
              for _ in range(cfg.n_layers)]
    return {"embed": init_dense(cfg.d_feat, h, generator=gen, device=device),
            "layers": _stack(layers),
            "readout": init_dense(h, 1, generator=gen, device=device)}


def _egnn_layer(p_l, h, x, src, dst, edge_mask):
    """One EGNN layer; ``src`` and ``dst`` are the edges' segment plans.
    Returns the aggregations (messages, coordinates, degrees)."""
    hi, hj = gather_rows(h, src), gather_rows(h, dst)
    dx = gather_rows(x, src) - gather_rows(x, dst)
    d2 = torch.sum(dx * dx, dim=-1, keepdim=True)
    m = _mlp2(p_l["edge_mlp"], torch.cat([hi, hj, d2], dim=-1))
    m = m * edge_mask[:, None].to(m.dtype)
    w = _mlp2(p_l["coord_mlp"], m)
    coord_agg = segment_sum(dx * w, src)
    msg_agg = segment_sum(m, src)
    deg = segment_sum(edge_mask.to(h.dtype), src)
    return msg_agg, coord_agg, deg


def _check_mesh(mesh) -> None:
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"the EGNN with its edges sharded over a mesh of {mesh.size} comes with the "
            "multi-device model slice")


def _propagate(cfg: EGNNConfig, params, feats, coords, src, dst, edge_mask):
    """Node embeddings and coordinates after every layer."""
    n_nodes = feats.shape[0]
    src_plan, dst_plan = segment_plan(src, n_nodes), segment_plan(dst, n_nodes)
    h = dense(params["embed"], feats)
    x = coords
    for p_l in unstack(params["layers"], cfg.n_layers):
        msg_agg, coord_agg, deg = _egnn_layer(p_l, h, x, src_plan, dst_plan, edge_mask)
        denom = torch.clamp_min(deg, 1.0)[:, None]
        x = x + coord_agg / denom  # E(n)-equivariant coordinate update
        h = h + _mlp2(p_l["node_mlp"], torch.cat([h, msg_agg / denom], dim=-1))
    return h, x


def forward(cfg: EGNNConfig, params, feats, coords, src, dst, edge_mask, mesh=None,
            edge_axes=None):
    """feats (N, F), coords (N, 3), src/dst (E,) int32, edge_mask (E,).
    Returns (node embeddings (N, Dh), coords (N, 3), graph scalar)."""
    _check_mesh(mesh)
    h, x = _propagate(cfg, params, feats, coords, src, dst, edge_mask)
    energy = dense(params["readout"], h).sum()
    return h, x, energy


def loss_fn(cfg: EGNNConfig, params, batch, mesh=None, edge_axes=None):
    """Node-level regression (energy-style): MSE of per-node readout."""
    h, _, _ = forward(cfg, params, batch["feats"], batch["coords"], batch["src"],
                      batch["dst"], batch["edge_mask"], mesh=mesh, edge_axes=edge_axes)
    pred = dense(params["readout"], h)[:, 0]
    mask = batch["node_mask"].to(pred.dtype)
    err = (pred - batch["targets"]) ** 2 * mask
    return err.sum() / torch.clamp_min(mask.sum(), 1.0)


def batched_forward(cfg: EGNNConfig, params, batch):
    """A batch of small graphs (the ``molecule`` shape): feats (Bt, N, F),
    coords (Bt, N, 3), src/dst/edge_mask (Bt, E) -> (h (Bt, N, Dh), coords
    (Bt, N, 3), energy (Bt,)), as one block-diagonal graph of Bt x N
    nodes."""
    feats = batch["feats"]
    Bt, N = feats.shape[:2]
    shift = (torch.arange(Bt, dtype=torch.int32, device=feats.device) * N)[:, None]
    h, x = _propagate(cfg, params, feats.reshape(Bt * N, -1), batch["coords"].reshape(Bt * N, 3),
                      (batch["src"] + shift).reshape(-1), (batch["dst"] + shift).reshape(-1),
                      batch["edge_mask"].reshape(-1))
    energy = dense(params["readout"], h).reshape(Bt, N).sum(dim=-1)
    return h.reshape(Bt, N, -1), x.reshape(Bt, N, 3), energy


def batched_loss(cfg: EGNNConfig, params, batch):
    h, _, _ = batched_forward(cfg, params, batch)
    pred = dense(params["readout"], h)[..., 0]
    mask = batch["node_mask"].to(pred.dtype)
    err = (pred - batch["targets"]) ** 2 * mask
    return err.sum() / torch.clamp_min(mask.sum(), 1.0)
