"""Mixture-of-Experts FFN with top-k routing (the reference's
``models/moe.py``).

Two paths, as in the reference. :func:`moe_block_dense_ref` computes
every expert for every token and combines the top-k exactly; it is what
a transformer block runs without a mesh. :func:`moe_block` is the
capacity-dispatch path (GShard-style dropping, one trash slot) that a
block runs on a mesh: per data shard, C = ceil(T_local * top_k *
capacity_factor / E) slots per expert. Over a model axis of tp > 1 the
experts are split over the ranks (expert parallelism, the reference's
``shard_map``): rank r owns experts [r E/tp, (r+1) E/tp), runs the
dispatch for them on its device at the same capacity, and the ranks'
partial outputs are added in rank order on the lead device
(``parallel.py`` ``sum_to_lead``, the reference's psum). Each (data,
model) shard runs on its own device of the mesh's grid; the tokens reach
it through ``replicate`` and the router and its experts through the
step's ``parallel.MeshPlan``, so every gradient across shards is added in
shard order.

The gates' top-k is a stable descending sort, so the lower expert comes
first among equal probabilities, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel import replicate, sum_to_lead
from repro_torch.models import normal


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


def init_moe(d_model: int, cfg: MoEConfig, *, generator, device, stack=()):
    E, Fe = cfg.n_experts, cfg.d_ff_expert
    s_in = 1.0 / np.sqrt(d_model)
    s_out = 1.0 / np.sqrt(Fe)
    return {
        "router": normal((*stack, d_model, E), s_in, generator, device),
        "w_gate": normal((*stack, E, d_model, Fe), s_in, generator, device),
        "w_up": normal((*stack, E, d_model, Fe), s_in, generator, device),
        "w_down": normal((*stack, E, Fe, d_model), s_out, generator, device),
    }


def top_k_stable(x, k: int):
    """``lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, order), order


def _gates(p, xf, cfg: MoEConfig):
    """Router probabilities (float32) and the normalised top-k gates."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = top_k_stable(probs, cfg.top_k)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate_w, gate_e


def _experts(ex_in, p, dt):
    g = F.silu(torch.einsum("ecd,edf->ecf", ex_in, p["w_gate"].to(dt)))
    u = torch.einsum("ecd,edf->ecf", ex_in, p["w_up"].to(dt))
    return torch.einsum("ecf,efd->ecd", g * u, p["w_down"].to(dt))


def _local_moe(p, x, *, cfg: MoEConfig, n_local_experts: int, expert_offset: int,
               capacity: int):
    """Token dispatch for the experts one rank owns: x (T, D) ->
    (partial y (T, D), load-balance aux loss term)."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    probs, gate_w, gate_e = _gates(p, x, cfg)

    # position of each (token, choice) in its expert's queue (GShard)
    flat_e = gate_e.reshape(-1)  # (T*k,), row-major by token
    oh = F.one_hot(flat_e, E).to(torch.int32)
    pos = (torch.cumsum(oh, dim=0) * oh - 1).amax(dim=-1)
    keep = (pos >= 0) & (pos < capacity)
    local_e = flat_e - expert_offset
    mine = keep & (local_e >= 0) & (local_e < n_local_experts)
    slot = torch.where(mine, local_e * capacity + pos,
                       torch.full_like(pos, n_local_experts * capacity))

    # token rows into expert slots; one trash slot at the end
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    mine_dt = mine[:, None].to(dt)
    buf = torch.zeros((n_local_experts * capacity + 1, D), dtype=dt, device=x.device)
    buf.index_add_(0, slot, x[tok_idx] * mine_dt)
    ex_out = _experts(buf[:-1].reshape(n_local_experts, capacity, D), p, dt)

    # combine: gather back, weight by gate, add a token's k choices in order
    flat_out = torch.cat([ex_out.reshape(n_local_experts * capacity, D),
                          torch.zeros((1, D), dtype=dt, device=x.device)])
    contrib = (flat_out[slot] * gate_w.reshape(-1, 1).to(dt)) * mine_dt
    contrib = contrib.reshape(T, k, D)
    y = torch.zeros((T, D), dtype=dt, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]

    # Switch-style load-balance aux
    frac_tokens = F.one_hot(gate_e[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return y, aux


def moe_capacity(cfg: MoEConfig, t_local: int) -> int:
    """Slots per expert for a data shard of ``t_local`` tokens (GShard)."""
    return max(int(np.ceil(t_local * cfg.top_k * cfg.capacity_factor / cfg.n_experts)), 1)


def moe_block(p, xs, *, cfg: MoEConfig, plan):
    """Capacity dispatch over ``plan`` (a ``parallel.MeshPlan``): ``xs[d]``
    (B_d, S, D) is data shard d's residual on its lead device, as the
    tensor-parallel block leaves it. Rank r of each row runs experts
    [r E/tp, (r+1) E/tp) with the router and its block of ``p`` on its
    device, at the data shard's own capacity -> (each data shard's y on
    its lead device, the aux loss averaged over the data shards on the
    mesh's lead device)."""
    tp = plan.tp
    if cfg.n_experts % tp:
        raise ValueError(f"{cfg.n_experts} experts do not split over {tp} ranks")
    n_local = cfg.n_experts // tp
    spans = [(r * n_local, (r + 1) * n_local) for r in range(tp)]
    rows = plan.tree_views(p, tp, {k: (0, spans, 1) for k in ("w_gate", "w_up", "w_down")})
    ys, auxes = [], []
    for d, x in enumerate(xs):
        B, S, D = x.shape
        capacity = moe_capacity(cfg, B * S)
        parts = []
        for r, (p_r, x_r) in enumerate(zip(rows[d], replicate(x.reshape(B * S, D),
                                                              plan.row(d, tp)))):
            y, aux = _local_moe(p_r, x_r, cfg=cfg, n_local_experts=n_local,
                                expert_offset=r * n_local, capacity=capacity)
            parts.append(y)
            if r == 0:  # every rank routes the same tokens: rank 0's aux is the shard's
                auxes.append(aux.to(plan.mesh_lead))
        ys.append(sum_to_lead(parts, plan.lead(d)).reshape(B, S, D))
    return ys, torch.stack(auxes).mean()


def moe_block_dense_ref(p, x, *, cfg: MoEConfig):
    """Oracle: dense per-expert compute + exact top-k combine (no capacity
    drops). The combine weights are added in ``x.dtype`` in the order
    k = 0..top_k-1."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    _, gate_w, gate_e = _gates(p, xf, cfg)
    dt = x.dtype
    g = F.silu(torch.einsum("td,edf->tef", xf, p["w_gate"].to(dt)))
    u = torch.einsum("td,edf->tef", xf, p["w_up"].to(dt))
    all_out = torch.einsum("tef,efd->ted", g * u, p["w_down"].to(dt))
    combine = torch.zeros((T, cfg.n_experts), dtype=dt, device=x.device)
    rows = torch.arange(T, device=x.device)
    for j in range(cfg.top_k):
        combine.index_put_((rows, gate_e[:, j]), gate_w[:, j].to(dt), accumulate=True)
    y = torch.einsum("te,ted->td", combine, all_out)
    return y.reshape(B, S, D)
