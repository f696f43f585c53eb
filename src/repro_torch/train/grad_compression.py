"""Gradient compression for the data-parallel mean (the reference's
``train/grad_compression.py``).

* int8 quantization with a per-tensor scale: each data shard quantizes
  its local gradient, the shards' int8 payloads and scales are gathered
  onto every shard, which dequantizes and takes the mean;
* top-k sparsification with error feedback: only the k largest-magnitude
  entries are exchanged; the residual stays in the shard's error state.

:func:`make_compressed_dp_train_step` runs over the port's
single-controller :class:`repro_torch.launch.mesh.Mesh`, as the sharded
serve steps do, with no ``torch.distributed``: the parameters are
replicated on every data shard's device, the batch is split along its
leading axis and each shard takes its own gradients. The "all-gather"
copies each shard's payload (int8 values and scale, or top-k values and
indices) onto the lead shard's device, which forms the mean and makes the
update there, where the state lives. Every other shard would form the
same mean from the same payloads and make the same update, so the port
makes it once (the reference makes it on every rank).

The error-feedback state is per shard: the reference returns each rank's
own residual under a replicated out-spec with replication checking off,
so every device keeps its own. The port's step takes and returns the
state as a list of per-shard trees. Top-k is a stable sort, the lower index first among equal
magnitudes, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import RECIP_127
from repro_torch.models import tree_leaves, tree_map, tree_unflatten, value_and_grad
from repro_torch.train.optimizer import adamw_update


def quantize_int8(x: torch.Tensor, generator: torch.Generator | None = None):
    """Per-tensor symmetric int8: (q int8, scale float32). Without a
    generator, rounding is half to even (``jnp.round``); with one,
    stochastic: ``floor(y + u)``, u uniform in [0, 1) from the generator
    (the reference draws u from a JAX key, so the two give other bits)."""
    scale = torch.clamp_min(x.abs().amax(), 1e-12) * RECIP_127
    y = x / scale
    if generator is not None:
        y = torch.floor(y + torch.rand(x.shape, generator=generator, device=x.device))
    else:
        y = torch.round(y)
    q = torch.clamp(y, -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, err: torch.Tensor, k: int):
    """Error-feedback top-k: (values, int32 indices, new error)."""
    flat = x.reshape(-1) + err.reshape(-1)
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    sel = flat[idx]
    new_flat = flat.clone()
    new_flat[idx] = 0.0
    return sel, idx.to(torch.int32), new_flat.reshape(x.shape)


def _sum(xs):
    total = None
    for x in xs:
        total = x if total is None else total + x
    return total


def _shard_means(gs, errs, lead, scheme: str, topk_frac: float):
    """One leaf's mean over the shards' gradients ``gs``, formed on
    ``lead`` from the gathered payloads, and each shard's new error."""
    n = len(gs)
    if scheme == "int8":
        payloads = [quantize_int8(g) for g in gs]
        qs = torch.stack([q.to(lead) for q, _ in payloads])
        ss = torch.stack([s.to(lead) for _, s in payloads])
        deq = qs.float() * ss.reshape((-1,) + (1,) * (qs.dim() - 1))
        return deq.mean(dim=0), errs
    if scheme == "topk":
        k = max(1, int(gs[0].numel() * topk_frac))
        picks = [topk_sparsify(g, e, k) for g, e in zip(gs, errs)]
        vals = torch.cat([v.to(lead) for v, _, _ in picks])
        idx = torch.cat([i.to(lead) for _, i, _ in picks])
        dense = torch.zeros(gs[0].numel(), dtype=torch.float32, device=lead)
        dense.index_put_((idx.long(),), vals, accumulate=True)
        return (dense / n).reshape(gs[0].shape), [e for _, _, e in picks]
    return _sum(g.to(lead) for g in gs) / n, errs  # exact baseline


def make_compressed_dp_train_step(loss_fn, opt_cfg, mesh, dp_axis="data",
                                  scheme="int8", topk_frac: float = 0.01):
    """Explicit-DP train step with compressed gradient synchronization
    over ``mesh``'s ``dp_axis``: returns step(params, opt_state, errs,
    batch) -> (params, opt_state, errs, metrics), ``errs`` a list of one
    error state per data shard (``[init_error_state(params)] * n`` on the
    first step). ``loss_fn(params,
    batch)`` returns a scalar tensor; ``params`` and ``opt_state`` live on
    the lead shard's device and are updated in place (see the module
    docstring)."""
    axis = mesh.axis_names.index(dp_axis)
    devices = [mesh.devices[(0,) * axis + (i,) + (0,) * (mesh.devices.ndim - axis - 1)]
               for i in range(mesh.devices.shape[axis])]
    n, lead = len(devices), devices[0]

    def step(params, opt_state, errs, batch):
        if len(errs) != n:
            raise ValueError(f"{len(errs)} error states for {n} data shards")
        rows = {int(x.shape[0]) for x in tree_leaves(batch)}
        if len(rows) != 1 or rows.pop() % n:
            raise ValueError(f"the batch's leading axes do not split over {n} data shards")
        losses, grads = [], []
        for r, dev in enumerate(devices):
            local = tree_map(lambda x: x.chunk(n, dim=0)[r].to(dev), batch)
            loss, g = value_and_grad(loss_fn, tree_map(lambda p: p.to(dev), params), local)
            losses.append(loss)
            grads.append(tree_leaves(g))
        flat_e = [tree_leaves(tree_map(lambda e: e.to(dev), e_r))
                  for e_r, dev in zip(errs, devices)]
        means, new_errs = [], [[] for _ in devices]
        for j in range(len(grads[0])):
            m, es = _shard_means([g[j].float() for g in grads], [e[j] for e in flat_e],
                                 lead, scheme, topk_frac)
            means.append(m)
            for r, e in enumerate(es):
                new_errs[r].append(e)
        loss = _sum(x.to(lead) for x in losses) / n
        params, opt_state, gnorm = adamw_update(opt_cfg, params, tree_unflatten(params, means), opt_state)
        return (params, opt_state, [tree_unflatten(params, e) for e in new_errs],
                {"loss": loss, "grad_norm": gnorm})

    return step


def init_error_state(grads_abs):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                    grads_abs)
