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
makes it once (the reference makes it on every rank). The collectives are
public over a list of per-rank tensors: :func:`int8_allreduce_mean` and
:func:`topk_allreduce_mean` (the reference's, over a mesh axis).

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


def int8_allreduce_mean(xs, lead, generator=None) -> torch.Tensor:
    """The mean of the ranks' tensors ``xs`` (one per rank, each on its
    rank's device) exchanging int8: each rank quantizes its own, the int8
    payloads and scales are copied to ``lead``, dequantized and averaged
    there. Without a generator the rounding is half to even, the
    reference's ``key=None``; ``generator`` (one ``torch.Generator``, or
    one per rank on the rank's device) rounds stochastically, each rank
    drawing in rank order. The dequantized payloads are added rank by rank
    from zero, each with one rounding, then divided by the rank count: the
    reference's compiled step, to the bit."""
    gens = generator if isinstance(generator, (list, tuple)) else [generator] * len(xs)
    total = torch.zeros(xs[0].shape, dtype=torch.float32, device=lead)
    for q, s in (quantize_int8(x, g) for x, g in zip(xs, gens)):
        # q * scale added with one rounding, the fused multiply-add XLA makes
        # of the reference's dequantize-and-mean: in float64 the product (8 by
        # 24 bits) is exact, and so is its sum with the float32 total unless
        # the two lie more than 2^22 apart in magnitude
        total = (total.double() + q.to(lead).double() * s.to(lead).double()).float()
    return total / len(xs)


def topk_allreduce_mean(xs, errs, k: int, lead):
    """The mean of the ranks' tensors ``xs`` exchanging each rank's k
    largest-magnitude entries of ``x + err`` (values and int32 indices,
    copied to ``lead`` and added there into a dense buffer, rank by rank);
    returns (the mean on ``lead``, each rank's new error state on its
    device)."""
    picks = [topk_sparsify(x, e, k) for x, e in zip(xs, errs)]
    vals = torch.cat([v.to(lead) for v, _, _ in picks])
    idx = torch.cat([i.to(lead) for _, i, _ in picks])
    dense = torch.zeros(xs[0].numel(), dtype=torch.float32, device=lead)
    dense.index_put_((idx.long(),), vals, accumulate=True)
    return (dense / len(xs)).reshape(xs[0].shape), [e for _, _, e in picks]


def _tree_compress_mean(grads, errs, lead, scheme: str, topk_frac: float):
    """Per leaf, the mean over the ranks' gradient trees ``grads`` on
    ``lead`` (int8, top-k or exact) and each rank's new error tree."""
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in errs]
    means, new_errs = [], [[] for _ in grads]
    for j in range(len(flat_g[0])):
        gs, es = [g[j].float() for g in flat_g], [e[j] for e in flat_e]
        if scheme == "int8":
            m = int8_allreduce_mean(gs, lead)
        elif scheme == "topk":
            m, es = topk_allreduce_mean(gs, es, max(1, int(gs[0].numel() * topk_frac)), lead)
        else:  # exact baseline
            m = _sum(g.to(lead) for g in gs) / len(gs)
        means.append(m)
        for r, e in enumerate(es):
            new_errs[r].append(e)
    return (tree_unflatten(grads[0], means),
            [tree_unflatten(e_r, new) for e_r, new in zip(errs, new_errs)])


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
            grads.append(g)
        errs = [tree_map(lambda e: e.to(dev), e_r) for e_r, dev in zip(errs, devices)]
        means, errs = _tree_compress_mean(grads, errs, lead, scheme, topk_frac)
        loss = _sum(x.to(lead) for x in losses) / n
        params, opt_state, gnorm = adamw_update(opt_cfg, params, means, opt_state)
        return params, opt_state, errs, {"loss": loss, "grad_norm": gnorm}

    return step


def init_error_state(grads_abs):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                    grads_abs)
