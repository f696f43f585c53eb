"""AdamW over parameter dicts of tensors (the reference's
``train/optimizer.py``).

The arithmetic is the reference's, op for op and in its order, in
float32: the clip scale ``min(1, clip / (gnorm + 1e-9))``, the bias
corrections ``1 - b**t`` with ``t`` the float32 step, and
``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``. Every Python-float
constant is rounded to float32 first, as JAX's weakly typed scalars are.

Departure: :func:`adamw_update` writes into ``params``, ``mu`` and ``nu``
and returns them. The reference's jitted steps donate those buffers
(``launch/steps.py``, ``donate_argnums=(0, 1)``); at full width there is
no room for a second copy (two-tower-retrieval's parameters and moments
are 31 GB). A large leaf is updated in slices of :data:`CHUNK` elements,
so the update's temporaries stay small; elementwise, slicing changes no
rounding.

A sharded parameter (``parallel.py`` ``Sharded``: a row-sharded table,
an LM weight split over FSDP rows and TP columns) is one leaf per block,
each on its own device: each is updated in place where it lives, with the
clip scale and bias corrections copied there, and the global norm adds
each block's sum of squares on the first leaf's device in one fixed order
(tree order, a grid's blocks row by row). The reference's norm runs over
the whole array at once, so the two agree within rounding. A ``Sharded``
whose rows are replicas (a parameter held once per data shard) counts
its first row only in the norm, and every replica is updated with the
same arithmetic on the same gradient, so the replicas on devices of one
kind stay equal to the bit (the built train steps sum the replicas'
gradients first: ``parallel.all_reduce``). The host's float32 ``sqrt``
is not the card's: it is an ulp off the correctly rounded root on some
elements (``tools/adamw_root_check.py``), so a replica on the host
drifts from one on the card by about that much.
Leaves on several devices are updated a slice of each device in turn,
so that every device's queue stays fed while the one thread launches
the others' work (a device's whole update first would leave the others
idle once its queue is full). Under a cost count each leaf's norm and
update opens a stretch of the live-bytes profile (``obs/cost.py``
``mark``), so a deeper step's peak can be reckoned leaf by leaf.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models import tree_leaves, tree_map
from repro_torch.obs.cost import mark

CHUNK = 1 << 24  # elements per slice of a leaf's update and norm


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak scalar."""
    return float(np.float32(x))


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    for s in range(0, flat.numel(), CHUNK):
        yield flat[s:s + CHUNK]


def init_opt_state(params):
    """``mu`` and ``nu`` zeros like the parameters, ``step`` an int32
    scalar on the device of the first parameter."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, each element
    once (a replicated ``Sharded``'s first row), the leaves added in tree
    order on the first leaf's device."""
    total = None
    for leaf in tree_leaves(tree, replicas=False):
        mark("leaf")
        sq = None
        for part in _slices(leaf.detach()):
            s = part.float().square().sum()
            sq = s if sq is None else sq + s
        if sq is None:
            sq = torch.zeros((), dtype=torch.float32, device=leaf.device)
        total = sq if total is None else total + sq.to(total.device)
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step: (params, state, gnorm), with ``params`` and the
    state's ``mu``/``nu`` updated in place (see the module docstring)."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(torch.full_like(gnorm, _f32(cfg.grad_clip))
                            / (gnorm + _f32(1e-9)), 1.0)
    step = state["step"] + 1
    t = step.float()
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    omb1, omb2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    lr, eps, wd = _f32(cfg.lr), _f32(cfg.eps), _f32(cfg.weight_decay)
    bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
    on = {gnorm.device: (scale, bc1, bc2)}  # the step's scalars, per device
    leaves = {}  # each device's leaves, in tree order
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        if p.device not in on:
            on[p.device] = tuple(v.to(p.device) for v in on[gnorm.device])
        leaves.setdefault(p.device, []).append((p, g, mu, nu))

    def update(dev):  # one slice of the device's update a turn
        scale, bc1, bc2 = on[dev]
        for p, g, mu, nu in leaves[dev]:
            mark("leaf")
            for ps, gs, ms, ns in zip(_slices(p), _slices(g), _slices(mu), _slices(nu)):
                gf = gs.float() * scale
                ms.mul_(b1).add_(gf * omb1)
                ns.mul_(b2).add_(gf.square_().mul_(omb2))
                pf = ps.float()
                upd = (ms / bc1).div_((ns / bc2).sqrt_().add_(eps)).add_(pf * wd)
                ps.copy_(pf.sub_(upd.mul_(lr)))
                yield

    with torch.no_grad():
        turns = [update(dev) for dev in leaves]
        while turns:
            turns = [t for t in turns if next(t, t) is not t]
    state["step"] = step
    return params, state, gnorm
