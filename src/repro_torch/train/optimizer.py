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
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models import tree_leaves, tree_map

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
    """sqrt of the float32 sum of squares over every leaf, the leaves added
    in tree order."""
    total = None
    for leaf in tree_leaves(tree):
        sq = None
        for part in _slices(leaf.detach()):
            s = part.float().square().sum()
            sq = s if sq is None else sq + s
        if sq is None:
            sq = torch.zeros((), dtype=torch.float32, device=leaf.device)
        total = sq if total is None else total + sq
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
    with torch.no_grad():
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state["mu"]), tree_leaves(state["nu"])):
            for ps, gs, ms, ns in zip(_slices(p), _slices(g), _slices(mu), _slices(nu)):
                gf = gs.float() * scale
                ms.mul_(b1).add_(gf * omb1)
                ns.mul_(b2).add_(gf.square_().mul_(omb2))
                pf = ps.float()
                upd = (ms / bc1).div_((ns / bc2).sqrt_().add_(eps)).add_(pf * wd)
                ps.copy_(pf.sub_(upd.mul_(lr)))
    state["step"] = step
    return params, state, gnorm
