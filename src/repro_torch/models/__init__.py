"""The model zoo's serving side (the reference's ``models/``): layers,
the decoder-only transformer with its MoE blocks, embedding tables and
the four recsys models.

Parameters are dicts of tensors under the reference's key names; stacked
layer axes stay stacked. The ``init_*`` functions draw from a seeded
``torch.Generator`` on the target device (the reference draws from a
JAX key, so the two inits give different weights); :func:`carry_params`
brings the reference's own weights across, so both packages compute on
the same numbers.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.parallel import Sharded


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


def make_generator(seed, device) -> torch.Generator | None:
    """A generator seeded with ``seed`` on ``device`` (None on the meta
    device, where nothing is drawn); a generator passes through."""
    if isinstance(seed, torch.Generator):
        return seed
    device = torch.device(device)
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def normal(shape, scale, gen, device, dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a standard normal draw of ``shape``, drawn in
    float32 and scaled in place, then cast to ``dtype``; uninitialised on
    the meta device (the torch counterpart of ``jax.eval_shape``)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(float(scale)).to(dtype)


def model_device(device) -> torch.device:
    """The device a model entry point builds on: the card unless the
    caller names another (``"meta"`` for shapes only)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _leaf(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if not a.flags.writeable:  # a JAX array's host view: torch wants its own buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carried as its bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def carry_params(tree, *, device=None, dtype=None):
    """The reference's parameter pytree (nested dicts, lists or tuples of
    numpy arrays, or of anything ``np.asarray`` takes) as the port's:
    the same nesting and key names, each leaf a tensor on ``device`` (the
    card unless the caller names another), floating leaves cast to
    ``dtype`` where one is given. Stacked layer axes are kept."""
    device = resolve_device(device)

    def carry(node):
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(carry(v) for v in node)
        return _leaf(node, device, dtype)

    return carry(tree)


def _drop_lead_axis(axes: tuple) -> tuple:
    return tuple(None if a is None else a - 1 for a in axes)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree: a view of each
    leaf's first axis (of each block's, for a ``Sharded`` leaf), so writes
    into it land in the stacked tensor."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return Sharded([s[i] for s in tree.shards], tree.grid, _drop_lead_axis(tree.axes),
                       tree.spans)
    return tree[i]


def tree_leaves(tree, replicas: bool = True) -> list:
    """The leaves of a tree of dicts, lists and tuples in the reference's
    ``jax.tree.leaves`` order: dict keys sorted, sequences by index, None
    an empty subtree; a :class:`~repro_torch.parallel.Sharded` gives its
    blocks in grid order. ``replicas=False``: a ``Sharded`` whose rows are
    replicas gives its first row only, so each element comes once."""
    if isinstance(tree, Sharded):
        if not replicas and tree.axes[0] is None:
            return list(tree.shards[:tree.grid[1]])
        return list(tree.shards)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], replicas)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, replicas)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the nesting."""
    if isinstance(tree, Sharded):
        return replace(tree, shards=[fn(s, *(r.shards[i] for r in rest))
                                     for i, s in enumerate(tree.shards)])
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """``tree``'s nesting with its leaves replaced, in :func:`tree_leaves`
    order, by ``leaves``."""
    return _build(tree, iter(leaves))


def _build(node, it):
    # a module-level recursion: a recursive closure would be a reference
    # cycle holding ``it``, and with it every leaf, until the cyclic GC runs
    if isinstance(node, Sharded):
        return replace(node, shards=[next(it) for _ in node.shards])
    if isinstance(node, dict):
        out = {k: _build(node[k], it) for k in sorted(node)}
        return {k: out[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return None if node is None else next(it)


def value_and_grad(fn, params, *args):
    """(fn(params, *args), its gradient with respect to every floating
    leaf of ``params``), the loss detached: ``jax.value_and_grad`` over a
    parameter dict, through ``torch.autograd.grad``. A leaf the loss does
    not reach gets zeros, as in JAX."""
    leaves = tree_leaves(params)
    diff = [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]
    with torch.enable_grad():
        loss = fn(tree_unflatten(params, diff), *args)
    wrt = [t for t in diff if t.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for t in diff:
        g = next(got) if t.requires_grad else None
        grads.append(torch.zeros_like(t) if g is None else g)
    return loss.detach(), tree_unflatten(params, grads)


def unstack(tree, n: int) -> list:
    """The ``n`` slices of a stacked tree along its first axis, through
    ``torch.unbind``: their gradients come back as one stacked tensor per
    leaf, not one full-size buffer per slice."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if isinstance(tree, Sharded):
        per_block = [torch.unbind(s, 0) for s in tree.shards]
        axes = _drop_lead_axis(tree.axes)
        return [Sharded([b[i] for b in per_block], tree.grid, axes, tree.spans)
                for i in range(n)]
    return list(torch.unbind(tree, 0))


def remat(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    autograd records it, as ``jax.checkpoint`` wraps a function: the
    backward recomputes ``fn``'s intermediates instead of keeping them.
    The values are the same either way."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tree_leaves(list(args))):
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def n_params(tree) -> int:
    if isinstance(tree, Sharded):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    return int(tree.numel())
