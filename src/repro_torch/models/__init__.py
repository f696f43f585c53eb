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

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


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


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree: a view of each
    leaf's first axis, so writes into it land in the stacked tensor."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    return int(tree.numel())
