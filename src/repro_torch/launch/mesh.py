"""Device meshes for the port's sharded serve steps.

A :class:`Mesh` is a numpy array of ``torch.device`` entries, shaped like
the mesh, with one name per axis: ``("data", "model")`` or ``("pod",
"data", "model")``. Queries are split over ``pod``/``data`` and the
document range over ``model``. One process drives every device of the
mesh (single-controller, as ``shard_map`` is): there is no process group.

``make_mesh`` takes the first ``prod(shape)`` visible cards and raises
when there are fewer; it never repeats a card. A caller that wants
several shards on one card, or CPU devices, says so with ``devices=``
(``["cpu"] * 4``, ``[torch.device("cuda", 0)] * 4``).

The model paths over a mesh move tensors between its shards through the
collectives of :mod:`repro_torch.parallel`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

DP_AXES = ("pod", "data")


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, shaped like the
    mesh; ``axis_names``: one name per axis."""

    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The mesh's first entry: where partial results meet."""
        return self.devices.flat[0]

    def grid(self) -> np.ndarray:
        """The devices as a (batch shards, model shards) array: the batch
        axes (``pod`` major, then ``data``) flattened into rows, ``model``
        the columns — the layout of ``P(("pod", "data"), ..., "model")``."""
        names = list(self.axis_names)
        other = sorted(set(names) - set(DP_AXES) - {"model"})
        if other:
            raise ValueError(f"a serving mesh has pod/data/model axes, got {other}")
        order = [names.index(a) for a in (*DP_AXES, "model") if a in names]
        return self.devices.transpose(order).reshape(-1, tp_size(self))

    def data_row(self, d: int) -> "Mesh":
        """Data shard ``d``'s devices, ``grid()[d]``, as a (1, model) mesh:
        the mesh a data shard's lookups run over."""
        return Mesh(self.grid()[d:d + 1], ("data", "model"))

    def unique_devices(self) -> list:
        """Each distinct device once, in mesh order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:<current>``), so a mesh's
    entries compare equal to its tensors' devices."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(shape: tuple, axes: tuple, devices=None) -> Mesh:
    """A mesh of ``shape`` named ``axes``. With ``devices=None`` it takes
    the first ``prod(shape)`` visible cards and raises when there are
    fewer; otherwise ``devices`` (any sequence of ``prod(shape)`` device
    names or ``torch.device`` entries, repeats allowed) fills the mesh in
    row-major order (``cuda`` taken as the current card)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a mesh of shape {shape} needs {n} cards and {have} are "
                "visible; pass devices= to place several shards on one "
                "device or to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_indexed(torch.device(d)) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a mesh of shape {shape} takes {n} devices, "
                         f"got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """Single pod: 16x16 = 256 devices (data, model). Multi-pod: 2 pods
    of 256 = 512 devices (pod, data, model). Raises unless that many
    devices are visible or given."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def dp_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in DP_AXES)


def tp_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def dp_size(mesh) -> int:
    s = 1
    for a in dp_axes_of(mesh):
        s *= mesh.shape[a]
    return s
