"""A cost count of an eager step: FLOPs, bytes and transcendentals op by
op, the live-bytes high-water mark, the kernels' own work and the copies
between shards.

The reference reads these numbers from XLA (``compiled.cost_analysis()``,
``memory_analysis()`` and the HLO text). Eager PyTorch compiles nothing,
so the port counts what its step does: :func:`count` runs the step once
under :class:`CostMode`, a ``TorchDispatchMode`` that sees every aten op.
On the ``meta`` device (shapes only, no memory, no card: the counterpart
of ``jax.eval_shape`` plus a compile) a full-width step is counted on the
host in seconds to minutes.

What each op adds, in XLA's categories:

* ``flops``: the matrix products by ``torch.utils.flop_counter``'s
  formulas (2 per multiply-add); one per output element of elementwise
  arithmetic, comparison and selection; one per input element of a
  reduction; a few per element for the fused softmax and norm ops.
* ``transcendentals``: one per output element of exp, log, tanh, erf,
  rsqrt, sqrt, sigmoid, pow and the trigonometric ops (and of the
  softmaxes and SiLU/GELU, which hold one).
* ``bytes_accessed``: each op's input bytes plus its output bytes, the
  traffic of an unfused eager step. A view (``view``, ``reshape`` of a
  contiguous tensor, ``slice``, ``transpose``, ``expand``,
  ``as_strided``, ``detach``) moves nothing, nor does an allocation
  (``empty``). ``copy_``, ``fill_`` and ``zero_`` write their target
  without reading it. A gather (``index``, ``index_select``, ``gather``,
  ``embedding``) reads only the rows it returns, and an in-place scatter
  (``index_put_``, ``index_add_``, ``scatter_add_``...) reads and writes
  only the rows it updates. A broadcast input (a stride of 0) counts its
  distinct elements.

The hand-written kernels are launched through ``ctypes``, out of a
dispatch mode's sight. Under the pass (:func:`counting`) each kernel
entry point calls :func:`kernel_work` with its own work, reckoned from
shapes as PERF.md's kernel table reckons its bound, and returns outputs
of the right shapes and types without launching anything or running its
plain version.

Memory: each output storage of a non-view op counts as allocated when it
appears and released when the last tensor seen on it dies (a weakref
reference's callback), so ``peak_bytes`` is the high-water mark of
storages the step allocated; its inputs are not in it. A step marks the
boundaries of its repeated parts (:func:`layer_boundary`: the LM's layers,
forward and, through a gradient hook, backward); ``profile`` then holds
the high-water mark of each stretch between two marks, under the tag of
the mark that opens it, from which ``launch/dryrun.py`` reckons the peak
of a deeper step.

Copies between shards come from :func:`repro_torch.parallel.copy_record`,
which the pass opens around the step.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.parallel import copy_record

_ACTIVE: list = []  # the CostModes counting now, innermost last

# one FLOP per output element
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "abs", "sign", "square",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where", "remainder",
    "fmod", "floor_divide", "floor", "ceil", "round", "trunc", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "bitwise_left_shift",
    "bitwise_right_shift", "masked_fill", "relu", "threshold_backward", "isnan",
    "isinf", "nan_to_num", "sgn", "copysign", "hardtanh",
}
_TWO_FLOPS = {"addcmul", "addcdiv", "lerp", "sigmoid_backward", "tanh_backward"}
# one transcendental per output element
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "erf", "erfc",
    "erfinv", "rsqrt", "sqrt", "sigmoid", "sin", "cos", "tan", "atan", "atan2", "pow",
}
# (flops, transcendentals) per element of the first input
_FUSED = {
    "silu": (2, 1), "silu_backward": (4, 1), "gelu": (8, 1), "gelu_backward": (12, 1),
    "_softmax": (3, 1), "_log_softmax": (3, 1), "_softmax_backward_data": (3, 0),
    "_log_softmax_backward_data": (2, 1), "logsumexp": (2, 1),
    "native_layer_norm": (5, 0), "native_layer_norm_backward": (8, 0),
    "linalg_vector_norm": (2, 0), "norm": (2, 0), "var": (3, 0), "var_mean": (4, 0),
    "std": (3, 0),
}
# one FLOP per input element
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum", "cumprod", "argmax",
    "argmin", "any", "all", "nansum", "aminmax",
}
# allocations and bookkeeping: no traffic
_NO_TRAFFIC = {
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "set_", "resize_", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
}
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_", "bernoulli_"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take", "take_along_dim"}
# in-place scatters: (the values argument, or None for a scalar fill; whether
# each updated element is read as well as written)
_SCATTERS = {"index_put_": (2, None), "_index_put_impl_": (2, None), "index_add_": (3, True),
             "scatter_": (3, False), "scatter_add_": (3, True), "scatter_reduce_": (3, True),
             "index_copy_": (3, False), "index_fill_": (None, False),
             "masked_scatter_": (2, False), "index_reduce_": (3, True)}


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements ``t`` addresses: a broadcast axis
    (stride 0) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _flat(seq) -> list:
    """The tensors of an op's arguments or results, one level of lists in."""
    out = []
    for a in seq:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


_INFO: dict = {}  # op -> (name, view, moves bytes, flop kind, (flops, transcendentals))


def _op_info(func) -> tuple:
    """What an op counts, worked out once per op: per output element
    ("out") or per element of the first input ("in")."""
    name = func.__name__.split(".")[0]
    base = name.rstrip("_")
    view = func.is_view
    traffic = not view and name not in _NO_TRAFFIC
    if func.overloadpacket in flop_registry:
        return name, view, traffic, "mm", None
    if base in _ELEMENTWISE:
        return name, view, traffic, "out", (1, 0)
    if base in _TWO_FLOPS:
        return name, view, traffic, "out", (2, 0)
    if base in _TRANSCENDENTAL:
        return name, view, traffic, "out", (0, 1)
    if base in _FUSED or name in _FUSED:
        return name, view, traffic, "in", _FUSED.get(base, _FUSED.get(name))
    if base in _REDUCTIONS:
        return name, view, traffic, "in", (1, 0)
    return name, view, traffic, None, None


@dataclass
class Cost:
    """One count: totals over every op the step ran (all of a mesh's
    shards), ``matmul_flops`` the matrix products' share of ``flops``,
    ``kernels`` the hand-written kernels' share by entry point
    ({"launches", "flops", "bytes_accessed"}), ``peak_bytes`` the
    high-water mark of live storages the step allocated, ``profile`` its
    stretches between marks as (tag, high-water mark), ``copies`` the
    bytes copied between shards by kind and ``n_copies`` how many."""

    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    ops: int = 0
    kernels: dict = field(default_factory=dict)
    peak_bytes: int = 0
    profile: list = field(default_factory=list)
    copies: dict = field(default_factory=dict)
    n_copies: int = 0

    def summary(self) -> dict:
        """The reference's ``xla_cost_summary`` keys."""
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "transcendentals": self.transcendentals}


class CostMode(TorchDispatchMode):
    """Counts every aten op that runs inside it into ``self.cost``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live: dict = {}  # storage key -> [bytes, tensors seen on it]
        self._live_bytes = 0
        self._refs: dict = {}  # id -> weak reference to each tensor seen
        self._stretch = ["start", 0]  # the open stretch: its tag and high-water mark

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    # -- memory -----------------------------------------------------------
    def _release(self, key, ref) -> None:
        self._refs.pop(id(ref), None)
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live_bytes -= entry[0]
            del self._live[key]

    def _track(self, t: torch.Tensor, new: bool) -> None:
        key = _storage_key(t)
        entry = self._live.get(key)
        if entry is None:
            if not new:
                return
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self._live_bytes += entry[0]
            if self._live_bytes > self._stretch[1]:
                self._stretch[1] = self._live_bytes
                if self._live_bytes > self.cost.peak_bytes:
                    self.cost.peak_bytes = self._live_bytes
        entry[1] += 1
        ref = weakref.ref(t, lambda ref, key=key: self._release(key, ref))
        self._refs[id(ref)] = ref

    def mark(self, tag: str) -> None:
        """Close the open stretch of the live-bytes profile and open one
        under ``tag``."""
        self.cost.profile.append(tuple(self._stretch))
        self._stretch = [tag, self._live_bytes]

    def close(self) -> None:
        self.cost.profile.append(tuple(self._stretch))

    # -- the count ----------------------------------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _op_info(func)
        name, view, traffic, kind, per = info
        c = self.cost
        c.ops += 1
        ins = _flat(args) + (_flat(kwargs.values()) if kwargs else [])
        outs = [out] if isinstance(out, torch.Tensor) else _flat(out)
        in_keys = {_storage_key(t) for t in ins}
        for o in outs:
            self._track(o, new=not view and _storage_key(o) not in in_keys)
        if not traffic:
            return
        if kind == "mm":
            f = flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
            c.flops += f
            c.matmul_flops += f
        elif kind is not None and outs:
            if kind == "out":
                c.flops += per[0] * outs[0].numel()
                c.transcendentals += per[1] * outs[0].numel()
            elif ins:
                c.flops += per[0] * ins[0].numel()
                c.transcendentals += per[1] * ins[0].numel()
        c.bytes_accessed += self._traffic(name, args, ins, outs)

    @staticmethod
    def _traffic(name, args, ins, outs) -> int:
        out_ids = {id(o) for o in outs}
        if name in _GATHERS:  # the source's rows read are the output's
            read = sum(tensor_bytes(t) for t in ins if t is not args[0])
            return read + 2 * sum(tensor_bytes(o) for o in outs)
        if name in _SCATTERS:  # only the updated rows of self
            self_t = args[0]
            vi, rmw = _SCATTERS[name]
            if rmw is None:  # index_put_: accumulate reads what it adds to
                rmw = len(args) > 3 and bool(args[3])
            rest = sum(tensor_bytes(t) for t in ins if t is not self_t)
            if vi is None or not isinstance(args[vi], torch.Tensor):
                idx = args[2]  # index_fill_ and scatter_ of a scalar: (self, dim, index, value)
                n = idx.numel() * math.prod(self_t.shape[1:]) if isinstance(
                    idx, torch.Tensor) else 0
                return rest + n * self_t.element_size()
            return rest + (2 if rmw else 1) * tensor_bytes(args[vi])
        total = 0
        for t in ins:
            if id(t) in out_ids and name in _WRITE_ONLY:
                continue
            total += tensor_bytes(t)
        return total + sum(tensor_bytes(o) for o in outs)


def counting() -> bool:
    """Whether a cost count is running: a kernel entry point then reports
    its work through :func:`kernel_work` and launches nothing."""
    return bool(_ACTIVE)


LAYER, LAYERS_DONE = "layer", "layers_done"  # forward marks
LAYER_GRAD, LAYER_GRADS_DONE = "layer_grad", "layer_grads_done"  # backward marks


def mark(tag: str) -> None:
    """Open a stretch of the live-bytes profile under ``tag`` in every
    running count (an optimizer's leaf: each stretch then holds one leaf's
    temporaries, whose size follows that leaf's)."""
    for mode in _ACTIVE:
        mode.mark(tag)


def layer_boundary(x, i: int, n: int) -> None:
    """Mark the boundary before layer ``i`` of ``n`` (``i == n``: after the
    last) in every running count: ``layer`` (``layers_done``) now and,
    where ``x`` (the residual entering layer ``i``) takes a gradient,
    ``layer_grad`` (``layer_grads_done`` for layer 0) when the backward
    reaches it: the start of layer ``i - 1``'s backward. Nothing when no
    count runs."""
    if not _ACTIVE:
        return
    mark(LAYER if i < n else LAYERS_DONE)
    if isinstance(x, torch.Tensor) and x.requires_grad:
        tag = LAYER_GRAD if i > 0 else LAYER_GRADS_DONE
        x.register_hook(lambda grad: mark(tag))


def kernel_work(name: str, *, flops: float, bytes_accessed: float,
                transcendentals: float = 0.0) -> None:
    """A hand-written kernel's work, added to every running count."""
    for mode in _ACTIVE:
        c = mode.cost
        c.flops += flops
        c.bytes_accessed += bytes_accessed
        c.transcendentals += transcendentals
        k = c.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes_accessed": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes_accessed"] += bytes_accessed


def count(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run once under the pass -> (its result, the
    :class:`Cost`). Give it ``meta`` tensors to count without memory or a
    card (:func:`to_meta`)."""
    mode = CostMode()
    with copy_record() as copies, mode:
        out = fn(*args, **kwargs)
    mode.close()
    mode.cost.copies = dict(copies.bytes)
    mode.cost.n_copies = copies.count
    return out, mode.cost


def to_meta(tree):
    """A tree of dicts, lists and tuples with every tensor replaced by an
    uninitialised one of its shape and type on ``meta``."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree
