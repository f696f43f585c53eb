"""Step builders: (arch x shape x mesh) -> step + abstract inputs (the
reference's ``launch/steps.py``).

For every cell of the four families (LM train, prefill and decode; the
EGNN's train steps; recsys train, serve and retrieval; the search arch's
QT1 serve step) :func:`build_step` returns a :class:`BuiltStep`: the step
function, its abstract arguments as tensors on the ``meta`` device (the
torch counterpart of ``jax.eval_shape``: shapes and types, no memory) and
metadata for the roofline (model params, layers, tokens or edges or
postings; ``n_micro`` and ``bf16_gather`` for LM training) and
``meta["device"]``, the mesh's lead device, where the inputs go and the
outputs come back. The port has no sharding annotations; each family
places its work on the mesh (``launch/mesh.py``, one process driving
every device):

* LM: Megatron tensor parallelism over the model axis and, for
  training, FSDP over the data axis, as the reference's
  ``param_pspecs``/``fsdpify`` place them (``transformer.py`` names the
  departures). :func:`place_params` keeps each split leaf as a
  ``Sharded`` grid of blocks, block (i, j) on ``grid[i, j]`` (FSDP blocks
  on the first pod's data rows); the step gathers a layer's blocks inside
  the layer (``parallel.gather_blocks``), runs each model shard's heads
  (or, where whole heads do not split, its q/k/v columns and a sequence
  block), ``d_ff`` columns or experts on its device, and adds the
  partials on each data shard's first device. Serving keeps the weights
  TP-split, a replica per data shard where their devices differ, the
  decode cache per ``cache_pspecs``. A mesh of one shard runs the
  one-device path. The microbatch rule divides by the data shards.
* GNN: the unbatched loss with its edges sharded over every mesh axis
  (the reference's ``all_axes``), the batched (molecule) loss with its
  graphs split over the data axes.
* recsys: data-parallel as the reference's ``batch_pspec`` places the
  batch: rows over the data shards where B > 1 and they divide it,
  retrieval's candidates where they divide them, else unsplit (computed
  once on the lead device). Each table that the reference row-shards
  over the model axis (``recsys.row_sharded``) is a ``Sharded`` with a
  block per (data shard, model shard), every other leaf once per data
  shard on its lead device, as the reference replicates them over the
  data axes (where the data shards' devices differ: on one device nothing
  is duplicated). Data shard d runs its lookups over its row of blocks
  and its dense layers on its lead device (``recsys.DataShards``); a
  train step sums each replicated leaf's gradient over its replicas in
  shard order before AdamW, so the replicas stay equal to the bit: a
  table's over the rows its lookups read (``parallel.all_reduce_rows``)
  where that moves fewer bytes than the dense sum
  (``parallel.all_reduce``), which every other leaf takes.
* search: doc-sharded over the model axis, as the serving path is.

:func:`materialize_inputs` makes concrete inputs: the port's own seeded
init (float32 masters and ``init_opt_state`` for training, bf16 weights
for LM serving), placed by :func:`place_params`, and the reference's
synthetic batch, the same numpy draws in the same order.

A train step is ``(params, opt_state, batch) -> (params, opt_state,
{"loss", "grad_norm"})``. It updates ``params`` and the moments in place
and returns them: the reference's jitted step donates them, and at full
width there is no room for a second copy. A leaf held once per data
shard (:func:`place_leaf`) has its replicas' gradients summed
(:func:`sum_replicas`), its moments follow it, and the norm counts it
once.

:func:`build_lm_layer_probe` builds one transformer layer with the
cell's placement, the roofline's per-layer cost (``launch/dryrun.py``).
:func:`placed_args` gives a built step's abstract arguments where it
expects them, for a count on ``meta``. ``REPRO_KV_INT8=1`` (the
quantized decode cache), ``REPRO_PAD_HEADS=1``, ``REPRO_MICRO_STACK_GIB``, ``REPRO_BF16_GATHER``
and ``REPRO_SEARCH_COMPRESSED`` are read where the reference reads them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.configs.recsys_archs import N_NEG
from repro_torch.kernels.common import SENTINEL
from repro_torch.launch.mesh import dp_axes_of, dp_size, tp_size
from repro_torch.parallel import MeshPlan, Sharded, all_reduce, all_reduce_rows, rows_move_less
from repro_torch.models import gnn, n_params, recsys, torch_dtype, transformer, value_and_grad
from repro_torch.models.embedding import touched_rows
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state

F32 = torch.float32
I32 = torch.int32
META = torch.device("meta")
NP_INTS = {torch.int32: np.int32, torch.int8: np.int8}
SEARCH_MODES = ("", "offsets", "delta")  # REPRO_SEARCH_COMPRESSED


@dataclass
class BuiltStep:
    fn: Any  # the step: call it with concrete arguments
    args: tuple  # abstract (meta-device tensor) trees, positional
    meta: dict = field(default_factory=dict)


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def fsdpify(pspecs, abstract_params, mesh, axis="data"):
    """The reference's FSDP rule: ``axis`` on the first free dimension of
    each leaf that it divides (skipping the stacked layer axis of a leaf
    under ``layers`` or ``blocks``). ``mesh`` is anything whose ``shape``
    maps axis names to sizes."""
    fs = mesh.shape.get(axis, 1)
    if fs == 1:
        return pspecs

    def walk(spec, arr, names):
        if isinstance(spec, dict):
            return {k: walk(spec[k], arr[k], names + (k,)) for k in spec}
        shape = tuple(arr.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i in range(1 if "layers" in names or "blocks" in names else 0, len(shape)):
            if parts[i] is None and shape[i] % fs == 0 and shape[i] >= fs:
                parts[i] = axis
                break
        return tuple(parts)

    return walk(pspecs, abstract_params, ())


def _axis_of(spec, name: str):
    hits = [i for i, e in enumerate(spec) if e == name or (isinstance(e, tuple) and name in e)]
    return hits[0] if hits else None


def place_leaf(x: torch.Tensor, spec: tuple, mesh):
    """``x`` placed per its spec on the mesh: split over the first pod's
    data rows along its ``data`` axis and over the model columns along
    its ``model`` axis, each block a contiguous tensor on its grid device
    (a ``Sharded``). A leaf not split over the data rows is kept once per
    data shard where the data shards' devices differ (always on a mesh of
    ``meta`` entries, which stands for distinct devices), as the reference
    replicates it over the data axes, so that no step copies weights
    between them; where they share the devices, once. A leaf kept in one
    block stays whole on the lead device."""
    grid = mesh.grid()
    axes = (_axis_of(spec, "data"), _axis_of(spec, "model"))
    cols = grid.shape[1] if axes[1] is not None else 1
    differ = (grid[:, :cols] != grid[:1, :cols]).any() or grid[0, 0].type == "meta"
    if axes[0] is not None:
        rows = mesh.shape.get("data", 1)
    elif differ:
        rows = grid.shape[0]
    else:
        rows = 1
    if rows == cols == 1:
        return x.to(grid[0, 0])
    return Sharded.split(x, grid[:rows, :cols], axes)


def _place_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs if isinstance(specs, tuple) else specs[k], mesh)
                for k, v in tree.items()}
    return place_leaf(tree, specs, mesh)


def sum_replicas(grads, touched=None):
    """A gradient tree with each leaf held once per data shard (a
    ``Sharded`` whose rows are replicas) summed over its replicas, column
    by column, in shard order, every replica the same bits; every other
    leaf as it is. ``touched`` is a tree like ``grads`` giving, for each
    block, the rows its lookups read (``embedding.TouchedRows.tree``) or
    None: a table column whose every replica has them is summed over
    them (``parallel.all_reduce_rows``) where that moves fewer bytes a
    device (``parallel.rows_move_less``, from the shapes), every other
    column densely (``parallel.all_reduce``). The two give the same
    bits."""
    if isinstance(grads, dict):
        return {k: sum_replicas(v, None if touched is None else touched.get(k))
                for k, v in grads.items()}
    if not (isinstance(grads, Sharded) and grads.axes[0] is None and grads.grid[0] > 1):
        return grads
    rows, cols = grads.grid
    summed = []
    for j in range(cols):
        col = [grads.block(i, j) for i in range(rows)]
        ids = None if touched is None else [touched[i * cols + j] for i in range(rows)]
        if (ids is not None and all(x is not None for x in ids)
                and rows_move_less(rows, max(x.numel() for x in ids), col[0].shape)):
            summed.append(all_reduce_rows(col, ids))
        else:
            summed.append(all_reduce(col))
    return replace(grads, shards=[summed[j][i] for i in range(rows) for j in range(cols)])


def grads_and_rows(loss, params, batch) -> tuple:
    """(loss, its gradients, the rows each table block's lookups read, a
    tree like the gradients) of ``loss(params, batch)``, for
    :func:`sum_replicas`."""
    seen = []

    def watched(p, b):
        seen.append(p)
        return loss(p, b)

    with touched_rows() as touched:
        value, grads = value_and_grad(watched, params, batch)
    return value, grads, touched.tree(seen[0])


# ==========================================================================
# LM family
# ==========================================================================
def pad_heads_cfg(cfg, tp: int):
    """Round the head count up to a TP multiple (Qwen-32B: 40 -> 48 on
    TP=16). Numerically equivalent when the pad-head projections are
    zero."""
    if cfg.n_heads % tp == 0:
        return cfg
    pad_to = -(-cfg.n_heads // tp) * tp
    kv = cfg.n_kv if cfg.n_kv % tp == 0 or cfg.n_kv != cfg.n_heads else pad_to
    return replace(cfg, n_heads=pad_to, n_kv=kv, d_head=cfg.head_dim)


def build_lm_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    cfg = arch.model_cfg
    dp_ax = dp_axes_of(mesh)
    tp = tp_size(mesh)
    if os.environ.get("REPRO_PAD_HEADS", "0") == "1":
        cfg = pad_heads_cfg(cfg, tp)
    dims = shape.dims
    B, S = dims["global_batch"], dims["seq_len"]
    meta = {
        "cfg": cfg,
        "model_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "n_layers": cfg.n_layers,
        "tokens": B * S if shape.kind != "decode" else B,
        "device": mesh.lead,
        "mesh": mesh,
        "devices": [str(d) for d in mesh.grid().flat],
        "kind": shape.kind,
    }
    if shape.kind == "train":
        params_abs = transformer.init_params(cfg, device=META)
        meta["pspecs"] = fsdpify(transformer.param_pspecs(cfg, tp), params_abs, mesh)
        # reduced (smoke/example) configs train faster with a higher LR
        opt_cfg = AdamWConfig(lr=1e-3) if cfg.d_model <= 128 else AdamWConfig()
        # microbatching: bound the remat residual stack (L x Bmicro x S x D
        # bf16) per device, the reference's rule and budget
        stack_gib = float(os.environ.get("REPRO_MICRO_STACK_GIB", "2"))
        b_local = max(B // dp_size(mesh), 1)
        stack_bytes = lambda bm: cfg.n_layers * bm * S * cfg.d_model * 2  # noqa: E731
        micro_local = b_local
        while micro_local > 1 and stack_bytes(micro_local) > stack_gib * 2**30:
            micro_local //= 2
        # a shape may fix the count (the dry run's counts at one and two
        # microbatches of the full shape's microbatch size)
        n_micro = dims.get("n_micro", b_local // micro_local)
        meta["n_micro"] = n_micro
        bf16_gather = os.environ.get("REPRO_BF16_GATHER", "1") != "0"
        meta["bf16_gather"] = bf16_gather

        def step(params, opt_state, batch):
            loss, grads = transformer.lm_grads_microbatched(
                cfg, params, batch["tokens"], batch["targets"], n_micro, mesh, dp_ax,
                bf16_gather=bf16_gather)
            grads = sum_replicas(grads)
            params, opt_state, gnorm = adamw_update(opt_cfg, params, grads, opt_state)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm}

        batch_abs = {"tokens": _abstract((B, S), I32), "targets": _abstract((B, S), I32)}
        return BuiltStep(step, (params_abs, init_opt_state(params_abs), batch_abs), meta)

    # serving: bf16 params (production serving never keeps f32 masters)
    params_abs = transformer.init_params(cfg, device=META, dtype=torch.bfloat16)
    meta["pspecs"] = transformer.param_pspecs(cfg, tp)
    if shape.kind == "prefill":
        def step(params, tokens):
            return transformer.prefill(cfg, params, tokens, mesh, dp_ax)

        return BuiltStep(step, (params_abs, _abstract((B, S), I32)), meta)

    # decode: one new token against an S-long KV cache.
    kv_int8 = os.environ.get("REPRO_KV_INT8", "0") == "1"
    meta["kv_cache"] = "int8" if kv_int8 else "bf16"
    cache_abs = transformer.init_cache(cfg, B, S, quantized=kv_int8, device=META)
    meta["cache_pspecs"] = transformer.cache_pspecs(cfg, tp, dp_ax, seq_len=S, quantized=kv_int8)

    def step(params, token, caches, position):
        return transformer.decode_step(cfg, params, token, caches, position, mesh, dp_ax)

    return BuiltStep(step, (params_abs, _abstract((B, 1), I32), cache_abs,
                            _abstract((), I32)), meta)


def _unit_layer(c):
    """A one-layer cache (or a ``Sharded`` of them) as a stack of one
    layer: views, so writes land in it."""
    if isinstance(c, Sharded):
        return Sharded([s.unsqueeze(0) for s in c.shards], c.grid,
                       tuple(None if a is None else a + 1 for a in c.axes), c.spans)
    return c.unsqueeze(0)


def build_lm_layer_probe(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    """One transformer layer with the cell's placement (its TP layer over
    the mesh, the weights per ``param_pspecs(cfg, tp, stacked=False)``, as
    :func:`place_params` places them), as the reference's probe builds it
    to give the roofline a layer's cost:

    * ``train``: ``(x, layer) -> (loss, (dx, dlayer))``, the loss
      ``sum(y.float()) + aux``;
    * ``prefill``: ``(x, layer) -> (y, cache)``;
    * ``decode``: ``(x, layer, cache, position) -> (y, cache)``, the cache
      (B, S, Hkv, Dh) bf16 whatever ``REPRO_KV_INT8`` says (as the
      reference's probe), updated in place.

    ``x`` is (B, S, d_model) in the compute type ((B, 1, d_model) for
    decode) and the layer's weights float32, abstract on ``meta``. Over a
    mesh of several shards ``y`` comes back on the mesh's lead device and
    the cache as each shard's, [d][r]."""
    cfg = arch.model_cfg
    dp_ax = dp_axes_of(mesh)
    tp = tp_size(mesh)
    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    dt = torch_dtype(cfg.dtype)
    layer_abs = transformer._layer_init(cfg, generator=None, device=META)
    meta = {"n_layers": 1, "cfg": cfg, "mesh": mesh, "kind": shape.kind, "device": mesh.lead,
            "probe": True, "pspecs": transformer.param_pspecs(cfg, tp, stacked=False)["layers"]}
    one = transformer._one_device(mesh)
    plan = MeshPlan(mesh, dp_ax) if one else transformer._Plan(cfg, mesh, dp_ax)
    block = transformer._block(cfg, plan) if one else None

    def layer(x, p_l, cache=None, position=0):
        """(y, the cache(s), aux) of the layer at ``x``."""
        if one:
            return block(x, p_l, cache_l=cache, position=position)
        views = None
        if cache is not None:
            views = transformer._cache_views(
                plan, {k: _unit_layer(v) for k, v in cache.items()}, 0,
                plan.cache_cols(cache["k"].shape[1]))
        ys, aux, caches = transformer._mesh_layer(cfg, plan, p_l, plan.split_batch(x),
                                                  views, position)
        y = ys[0] if len(ys) == 1 else torch.cat([t.to(plan.mesh_lead) for t in ys])
        return y, (cache if cache is not None else caches), aux

    if shape.kind == "train":
        def probe(x, p_l):
            def f(args):
                y, _, aux = layer(args["x"], args["p"])
                return torch.sum(y.float()) + aux

            loss, grads = value_and_grad(f, {"x": x, "p": p_l})
            return loss, (grads["x"], sum_replicas(grads["p"]))

        return BuiltStep(probe, (_abstract((B, S, cfg.d_model), dt), layer_abs), meta)

    if shape.kind == "prefill":
        def probe(x, p_l):
            y, cache, _ = layer(x, p_l)
            return y, cache

        return BuiltStep(probe, (_abstract((B, S, cfg.d_model), dt), layer_abs), meta)

    meta["cache_pspecs"] = transformer.cache_pspecs(cfg, tp, dp_ax, seq_len=S)
    cache_abs = {k: _abstract((B, S, cfg.n_kv, cfg.head_dim), torch.bfloat16)
                 for k in ("k", "v")}

    def probe(x, p_l, cache_l, position):
        y, new_cache, _ = layer(x, p_l, cache_l, position)
        return y, new_cache

    return BuiltStep(probe, (_abstract((B, 1, cfg.d_model), dt), layer_abs, cache_abs,
                             _abstract((), I32)), meta)


# ==========================================================================
# GNN family (EGNN)
# ==========================================================================
GNN_EDGE_MULTIPLE = 512  # the reference pads the edge axis to shard over 256 or 512 devices


def build_gnn_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    """The EGNN train step: the batched (block-diagonal, ``molecule``)
    loss over the data axes or the unbatched loss with its edges sharded
    over every mesh axis, autograd, then AdamW (lr 1e-3, no weight decay)
    in place on the lead device. The unbatched edge axis is padded to a
    multiple of 512 (pad edges carry mask 0), as the reference pads it."""
    dims = shape.dims
    cfg = replace(arch.model_cfg, d_feat=dims["d_feat"])
    params_abs = gnn.init_params(cfg, device=META)
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.0)
    meta = {
        "n_layers": cfg.n_layers,
        "model_params": n_params(params_abs),
        "n_edges": dims["n_edges"] * dims.get("batch", 1),
        "device": mesh.lead,
    }
    batched = bool(dims.get("batched"))
    lead = (dims["batch"],) if batched else ()
    N, E = dims["n_nodes"], dims["n_edges"]
    if not batched:
        E = -(-E // GNN_EDGE_MULTIPLE) * GNN_EDGE_MULTIPLE
    nodes, edges = lead + (N,), lead + (E,)
    batch_abs = {
        "feats": _abstract(nodes + (dims["d_feat"],), F32),
        "coords": _abstract(nodes + (3,), F32),
        "src": _abstract(edges, I32),
        "dst": _abstract(edges, I32),
        "edge_mask": _abstract(edges, F32),
        "node_mask": _abstract(nodes, F32),
        "targets": _abstract(nodes, F32),
    }

    def loss(p, batch):
        if batched:
            return gnn.batched_loss(cfg, p, batch, mesh, dp_axes_of(mesh))
        return gnn.loss_fn(cfg, p, batch, mesh=mesh, edge_axes=tuple(mesh.axis_names))

    def step(params, opt_state, batch):
        value, grads = value_and_grad(loss, params, batch)
        params, opt_state, gnorm = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": value, "grad_norm": gnorm}

    return BuiltStep(step, (params_abs, init_opt_state(params_abs), batch_abs), meta)


# ==========================================================================
# search family (the paper's engine)
# ==========================================================================
def build_search_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    """The QT1 serve step over the arch's (B, K, L) posting rows.
    ``REPRO_SEARCH_COMPRESSED``, read here: unset or empty for the raw
    payload (three int32 streams), ``offsets`` for uint8 fragment offsets
    beside the int32 keys, ``delta`` for offsets and block-delta16 uint16
    keys. The step runs on the mesh's first device, or doc-sharded over a
    mesh of several (``core/torch_search.py``)."""
    from repro_torch.core.torch_search import (
        make_qt1_serve_step,
        make_qt1_serve_step_compressed,
    )

    cfg = arch.model_cfg
    dims = shape.dims
    B, L, K = dims["batch"], dims["postings"], cfg.n_keys
    mode = os.environ.get("REPRO_SEARCH_COMPRESSED", "")
    if mode not in SEARCH_MODES:
        raise ValueError(f"REPRO_SEARCH_COMPRESSED={mode!r}: want one of {SEARCH_MODES}")
    meta = {"n_layers": 1, "model_params": 0, "postings": B * K * L,
            "search_mode": mode or "baseline", "device": mesh.devices.flat[0]}
    vec = (_abstract((B,), F32), _abstract((B,), F32))
    if mode == "delta":
        fn = make_qt1_serve_step_compressed(top_k=cfg.top_k, delta_g=True, mesh=mesh)
        args = (_abstract((B, K, L // 64), I32), _abstract((B, K, L), torch.uint16),
                _abstract((B, K, L), torch.uint8), _abstract((B, K, L), torch.uint8)) + vec
    elif mode == "offsets":
        fn = make_qt1_serve_step_compressed(top_k=cfg.top_k, delta_g=False, mesh=mesh)
        args = (_abstract((B, K, 1), I32), _abstract((B, K, L), I32),
                _abstract((B, K, L), torch.uint8), _abstract((B, K, L), torch.uint8)) + vec
    else:
        fn = make_qt1_serve_step(top_k=cfg.top_k, mesh=mesh)
        args = tuple(_abstract((B, K, L), I32) for _ in range(3)) + vec
    return BuiltStep(fn, args, meta)


# ==========================================================================
# RecSys family
# ==========================================================================
def _arch_kind(cfg) -> str:
    return ("seqrec" if isinstance(cfg, recsys.SeqRecConfig)
            else "din" if isinstance(cfg, recsys.DINConfig)
            else "twotower")


_INITS = {"seqrec": recsys.seqrec_init, "din": recsys.din_init,
          "twotower": recsys.twotower_init}


def _sharded_tables(params_abs, tp: int) -> tuple:
    """The tables the reference row-shards over the model axis
    (``_recsys_param_pspecs``)."""
    return tuple(name for name, t in params_abs.items()
                 if isinstance(t, torch.Tensor) and recsys.row_sharded(name, t.shape, tp))


def place_params(built: BuiltStep, params):
    """A step's parameters where it expects them (:func:`place_leaf`: a
    leaf the data axes do not split once per data shard where their
    devices differ). An LM's per the step's ``meta["pspecs"]``: on a mesh
    of one device a split leaf's column blocks are contiguous copies, its
    row blocks too. A recsys step's row-sharded tables over the model
    columns (row views of the table where a block's device is the
    table's, so a mesh of one device copies nothing), every other leaf
    whole. Other families' parameters pass through."""
    if "pspecs" in built.meta:
        return _place_tree(params, built.meta["pspecs"], built.meta["mesh"])
    if "sharded_tables" not in built.meta:
        return params
    names = built.meta["sharded_tables"]
    return {k: _place_tree(v, ("model", None) if k in names else (), built.meta["mesh"])
            for k, v in params.items()}


def place_caches(built: BuiltStep, caches: dict, stacked: bool = True) -> dict:
    """A decode step's whole caches per its ``meta["cache_pspecs"]``: block
    (d, r) of each a contiguous tensor on ``grid[d, r]``, data shard d's
    batch rows and model shard r's part: the kv heads its q heads read
    (shared kv heads copied into each shard that reads them), or, where
    attention splits inside heads, positions [r S / tp, (r + 1) S / tp)
    of every kv head; whole tensors on the lead device of a (1, 1) grid.
    ``stacked=False``: one layer's caches (a layer probe's), without the
    layer axis."""
    mesh = built.meta["mesh"]
    grid = mesh.grid()
    spec = built.meta["cache_pspecs"]["k"]
    model = spec.index("model") if "model" in spec else None
    cols = grid.shape[1] if model is not None else 1
    if grid.shape[0] == cols == 1:
        return {k: v.to(grid[0, 0]) for k, v in caches.items()}
    lead = 1 if stacked else 0
    spans = None
    if cols > 1 and model == 3:
        spans = transformer.head_spans(built.meta["cfg"], cols)[1]
    axis = None if model is None else model - 1 + lead
    return {k: Sharded.split(v, grid[:, :cols], (lead, axis), spans)
            for k, v in caches.items()}


def placed_args(built: BuiltStep) -> tuple:
    """A built step's abstract arguments where it expects them, for a cost
    count on ``meta``: the parameters by :func:`place_params` (a layer
    probe's layer likewise) and a train step's optimizer state made from
    them; a decode step's caches by :func:`place_caches` and its position
    the cache's last row, S - 1 (the step then attends over the whole
    cache, as the reference's program does at every position)."""
    args = list(built.args)
    meta = built.meta
    if meta.get("probe"):
        args[1] = _place_tree(args[1], meta["pspecs"], meta["mesh"])
        if meta["kind"] == "decode":
            args[2] = place_caches(built, args[2], stacked=False)
            args[3] = built.args[2]["k"].shape[1] - 1
        return tuple(args)
    args[0] = place_params(built, args[0])
    if len(args) == 3 and isinstance(args[1], dict) and "step" in args[1]:
        args[1] = init_opt_state(args[0])
    if "cache_pspecs" in meta:
        args[2] = place_caches(built, args[2])
        args[3] = built.args[2]["k"].shape[2] - 1
    return tuple(args)


def _recsys_batch(cfg, arch_kind: str, kind: str, dims: dict) -> dict:
    """The reference's train, serve and retrieval batches, as abstract
    tensors."""
    B = dims["batch"]
    i32 = lambda *s: _abstract(s, I32)  # noqa: E731
    f32 = lambda *s: _abstract(s, F32)  # noqa: E731
    if arch_kind == "seqrec":
        S = cfg.seq_len
        if kind == "train":
            return {"hist": i32(B, S), "target": i32(B), "negatives": i32(B, N_NEG)}
        if kind == "serve":
            return {"hist": i32(B, S), "candidates": i32(B, 100)}
        return {"hist": i32(1, S), "candidates": i32(1, dims["n_candidates"])}
    if arch_kind == "din":
        S = cfg.seq_len
        if kind == "retrieval":
            C = dims["n_candidates"]
            return {"hist_items": i32(1, S), "hist_cates": i32(1, S), "cand_items": i32(C),
                    "cand_cates": i32(C), "user_feats": f32(1, cfg.d_user)}
        batch = {"hist_items": i32(B, S), "hist_cates": i32(B, S), "target_item": i32(B),
                 "target_cate": i32(B), "user_feats": f32(B, cfg.d_user)}
        if kind == "train":
            batch["labels"] = f32(B)
        return batch
    if kind == "retrieval":
        C = dims["n_candidates"]
        return {"hist": i32(1, cfg.hist_len), "user_feats": f32(1, cfg.d_user),
                "cand_items": i32(C), "cand_cates": i32(C)}
    batch = {"hist": i32(B, cfg.hist_len), "user_feats": f32(B, cfg.d_user),
             "item": i32(B), "cate": i32(B)}
    if kind == "train":
        batch["log_q"] = f32(B)
    return batch


def build_recsys_step(arch: ArchSpec, shape: ShapeSpec, mesh) -> BuiltStep:
    """A recsys train, serve or retrieval step, data-parallel where the
    reference's ``batch_pspec`` splits the batch (see the module
    docstring): ``meta["split"]`` names what goes over the data shards,
    ``rows``, ``candidates`` or None."""
    cfg = arch.model_cfg
    kind = shape.kind
    arch_kind = _arch_kind(cfg)
    params_abs = _INITS[arch_kind](cfg, device=META)
    sharded = _sharded_tables(params_abs, tp_size(mesh))
    shards = recsys.DataShards(mesh, lookups=bool(sharded))
    dp, B, C = shards.dp, shape.dims["batch"], shape.dims.get("n_candidates", 0)
    if dp > 1 and B > 1 and B % dp == 0:
        split = "rows"
    elif dp > 1 and kind == "retrieval" and C % dp == 0:
        split = "candidates"
    else:
        split = None
    meta = {
        "n_layers": getattr(cfg, "n_blocks", 1),
        "model_params": n_params(params_abs),
        "device": mesh.lead,
        "mesh": mesh,
        "kind": kind,
        "sharded_tables": sharded,
        "split": split,
    }
    batch_abs = _recsys_batch(cfg, arch_kind, kind, shape.dims)

    if kind == "train":
        opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.0)
        loss_fn = {"seqrec": recsys.seqrec_loss, "din": recsys.din_loss,
                   "twotower": recsys.twotower_loss}[arch_kind]
        row_losses = {"seqrec": recsys.seqrec_row_losses, "din": recsys.din_row_losses}

        def loss(params, batch):
            if split is None:
                return shards.once(lambda *a: loss_fn(cfg, *a), params, batch)
            if arch_kind == "twotower":
                return recsys.twotower_loss_over(cfg, params, batch, shards)
            return shards.mean(lambda *a: row_losses[arch_kind](cfg, *a), params, batch)

        def step(params, opt_state, batch):
            value, grads, touched = grads_and_rows(loss, params, batch)
            grads = sum_replicas(grads, touched)
            params, opt_state, gnorm = adamw_update(opt_cfg, params, grads, opt_state)
            return params, opt_state, {"loss": value, "grad_norm": gnorm}

        return BuiltStep(step, (params_abs, init_opt_state(params_abs), batch_abs), meta)

    if kind == "serve":
        fn = {"seqrec": recsys.seqrec_score, "din": recsys.din_forward,
              "twotower": recsys.twotower_score}[arch_kind]
        f = lambda *a: fn(cfg, *a)  # noqa: E731

        def serve(params, batch):
            if split is None:
                return shards.once(f, params, batch)
            return shards.concat(shards.over_rows(f, params, batch))

        return BuiltStep(serve, (params_abs, batch_abs), meta)

    # retrieval: one user against the candidates, split over the data
    # shards where they divide them
    user, scores = {
        "seqrec": (recsys.seqrec_user, recsys.seqrec_candidate_scores),
        "din": (recsys.din_user, recsys.din_candidate_scores),
        "twotower": (recsys.twotower_query, recsys.twotower_candidate_scores),
    }[arch_kind]
    cand_axes = ({"candidates": 1} if arch_kind == "seqrec"
                 else {"cand_items": 0, "cand_cates": 0})

    def retrieve(params, batch):
        if split is None:
            out = shards.once(lambda p, b, m, ax: scores(cfg, p, user(cfg, p, b, m, ax), b, m, ax),
                              params, batch)
        else:
            out = shards.over_candidates(lambda *a: user(cfg, *a), lambda *a: scores(cfg, *a),
                                         params, batch, cand_axes)
        if arch_kind == "seqrec":
            return out
        return recsys.top_k_scores(out if out.dim() == 2 else out[None, :], 100)

    return BuiltStep(retrieve, (params_abs, batch_abs), meta)


# ==========================================================================
# dispatch + concrete-input materialization
# ==========================================================================
def build_step(arch: ArchSpec, shape_name: str, mesh) -> BuiltStep:
    shape = arch.shapes[shape_name]
    builder = {
        "lm": build_lm_step,
        "gnn": build_gnn_step,
        "recsys": build_recsys_step,
        "search": build_search_step,
    }[arch.family]
    return builder(arch, shape, mesh)


def _synth(tree, arch: ArchSpec, rng, device, dims=None):
    """The reference's synthetic leaves, drawn from ``rng`` in its order
    (dict keys sorted): integers in the family's id range (a GNN's
    ``src``/``dst`` below the shape's ``n_nodes``; wrapping into narrow
    types as numpy's cast does), zero for a scalar; ones for a float leaf
    named ``*mask*`` and zeros for ``log_q``, neither drawn; N(0, 0.5) for
    the other floats."""
    cfg = arch.model_cfg

    def leaf(name, x):
        if not x.is_floating_point():
            hi = 4
            if arch.family == "lm":
                hi = cfg.vocab
            elif arch.family == "gnn":
                hi = dims["n_nodes"] if name in ("src", "dst") else 4
            elif arch.family == "recsys":
                hi = getattr(cfg, "n_cates", 4) if "cate" in name else getattr(cfg, "n_items", 4)
            if x.dim() == 0:
                # a step's position is a host value: it picks the cache rows to write
                return torch.zeros((), dtype=x.dtype)
            a = rng.integers(0, max(hi, 2), tuple(x.shape)).astype(NP_INTS[x.dtype])
            return torch.from_numpy(a).to(device)
        if "mask" in name:
            return torch.ones(tuple(x.shape), dtype=x.dtype, device=device)
        if name == "log_q":
            return torch.zeros(tuple(x.shape), dtype=x.dtype, device=device)
        a = rng.normal(0, 0.5, tuple(x.shape)).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=x.dtype)

    if isinstance(tree, dict):
        drawn = {}
        for k in sorted(tree):
            drawn[k] = (_synth(tree[k], arch, rng, device, dims) if isinstance(tree[k], dict)
                        else leaf(k, tree[k]))
        return {k: drawn[k] for k in tree}
    return leaf("", tree)


def materialize_batch(arch: ArchSpec, shape_name: str, built: BuiltStep, seed: int = 0):
    """The step's arguments after the parameters (a train step's: after
    the optimizer state), synthesised on the step's device from
    ``np.random.default_rng(seed)`` as the reference draws them."""
    rng = np.random.default_rng(seed)
    shape = arch.shapes[shape_name]
    if arch.family == "search":
        return _search_inputs(arch, shape, rng, built.meta["device"])
    first = 2 if shape.kind == "train" else 1
    return tuple(_synth(a, arch, rng, built.meta["device"], shape.dims)
                 for a in built.args[first:])


def _search_inputs(arch: ArchSpec, shape: ShapeSpec, rng, device) -> tuple:
    """The reference's search inputs, its numpy draws in its order: per
    query row, a sorted base of L/2 distinct keys below 4L, and per key a
    sorted subset of L/4 to L/2 of them with fragment bounds 0-4 either
    side, padded with SENTINEL; idf sums U(1, 5) and span 3. For a
    compressed mode, the payload ``compress_qt1_batch`` makes of them (the
    reference hands its compressed steps the raw arrays whatever the
    mode)."""
    from repro_torch.core.torch_search import QT1Batch, compress_qt1_batch

    B, K, L = shape.dims["batch"], arch.model_cfg.n_keys, shape.dims["postings"]
    g = np.full((B, K, L), SENTINEL, np.int32)
    lo = g.copy()
    hi = g.copy()
    for b in range(B):
        base = np.sort(rng.choice(L * 4, size=L // 2, replace=False)).astype(np.int32)
        for k in range(K):
            n = rng.integers(L // 4, L // 2)
            sub = np.sort(rng.choice(base, size=n, replace=False))
            g[b, k, :n] = sub
            lo[b, k, :n] = sub - rng.integers(0, 5, n).astype(np.int32)
            hi[b, k, :n] = sub + rng.integers(0, 5, n).astype(np.int32)
    idf = rng.uniform(1, 5, B).astype(np.float32)
    span = np.full(B, 3.0, np.float32)
    mode = os.environ.get("REPRO_SEARCH_COMPRESSED", "")
    args = (g, lo, hi, idf, span)
    if mode:
        args = compress_qt1_batch(QT1Batch(g, lo, hi, idf, span, 1), delta_g=mode == "delta")
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args)


def materialize_inputs(arch: ArchSpec, shape_name: str, built: BuiltStep, seed: int = 0):
    """Concrete inputs for a built step on its device: the port's init
    seeded with ``seed`` (float32 masters and ``init_opt_state`` for
    training; serving LMs in bf16, as the reference casts them) and
    :func:`materialize_batch`."""
    cfg = arch.model_cfg
    device = built.meta["device"]
    train = arch.shapes[shape_name].kind == "train"
    if arch.family == "lm":
        dtype = torch.float32 if train else torch.bfloat16
        params = place_params(built, transformer.init_params(built.meta["cfg"], seed,
                                                             device=device, dtype=dtype))
    elif arch.family == "recsys":
        params = place_params(built, _INITS[_arch_kind(cfg)](cfg, seed, device=device))
    elif arch.family == "gnn":
        dims = arch.shapes[shape_name].dims
        params = gnn.init_params(replace(cfg, d_feat=dims["d_feat"]), seed, device=device)
    else:  # search: the posting arrays only
        return materialize_batch(arch, shape_name, built, seed)
    state = (params, init_opt_state(params)) if train else (params,)
    batch = materialize_batch(arch, shape_name, built, seed)
    if "cache_pspecs" in built.meta:  # decode: token, caches, position
        batch = (batch[0], place_caches(built, batch[1]), batch[2])
    return state + batch
