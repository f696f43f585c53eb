"""Multi-pod dry run: count every (architecture x input shape) cell's built
step on the production meshes and record memory, cost and copies between
shards for the roofline (the reference's ``launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --arch qwen1.5-32b --shape train_4k

Results are appended to --out (JSON lines), one record per cell; a cell
already recorded without an error is skipped, so a run restarts where it
stopped.

The reference lowers and compiles each cell with XLA on 512 forced host
devices. The port builds the production mesh from ``meta`` entries
(``make_production_mesh(devices=["meta"] * n)``: shapes only, no memory,
no card), places the parameters as the step expects them
(``steps.placed_args``) and runs the built step once on its abstract
arguments under the cost pass (``repro_torch.obs.cost``). One process runs
every shard's work, so the counts are the whole mesh's; the record gives
them per device, as the mean over the mesh's devices (a mean cannot show
work a step leaves to some devices: those do more than it says, the
others less). A record holds:

* ``memory`` (bytes per device): ``argument_bytes`` and ``output_bytes``,
  the step's arguments and results as placed, on the device holding the
  most (a ``Sharded`` block on its grid position, a whole tensor on the
  first position of its device, the lead); ``alias_bytes``, the results
  that are their arguments updated in place (a train step's parameters
  and moments, a decode step's caches); ``temp_bytes``, the high-water
  mark of live storages the step allocated, less its new results, over
  the mesh's devices (a meta tensor carries no shard, so temps are not
  attributed to one: the mean device); ``peak_per_device_gib`` =
  (argument + output + temp - alias) / 2^30, the reference's formula.
* ``cost``: ``flops``, ``bytes_accessed`` (the unfused eager traffic)
  and ``transcendentals`` per device; ``kernels`` the hand-written
  kernels' share of them.
* ``collectives``: ``once_bytes`` the bytes copied between shards per
  device by kind (``repro_torch.parallel``'s record, by shard index),
  ``in_loop_bytes`` empty (the layers are a Python loop: every copy is
  counted where it happens), ``n_ops`` the copies.
* ``meta``: the built step's metadata that JSON holds; ``compute_dtype``,
  whose peak the roofline takes.
* ``layer_probe`` (LM cells): one layer's ``flops`` and
  ``bytes_accessed`` per device, from ``steps.build_lm_layer_probe``.
* ``aten_ops``: the aten ops the step ran, all shards together: the
  host's work of one eager step (one Python process drives the mesh).
* ``build_s`` and ``count_s`` in place of the reference's ``lower_s``
  and ``compile_s``: there is no lowering or compile.
* ``extrapolated`` (LM cells of more than two layers): the layer counts
  (and microbatch counts) the step was counted at. An eager step runs
  every shard's every op in Python: stablelm-1.6b's train_4k on 16x16
  is ~160M ops, hours at the ~150 us an op costs on ``meta``. Its layers
  repeat the same ops on the same shapes, and so do its microbatches, so
  every count is bilinear in the layers L and microbatches m,
  ``f(L, m) = a + b L + c m + d L m``: the cell is counted at L in {1, 2}
  and, where it has microbatches, m in {1, 2} of its microbatch size,
  and each field is reckoned at its L and m from those: exact for the
  cost, the copies and the argument, output and alias bytes. A
  high-water mark is not linear in the layers (stablelm's prefill at
  B 4 x S 4096 on (1, 1): 1.10 GB of temps at one and two layers, 3.29 GB
  counted at all 24, where the stacked caches outgrow a layer's
  attention), so ``temp_bytes`` comes from the counts' live-bytes
  profiles instead (:func:`reckon_peak`: the height of each stretch
  between layer boundaries, forward and backward, reckoned at L layers).
  An optimizer update of a leaf larger than its slice
  (``train/optimizer.py`` ``CHUNK``) stops growing with L where the
  reckoning goes on: it may over-count there, never under-count.

A cell whose step cannot run on ``meta`` records ``error``, as a failed
compile does in the reference.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch.hlo_analysis import collective_stats
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_lm_layer_probe, build_step, placed_args
from repro_torch.obs.cost import LAYER, LAYER_GRAD, count
from repro_torch.parallel import CopyRecord, Sharded


def _tensors(tree, grid):
    """(grid position, tensor) of every tensor in a tree of dicts, lists,
    tuples and ``Sharded``."""
    if isinstance(tree, Sharded):
        cols = tree.grid[1]
        return [((k // cols, k % cols), s) for k, s in enumerate(tree.shards)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [pt for v in tree for pt in _tensors(v, grid)]
    if isinstance(tree, torch.Tensor):
        hits = [(i, j) for i in range(grid.shape[0]) for j in range(grid.shape[1])
                if grid[i, j] == tree.device]
        return [(hits[0] if hits else (0, 0), tree)]
    return []


def _key(t: torch.Tensor) -> tuple:
    return (t.untyped_storage()._cdata, t.storage_offset(), t.numel())


def _bytes_by_position(items) -> dict:
    seen, out = set(), {}
    for pos, t in items:
        if _key(t) in seen:
            continue
        seen.add(_key(t))
        out[pos] = out.get(pos, 0) + t.numel() * t.element_size()
    return out


def reckon_memory(args, outs, peak_bytes: int, grid) -> dict:
    """The reference's ``memory_analysis()`` fields, per device, from the
    placed arguments, the results and the count's live-bytes high-water
    mark (see the module docstring), and ``new_out_bytes``: the results
    that are not their arguments, over the whole mesh."""
    arg_items, out_items = _tensors(args, grid), _tensors(outs, grid)
    arg_keys = {_key(t) for _, t in arg_items}
    per_arg = _bytes_by_position(arg_items)
    per_out = _bytes_by_position(out_items)
    per_alias = _bytes_by_position([(p, t) for p, t in out_items if _key(t) in arg_keys])
    new_out = sum(per_out.values()) - sum(per_alias.values())
    mem = {"argument_bytes": max(per_arg.values(), default=0),
           "output_bytes": max(per_out.values(), default=0),
           "temp_bytes": _temp_bytes(peak_bytes, new_out, grid),
           "alias_bytes": max(per_alias.values(), default=0)}
    mem["peak_per_device_gib"] = _peak_gib(mem)
    mem["new_out_bytes"] = new_out
    return mem


def _temp_bytes(peak_bytes: int, new_out: int, grid) -> int:
    return max(peak_bytes - new_out, 0) // grid.size


def _peak_gib(mem: dict) -> float:
    return round((mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
                  - mem["alias_bytes"]) / 2**30, 3)


def _json_meta(meta: dict) -> dict:
    """The metadata JSON holds: numbers, strings, flags."""
    return {k: v for k, v in meta.items() if isinstance(v, (bool, int, float, str))}


def compute_dtype(arch) -> str:
    """The type the cell's products run in, whose peak the roofline
    takes: an LM's ``dtype`` (bfloat16 at full width), float32 for the
    other model families, int32 for the search arch."""
    if arch.family == "search":
        return "int32"
    return str(getattr(arch.model_cfg, "dtype", "float32")).replace("torch.", "")


def _production_mesh(multi_pod: bool):
    return make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * (512 if multi_pod else 256))


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.devices.shape)


def count_built(built) -> tuple:
    """(the placed arguments, the step's results, its :class:`Cost`)."""
    args = placed_args(built)
    outs, cost = count(built.fn, *args)
    return args, outs, cost


def _counted(built, grid) -> tuple:
    """A built step's count as flat numeric fields: the memory fields
    (before the peak), the live-bytes high-water mark and the new results'
    bytes over the mesh (``live``), the mesh's total cost, copies by kind
    and the kernels' work; and the count's live-bytes profile."""
    args, outs, cost = count_built(built)
    mem = reckon_memory(args, outs, cost.peak_bytes, grid)
    del args, outs
    out = {("memory", k): v for k, v in mem.items()
           if k not in ("peak_per_device_gib", "new_out_bytes")}
    out[("live", "peak")] = cost.peak_bytes
    out[("live", "new_out")] = mem["new_out_bytes"]
    for k in ("flops", "bytes_accessed", "transcendentals"):
        out[("cost", k)] = getattr(cost, k)
    out[("ops",)] = cost.ops
    out[("copies", "n_ops")] = cost.n_copies
    for k, v in cost.copies.items():
        out[("copies", k)] = v
    for name, work in cost.kernels.items():
        for k, v in work.items():
            out[("kernels", name, k)] = v
    return out, cost.profile


def _bilinear(points: dict, L: int, m: int) -> dict:
    """Each field at (L, m) from its values at (1, 1), (2, 1) and, where
    given, (1, 2) and (2, 2): f(L, m) = a + b L + c m + d L m."""
    f11, f21 = points[1, 1], points[2, 1]
    f12, f22 = points.get((1, 2), f11), points.get((2, 2), f21)
    out = {}
    for k in set(f11) | set(f21) | set(f12) | set(f22):
        v11, v21, v12, v22 = (p.get(k, 0) for p in (f11, f21, f12, f22))
        out[k] = (v11 + (L - 1) * (v21 - v11) + (m - 1) * (v12 - v11)
                  + (L - 1) * (m - 1) * (v22 - v21 - v12 + v11))
    return out


_LAYER_TAGS = (LAYER, LAYER_GRAD)


def _stretches(profile) -> list:
    """A live-bytes profile as groups: each run of one layer's stretches
    (a layer tag repeated) one group of their high-water marks, every
    other stretch a group of one."""
    groups = []
    for tag, high in profile:
        if groups and tag in _LAYER_TAGS and groups[-1][0] == tag:
            groups[-1][1].append(high)
        else:
            groups.append((tag, [high]))
    return groups


def reckon_peak(one, two, L: int) -> int | None:
    """The live-bytes high-water mark of an L-layer step from the profiles
    of its counts at one and two layers (None where their stretches do not
    pair up). Each stretch between marks repeats at L layers: one outside
    the layers has its mark at a height affine in L; the k-th layer of a
    run at one affine in L and k (a layer adds what it keeps, or frees,
    forward and backward), each layer's excursion above its mark the same.
    So each stretch's mark is reckoned from the two counts, and the peak is
    the largest of them, a run's at its first or last layer."""
    g1, g2 = _stretches(one), _stretches(two)
    if [t for t, _ in g1] != [t for t, _ in g2] or any(
            len(a) != 1 or len(b) != (2 if t in _LAYER_TAGS else 1)
            for (t, a), (_, b) in zip(g1, g2)):
        return None
    peak = 0
    for (tag, a), (_, b) in zip(g1, g2):
        first = a[0] + (L - 1) * (b[0] - a[0])
        peak = max(peak, first)
        if tag in _LAYER_TAGS:
            peak = max(peak, first + (L - 1) * (b[1] - b[0]))
    return peak


def _lm_variant(arch, shape_name: str, layers: int, micro: int, n_micro: int):
    """The LM cell cut to ``layers`` layers and ``micro`` of its
    ``n_micro`` microbatches (the microbatch size kept)."""
    shape = arch.shapes[shape_name]
    dims = dict(shape.dims)
    if n_micro > 1:
        dims["global_batch"] = dims["global_batch"] // n_micro * micro
        dims["n_micro"] = micro
    cfg = replace(arch.model_cfg, n_layers=layers)
    return replace(arch, model_cfg=cfg, shapes={shape_name: replace(shape, dims=dims)})


def count_cell(arch, shape_name: str, mesh, built) -> tuple:
    """The cell's count as flat fields, and the (layers, microbatches)
    it was extrapolated from (None where it was counted whole). An
    extrapolated count's temps come from the peak :func:`reckon_peak`
    gives from the profiles at one and two layers (at two microbatches
    where the cell has several: a microbatch keeps nothing for the next
    but the accumulated gradients, so the third repeats the second), less
    the new results' bytes; null where the profiles do not pair up."""
    grid = mesh.grid()
    L = getattr(arch.model_cfg, "n_layers", 1)
    m = built.meta.get("n_micro", 1)
    if arch.family != "lm" or (L <= 2 and m == 1):
        return _counted(built, grid)[0], None
    micros = (1, 2) if m > 1 else (1,)
    points, profiles = {}, {}
    for l in (1, 2):
        for k in micros:
            variant = build_step(_lm_variant(arch, shape_name, l, k, m), shape_name, mesh)
            points[l, k], profiles[l, k] = _counted(variant, grid)
    out = _bilinear(points, L, m)
    peak = reckon_peak(profiles[1, micros[-1]], profiles[2, micros[-1]], L)
    out[("live", "peak")] = peak
    out[("memory", "temp_bytes")] = (None if peak is None else
                                     _temp_bytes(peak, out[("live", "new_out")], grid))
    return out, {"layers": [1, 2], "micro": list(micros)}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, layer_probe: bool = True,
             mesh=None) -> dict:
    """One cell's record on the production mesh of ``meta`` entries (or on
    ``mesh``, for a smaller run)."""
    arch = get_arch(arch_id) if isinstance(arch_id, str) else arch_id
    if mesh is None:
        mesh = _production_mesh(multi_pod)
    n = mesh.size
    rec = {
        "arch": arch.arch_id,
        "shape": shape_name,
        "mesh": _mesh_name(mesh),
        "n_devices": n,
        "kind": arch.shapes[shape_name].kind,
        "compute_dtype": compute_dtype(arch),
    }
    t0 = time.time()
    built = build_step(arch, shape_name, mesh)
    rec["build_s"] = round(time.time() - t0, 1)
    t1 = time.time()
    fields, extrapolated = count_cell(arch, shape_name, mesh, built)
    rec["count_s"] = round(time.time() - t1, 1)
    mem = {k[1]: None if v is None else int(v) for k, v in fields.items() if k[0] == "memory"}
    mem["peak_per_device_gib"] = None if mem["temp_bytes"] is None else _peak_gib(mem)
    rec["memory"] = mem
    rec["cost"] = {k[1]: v / n for k, v in fields.items() if k[0] == "cost"}
    kernels = {}
    for k, v in fields.items():
        if k[0] == "kernels":
            kernels.setdefault(k[1], {})[k[2]] = v if k[2] == "launches" else v / n
    rec["kernels"] = kernels
    rec["aten_ops"] = int(fields[("ops",)])
    if extrapolated:
        rec["extrapolated"] = extrapolated
    copies = CopyRecord({k[1]: v for k, v in fields.items()
                         if k[0] == "copies" and k[1] != "n_ops"},
                        int(fields[("copies", "n_ops")]))
    cs = collective_stats(copies, n)
    rec["collectives"] = {
        "once_bytes": {k: int(v) for k, v in cs.op_bytes.items()},
        "in_loop_bytes": {k: int(v) for k, v in cs.in_loop_bytes.items()},
        "n_ops": cs.count,
    }
    rec["meta"] = _json_meta(built.meta)
    if arch.family == "lm" and layer_probe:
        probe = build_lm_layer_probe(arch, arch.shapes[shape_name], mesh)
        _, _, pcost = count_built(probe)
        rec["layer_probe"] = {"flops": pcost.flops / n,
                              "bytes_accessed": pcost.bytes_accessed / n}
    print(
        f"[dryrun] {rec['arch']}/{shape_name} mesh={rec['mesh']} "
        f"count={rec['count_s']}s peak/dev={rec['memory']['peak_per_device_gib']} GiB "
        f"flops={rec['cost']['flops']:.3e} copies={cs.count}", flush=True
    )
    return rec


def iter_cells(arch_sel: str, shape_sel: str):
    if arch_sel == "all":
        arch_ids = list(ARCHS)
    elif arch_sel == "assigned":
        from repro_torch.configs.registry import ASSIGNED_ARCH_IDS

        arch_ids = list(ASSIGNED_ARCH_IDS)
    else:
        arch_ids = [arch_sel]
    for aid in arch_ids:
        arch = get_arch(aid)
        shapes = [shape_sel] if shape_sel != "all" else list(arch.shapes)
        for s in shapes:
            if s in arch.shapes:
                yield aid, s
        if shape_sel == "all":
            for s, why in arch.skips.items():
                print(f"[dryrun] SKIP {aid}/{s}: {why}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.jsonl")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    # skip cells already recorded (restartable across invocations)
    done = set()
    if out.exists():
        for line in out.read_text().splitlines():
            try:
                r = json.loads(line)
                if "error" not in r:
                    done.add((r["arch"], r["shape"], r["mesh"]))
            except json.JSONDecodeError:
                pass
    failures = 0
    with out.open("a") as fh:
        for multi in meshes:
            mesh = _production_mesh(multi)
            mesh_name = _mesh_name(mesh)
            for aid, s in iter_cells(args.arch, args.shape):
                if (aid, s, mesh_name) in done:
                    print(f"[dryrun] cached {aid}/{s} {mesh_name}")
                    continue
                try:
                    rec = run_cell(aid, s, multi, mesh=mesh)
                except Exception as e:  # record and continue
                    failures += 1
                    rec = {
                        "arch": aid, "shape": s, "mesh": mesh_name,
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                    print(f"[dryrun] FAIL {aid}/{s} {mesh_name}: {rec['error']}")
                fh.write(json.dumps(rec) + "\n")
                fh.flush()
    print(f"[dryrun] done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
