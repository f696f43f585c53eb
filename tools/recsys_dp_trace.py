"""Where the time of two-tower's data-parallel train step goes, card by card.

Runs two-tower-retrieval's train_batch at B 32,768 on a (1, 1) mesh of
card 0 (unless ``--no-one``), then on an (n, 1) mesh of the first n
visible cards (n up to 4): ``--steps`` steps timed with CUDA events,
their losses against (1, 1), peak memory a card, the elements in which a
replica differs from the first (0: equal to the bit). Then, by the step's own
phases (``launch/steps.py``: ``value_and_grad``, ``sum_replicas``,
``adamw_update``, each wrapped here):

* one step with every card synchronised after each phase: each phase's
  time alone;
* one step unsynchronised, as the built step runs: an event on each
  card's stream where the host enters each phase, so each card's time to
  reach it, and the host's own times;
* with ``--profile``, one more step under ``torch.profiler``: each card's
  busy time (the union of its kernels and copies), and the host phase
  during which each of its idle gaps began.

With ``--copy``, the rate of one 1 GiB copy from card 0 to card 1, and
``parallel.all_reduce`` alone over one replica a card of the item table's
shape; where the package has it, ``parallel.all_reduce_rows`` alone over
the same replicas, each the segment sum of seeded rows over one data
shard's item lookups (its rows' 50 history ids and item, uniform ids),
the lists' rows being those lookups.

  python tools/recsys_dp_trace.py [--no-one] [--profile] [--copy] \\
      [--label NAME] [--out results/recsys_dp_trace.jsonl]

The tool imports the package of the tree it sits in, so a copy placed in
another tree's ``tools/`` measures that tree. Needs a card.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.recsys_archs import TWO_TOWER  # noqa: E402
from repro_torch.kernels.build import build  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

B, SEED, WARM = 32_768, 19, 1
PHASES = ("value_and_grad", "sum_replicas", "adamw_update")
GAP_US = 1000  # an idle gap worth naming


def arch():
    return replace(TWO_TOWER, shapes={"train_batch": ShapeSpec("train_batch", "train",
                                                               {"batch": B})})


class Phases:
    """The step's three phases wrapped: an event on every card where the
    host enters each (and where it leaves the last), the host's times, and
    optionally a synchronisation of every card after each."""

    def __init__(self, devices):
        self.devices, self.sync, self.marks, self.replicas = devices, False, None, None
        self.depth = 0
        self.saved = {n: getattr(steps, n) for n in PHASES}
        for name, fn in self.saved.items():
            setattr(steps, name, self._wrap(name, fn))

    def _mark(self, name):
        if self.marks is None:
            return
        evs = []
        for d in self.devices:
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(d))
            evs.append(e)
        self.marks.append((name, time.perf_counter(), evs))

    def _wrap(self, name, fn):
        def wrapped(*a, **k):
            if self.depth:  # a phase's own recursion (sum_replicas walks its tree)
                return fn(*a, **k)
            if name == "sum_replicas" and self.marks is not None:
                self.replicas = replica_stats(a[0])
            self._mark(name)
            self.depth += 1
            try:
                with torch.profiler.record_function(f"phase:{name}"):
                    out = fn(*a, **k)
            finally:
                self.depth -= 1
            if self.sync:
                for d in self.devices:
                    torch.cuda.synchronize(d)
            return out
        return wrapped

    def run(self, fn, sync=False):
        """fn() with the marks recorded -> (its result, the record)."""
        self.sync, self.marks = sync, []
        self._mark("start")
        out = fn()
        self._mark("end")
        for d in self.devices:
            torch.cuda.synchronize(d)
        marks, self.marks, self.sync = self.marks, None, False
        t0 = marks[0][1]
        rec = {"replicas": self.replicas, "host_ms": {n: (t - t0) * 1e3 for n, t, _ in marks},
               "card_ms": {n: [s.elapsed_time(e) for s, e in zip(marks[0][2], evs)]
                           for n, _, evs in marks}}
        if sync:
            names = [n for n, _, _ in marks]
            rec["alone_ms"] = {names[i]: rec["host_ms"][names[i + 1]] - rec["host_ms"][names[i]]
                               for i in range(1, len(names) - 1)}
        return out, rec

    def undo(self):
        for name, fn in self.saved.items():
            setattr(steps, name, fn)


def replica_stats(grads) -> dict:
    """The leaves of a gradient tree held once per data shard: how many,
    their bytes over every row, and the devices of their rows."""
    from repro_torch.parallel import Sharded

    out = {"leaves": 0, "bytes": 0, "devices": set()}

    def walk(t):
        if isinstance(t, (dict, list, tuple)):
            for v in (t.values() if isinstance(t, dict) else t):
                walk(v)
        elif isinstance(t, Sharded) and t.axes[0] is None and t.grid[0] > 1:
            out["leaves"] += 1
            out["bytes"] += sum(b.numel() * b.element_size() for b in t.shards)
            out["devices"].update(str(b.device) for b in t.shards)

    walk(grads)
    out["devices"] = sorted(out["devices"])
    return out


def replicas_apart(tree) -> int:
    """The elements in which a replica row of a ``Sharded`` leaf differs
    from the first row."""
    from repro_torch.parallel import Sharded

    if isinstance(tree, (dict, list, tuple)):
        return sum(replicas_apart(v) for v in (tree.values() if isinstance(tree, dict) else tree))
    if not (isinstance(tree, Sharded) and tree.axes[0] is None):
        return 0
    rows, cols = tree.grid
    return sum(int((tree.block(i, j).to(tree.block(0, j).device) != tree.block(0, j)).sum())
               for i in range(1, rows) for j in range(cols))


def all_reduce_alone(devices, shape) -> dict:
    """``parallel.all_reduce`` of one float32 replica of ``shape`` a card,
    synchronised: the collective's own time."""
    from repro_torch.parallel import all_reduce

    reps = [torch.randn(shape, device=d) for d in devices]
    ms = []
    for _ in range(3):
        for d in devices:
            torch.cuda.synchronize(d)
        t = time.perf_counter()
        reps = all_reduce(reps)
        for d in devices:
            torch.cuda.synchronize(d)
        ms.append((time.perf_counter() - t) * 1e3)
    nbytes = reps[0].numel() * 4
    del reps
    torch.cuda.empty_cache()
    return {"shape": list(shape), "bytes_a_card": nbytes, "ms": ms}


def all_reduce_rows_alone(devices, shape, rows_a_shard: int) -> dict:
    """``parallel.all_reduce_rows`` over one float32 replica of ``shape`` a
    card, replica i the segment sum of seeded rows over card i's list of
    ``rows_a_shard`` x 51 uniform ids, synchronised; the sum equal to
    ``all_reduce``'s on every card, compared after the timed runs."""
    from repro_torch import parallel
    from repro_torch.kernels.segment_sum import segment_sum

    V, D = shape
    gen = torch.Generator(device=devices[0]).manual_seed(SEED)
    ids = [torch.randint(0, V, (rows_a_shard * 51,), generator=gen, device=devices[0],
                         dtype=torch.int32).to(d) for d in devices]
    rows = [torch.randn((i.numel(), D), generator=gen, device=devices[0]).to(d)
            for i, d in zip(ids, devices)]
    ms = []
    for _ in range(3):
        reps = [segment_sum(r, i, V) for r, i in zip(rows, ids)]
        for d in devices:
            torch.cuda.synchronize(d)
        t = time.perf_counter()
        reps = parallel.all_reduce_rows(reps, ids)
        for d in devices:
            torch.cuda.synchronize(d)
        ms.append((time.perf_counter() - t) * 1e3)
    want = parallel.all_reduce([segment_sum(r, i, V) for r, i in zip(rows, ids)])
    apart = sum(int((a != b).sum()) for a, b in zip(reps, want))
    del reps, want, rows
    torch.cuda.empty_cache()
    return {"shape": list(shape), "bound_a_card": rows_a_shard * 51, "ms": ms,
            "elements_apart_from_all_reduce": apart}


KINDS = (("bag", "embedding_bag"), ("sort", "sort"), ("radix", "sort"), ("index", "index"),
         ("gemm", "gemm"), ("cutlass", "gemm"), ("cublas", "gemm"), ("Memcpy PtoP", "peer copy"),
         ("Memcpy", "copy"), ("Memset", "memset"), ("reduce", "reduce"),
         ("elementwise", "elementwise"))


def _kind(name: str) -> str:
    low = name.lower()
    return next((k for pat, k in KINDS if pat.lower() in low), "other")


def timed_ms(fn, devices):
    start = [torch.cuda.Event(enable_timing=True) for _ in devices]
    end = [torch.cuda.Event(enable_timing=True) for _ in devices]
    for e, d in zip(start, devices):
        e.record(torch.cuda.current_stream(d))
    out = fn()
    for e, d in zip(end, devices):
        e.record(torch.cuda.current_stream(d))
    for e in end:
        e.synchronize()
    return out, max(s.elapsed_time(e) for s, e in zip(start, end))


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_summary(path) -> dict:
    """Each card's busy time in the traced step and its idle gaps of over
    GAP_US, each with the host phase it began in."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"][6:]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name", "").startswith("phase:"))
    cards, kinds = {}, {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            d = int(e.get("args", {}).get("device", e.get("pid", -1)))
            cards.setdefault(d, []).append((e["ts"], e["ts"] + e["dur"]))
            per = kinds.setdefault(d, {})
            k = _kind(e.get("name", ""))
            per[k] = per.get(k, 0.0) + e["dur"] / 1e3
    t0 = min(min(a for a, _ in iv) for iv in cards.values())
    t1 = max(max(b for _, b in iv) for iv in cards.values())

    def phase_at(t):
        hits = [n for a, b, n in host if a <= t <= b]
        return hits[-1] if hits else ("before" if not host or t < host[0][0] else "after")

    out = {"span_ms": (t1 - t0) / 1e3, "host_phases_ms": {n: [(a - t0) / 1e3, (b - t0) / 1e3]
                                                          for a, b, n in host}, "cards": {}}
    for d, iv in sorted(cards.items()):
        u = _union(iv)
        gaps = [(a[1], b[0]) for a, b in zip(u, u[1:]) if b[0] - a[1] > GAP_US]
        idle = {}
        for a, b in gaps:
            idle[phase_at(a)] = idle.get(phase_at(a), 0.0) + (b - a) / 1e3
        out["cards"][d] = {"busy_ms": sum(b - a for a, b in u) / 1e3,
                           "first_ms": (u[0][0] - t0) / 1e3, "last_ms": (u[-1][1] - t0) / 1e3,
                           "ops": len(iv), "idle_gaps": len(gaps),
                           "idle_ms_by_host_phase": idle,
                           "ms_by_kind": {k: round(v, 3) for k, v in sorted(
                               kinds[d].items(), key=lambda kv: -kv[1])}}
    return out


def steps_on(mesh, devices, n_steps, phases, profile, one=None) -> dict:
    a = arch()
    built = steps.build_step(a, "train_batch", mesh)
    params, opt, batch = steps.materialize_inputs(a, "train_batch", built, seed=SEED)
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    losses, ms = [], []
    for _ in range(n_steps):
        (params, opt, m), t = timed_ms(lambda: built.fn(params, opt, batch), devices)
        losses.append(float(m["loss"]))
        ms.append(t)
    rec = {"mesh": list(mesh.devices.shape), "split": built.meta["split"], "losses": losses,
           "step_ms": ms, "peak_bytes": [torch.cuda.max_memory_allocated(d) for d in devices],
           "replicas_apart": replicas_apart(params) + replicas_apart(opt)}
    if one is not None:
        rec["rel_diff"] = float(np.max(np.abs(np.array(losses) / np.array(one) - 1)))
    if phases is not None:
        _, rec["synchronised"] = phases.run(lambda: built.fn(params, opt, batch), sync=True)
        _, rec["as_run"] = phases.run(lambda: built.fn(params, opt, batch))
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx

            with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, rec["profiled_ms"] = timed_ms(lambda: built.fn(params, opt, batch), devices)
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                try:
                    rec["profile"] = profile_summary(path)
                except (KeyError, ValueError) as e:  # a trace without the expected events
                    rec["profile"] = {"error": repr(e)}
    del params, opt, batch
    torch.cuda.empty_cache()
    return rec


def copy_rate(src, dst) -> dict:
    x = torch.empty(1 << 28, dtype=torch.float32, device=src)
    y = torch.empty_like(x, device=dst)
    y.copy_(x)
    ms = []
    for _ in range(3):
        _, t = timed_ms(lambda: y.copy_(x), [src, dst])
        ms.append(t)
    return {"bytes": x.numel() * 4, "ms": ms, "gb_per_s": x.numel() * 4 / min(ms) / 1e6}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--no-one", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--copy", action="store_true")
    ap.add_argument("--label", default=str(ROOT))
    ap.add_argument("--out", default=str(Path("results") / "recsys_dp_trace.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    t_start = time.perf_counter()
    n = min(torch.cuda.device_count(), 4)
    cards = [torch.device("cuda", i) for i in range(n)]
    out = {"label": args.label, "cards": [torch.cuda.get_device_name(i) for i in range(n)],
           "build_s": build(("embedding_bag", "segment_sum"))}
    one = None
    if not args.no_one:
        out["1x1"] = steps_on(make_mesh((1, 1), ("data", "model"), devices=cards[:1]),
                              cards[:1], WARM + args.steps, None, False)
        one = out["1x1"]["losses"]
    phases = Phases(cards)
    try:
        out[f"{n}x1"] = steps_on(make_mesh((n, 1), ("data", "model"), devices=cards), cards,
                                 WARM + args.steps, phases, args.profile, one)
    finally:
        phases.undo()
    if args.copy and n > 1:
        out["copy_0_to_1"] = copy_rate(cards[0], cards[1])
        shape = (TWO_TOWER.model_cfg.n_items, TWO_TOWER.model_cfg.embed_dim)
        out["all_reduce_item_emb"] = all_reduce_alone(cards, shape)
        from repro_torch import parallel

        if hasattr(parallel, "all_reduce_rows"):
            out["all_reduce_rows_item_emb"] = all_reduce_rows_alone(cards, shape, B // n)
    out["seconds"] = time.perf_counter() - t_start
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
