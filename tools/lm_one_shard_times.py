"""Time the port's LM steps on a mesh of one shard, (1, 1), on the card.

The steps and cuts are ``chip_smoke.py``'s: stablelm-1.6b's train step
at B 8 x S 4096 (the train phase), its prefill at B 4 x S 4096 and its
bf16 decode on a 32,768-row cache (the models phase), and
granite-moe-1b-a400m's prefill at B 2 x S 2048 (the multidevice phase's
unsharded step). Each goes through ``build_step`` on a (1, 1) mesh of
the card, with weights drawn from a seed. ``--src`` names the source
tree that ``repro_torch`` is imported from, so that two trees can be
timed in turns on one card:

  python tools/lm_one_shard_times.py --src src --tag change [--only stablelm_serve]

One JSON line: every call's CUDA-event ms (the first included) and the
train step's peak memory; progress on the standard error.
"""

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

SEED = 19
TRAIN = {"seq_len": 4096, "global_batch": 8}
PREFILL = {"seq_len": 4096, "global_batch": 4}
DECODE_ROWS, DECODE_STEPS = 32768, 16
GRANITE = {"seq_len": 2048, "global_batch": 2}
TRAIN_STEPS, PREFILL_CALLS = 3, 4
PARTS = ("stablelm_train", "stablelm_serve", "granite_prefill")


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def timed(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def cut(arch, **shapes):
    """``arch`` with its shapes replaced: name=(kind, dims)."""
    from repro_torch.configs.base import ShapeSpec

    return replace(arch, shapes={**arch.shapes, **{n: ShapeSpec(n, kind, dims)
                                                   for n, (kind, dims) in shapes.items()}})


def train(arch, mesh) -> dict:
    from repro_torch.launch.steps import build_step, materialize_inputs

    arch = cut(arch, train_4k=("train", TRAIN))
    built = build_step(arch, "train_4k", mesh)
    params, opt, batch = materialize_inputs(arch, "train_4k", built, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        (params, opt, m), t = timed(lambda: built.fn(params, opt, batch))
        ms.append(t)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    log(f"{arch.arch_id} train ms {ms}")
    del params, opt, batch
    torch.cuda.empty_cache()
    return {**TRAIN, "n_micro": built.meta["n_micro"], "step_ms": ms, "losses": losses,
            "peak_bytes": peak}


def serve(arch, mesh, dims: dict, decode_rows: int | None) -> dict:
    """PREFILL_CALLS prefills of one prompt, then (with ``decode_rows``)
    DECODE_STEPS greedy bf16 decode steps on a zeroed cache holding the
    prefill."""
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import transformer

    shapes = {"prefill_32k": ("prefill", dims)}
    if decode_rows:
        shapes["decode_32k"] = ("decode", {"seq_len": decode_rows,
                                           "global_batch": dims["global_batch"]})
    arch = cut(arch, **shapes)
    pre = build_step(arch, "prefill_32k", mesh)
    params, prompt = materialize_inputs(arch, "prefill_32k", pre, seed=SEED)
    prefill_ms = []
    for _ in range(PREFILL_CALLS):
        kv = None
        (logits, kv), t = timed(lambda: pre.fn(params, prompt))
        prefill_ms.append(t)
    rec = {**dims, "prefill_ms": prefill_ms}
    log(f"{arch.arch_id} prefill ms {prefill_ms}")
    if decode_rows:
        dec = build_step(arch, "decode_32k", mesh)
        B, S = dims["global_batch"], dims["seq_len"]
        cache = transformer.init_cache(arch.model_cfg, B, decode_rows, device=mesh.lead)
        for n in ("k", "v"):
            cache[n][:, :, :S] = kv[n]
        token, step_ms = logits.argmax(-1, keepdim=True).to(torch.int32), []
        for i in range(DECODE_STEPS):
            (logits, cache), t = timed(lambda: dec.fn(params, token, cache, S + i))
            token = logits.argmax(-1, keepdim=True).to(torch.int32)
            step_ms.append(t)
        rec.update(decode_rows=decode_rows, decode_ms=step_ms)
        log(f"{arch.arch_id} decode ms {step_ms}")
        del cache
    del params, prompt, kv
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"),
                    help="the source tree to import repro_torch from")
    ap.add_argument("--tag", default="", help="a name for this tree in the output")
    ap.add_argument("--only", choices=PARTS, action="append",
                    help="time only this part (repeatable; default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_one_shard_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.configs.lm_archs import GRANITE_MOE, STABLELM_1_6B
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"))
    parts = {"stablelm_train": lambda: train(STABLELM_1_6B, mesh),
             "stablelm_serve": lambda: serve(STABLELM_1_6B, mesh, PREFILL, DECODE_ROWS),
             "granite_prefill": lambda: serve(GRANITE_MOE, mesh, GRANITE, None)}
    rec = {"tag": args.tag, "src": str(Path(repro_torch.__file__).parent)}
    for name in args.only or PARTS:
        rec[name] = parts[name]()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
