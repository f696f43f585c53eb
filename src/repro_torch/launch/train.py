"""Training driver (the reference's ``launch/train.py``): real steps on a
(1, 1) mesh of one device, supervised by the fault-tolerance layer
(checkpoint/restart, straggler detection). The card is the default;
``--device cpu`` runs on the host. :func:`train_arch` also takes a
``mesh_shape`` (FSDP over its data shards, tensor parallelism over its
model shards, every entry the one device); a checkpoint holds each
sharded parameter whole, so a run restores on any mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 5 [--device cpu|cuda]

Checkpoints go under ``--ckpt-dir`` (default: ``repro_torch_ckpt`` in the
temporary directory); a directory that already holds one resumes from it.
``--arch`` is looked up in ``configs.registry`` (``get_arch``), as in the
reference; the supervised loop feeds LM batches (``make_lm_batch_fn``).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_step, materialize_inputs
from repro_torch.train.fault_tolerance import (
    FailureInjector,
    StragglerDetector,
    TrainSupervisor,
)

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def make_lm_batch_fn(vocab: int, batch: int, seq: int, seed: int = 0, *, device=None):
    """Deterministic per-step synthetic LM batches (replay-exact), on
    ``device`` (the card unless the caller names another): a noisy integer
    AR(1) stream so the loss has learnable structure; the reference's numpy
    draws."""
    device = resolve_device(device)

    def batch_fn(step: int):
        rng = np.random.default_rng(seed * 1_000_003 + step)
        base = rng.integers(0, vocab, (batch, seq + 1))
        # make it compressible: repeat previous token with p=0.5
        rep = rng.random((batch, seq + 1)) < 0.5
        for t in range(1, seq + 1):
            base[:, t] = np.where(rep[:, t], base[:, t - 1], base[:, t])
        return {
            "tokens": torch.from_numpy(base[:, :-1].astype(np.int32)).to(device),
            "targets": torch.from_numpy(base[:, 1:].astype(np.int32)).to(device),
        }

    return batch_fn


def train_arch(
    arch_id: str,
    shape_name: str = "train_4k",
    steps: int = 50,
    ckpt_dir: str = DEFAULT_CKPT_DIR,
    ckpt_every: int = 10,
    mesh_shape: tuple = (1, 1),
    inject_failures: dict | None = None,
    reduced: bool = True,
    seed: int = 0,
    device=None,
):
    """Train ``arch_id`` under the supervisor -> its ``SupervisorReport``.
    Every mesh entry is ``device`` (the card unless the caller names
    another). The steps update the state in place, so each (re)start
    materializes the initial state anew before restoring the latest
    checkpoint into it (the reference reuses its arrays)."""
    arch = get_arch(arch_id)
    if reduced:
        arch = arch.reduced()
    device = resolve_device(device)
    mesh = make_mesh(mesh_shape, ("data", "model"), devices=[device] * int(np.prod(mesh_shape)))
    built = build_step(arch, shape_name, mesh)
    cfg = arch.model_cfg
    dims = arch.shapes[shape_name].dims
    batch_fn = make_lm_batch_fn(cfg.vocab, dims["global_batch"], dims["seq_len"], seed,
                                device=device)

    def init_state():
        params, opt, _ = materialize_inputs(arch, shape_name, built, seed=seed)
        return params, opt

    def step_fn(state, batch):
        params, opt = state
        params, opt, metrics = built.fn(params, opt, batch)
        return (params, opt), metrics

    sup = TrainSupervisor(
        step_fn=step_fn,
        batch_fn=batch_fn,
        init_state_fn=init_state,
        ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every,
        injector=FailureInjector(inject_failures or {}),
        straggler=StragglerDetector(),
    )
    return sup.run(steps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--device", default="cuda",
                    help="device to train on: cuda (the default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    t0 = time.time()
    report = train_arch(
        args.arch, args.shape, steps=args.steps, ckpt_dir=args.ckpt_dir,
        reduced=not args.full, device=args.device,
    )
    print(
        f"steps={report.steps_run} restarts={report.restarts} "
        f"stragglers={report.straggler_events} "
        f"loss[0]={report.losses[0]:.4f} loss[-1]={report.losses[-1]:.4f} "
        f"wall={time.time()-t0:.1f}s"
    )


if __name__ == "__main__":
    main()
