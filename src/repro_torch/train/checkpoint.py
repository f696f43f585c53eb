"""Fault-tolerant checkpointing (the reference's ``train/checkpoint.py``),
in its on-disk layout, name for name.

* a checkpoint is a directory ``step_<N>/`` of one ``.npy`` file per leaf
  plus a JSON manifest (step, meta, and each leaf's name, file, shape and
  dtype);
* leaves are named and ordered as JAX's ``tree_flatten_with_path`` names
  and orders them: dict keys sorted, list and tuple entries by index,
  joined by ``/``. A checkpoint written by either package restores in the
  other;
* writes go to ``step_<N>.tmp/`` and are renamed into place, so a crash
  mid-write never corrupts the latest valid checkpoint;
* ``AsyncCheckpointer`` serialises on a background thread (one save in
  flight). It copies every leaf to the host before ``save`` returns: the
  port's steps update their tensors in place, so a thread that read them
  later would save a later step;
* retention keeps the last ``keep`` checkpoints.

``restore_checkpoint(..., device=)`` takes the place of the reference's
``mesh=``/``pspecs=``: leaves land on ``device``, or, without one, where
the example's leaf lies (a non-tensor example leaf: the card unless the
caller names another device).
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models import tree_unflatten

_SEP = "/"


def _flatten_with_names(tree, prefix=()):
    """[(name, leaf)] in ``jax.tree_util.tree_flatten_with_path`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_with_names(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten_with_names(v, prefix + (i,))]
    if tree is None:
        return []
    return [(_SEP.join(str(p) for p in prefix), tree)]


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later writes into it do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save_checkpoint(ckpt_dir: str | Path, step: int, tree, meta: dict | None = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": []}
    for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
        arr = leaf if isinstance(leaf, np.ndarray) else _to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        )
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.iterdir():
        if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp"):
            if (d / "manifest.json").exists():
                steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | Path, example_tree, step: int | None = None,
                       device=None):
    """Restore into the structure of ``example_tree`` -> (tree, manifest),
    each leaf a tensor on ``device`` (see the module docstring)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_name = {rec["name"]: rec for rec in manifest["leaves"]}
    out = []
    for name, leaf in _flatten_with_names(example_tree):
        rec = by_name.get(name)
        if rec is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(d / rec["file"])
        if device is not None or not isinstance(leaf, torch.Tensor):
            where = resolve_device(device)
        else:
            where = leaf.device
        out.append(torch.from_numpy(arr).to(where))
    return tree_unflatten(example_tree, out), manifest


def gc_checkpoints(ckpt_dir: str | Path, keep: int = 3) -> None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    steps = sorted(
        d for d in ckpt_dir.iterdir()
        if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training (one save in flight)."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, meta: dict | None = None) -> None:
        """Copy every leaf to the host now, then write on a thread."""
        self.wait()  # at most one save in flight
        host_tree = tree_unflatten(tree, [_to_host(leaf) for _, leaf in _flatten_with_names(tree)])

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, meta)
                gc_checkpoints(self.ckpt_dir, self.keep)
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
