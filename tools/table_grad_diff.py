"""two-tower's train gradients and losses of one tree against another's.

Runs two-tower-retrieval's train_batch at B 32,768 (V 10M x D 256) on a
(1, 1) mesh of card 0 with the package under ``--src``: the gradient of
one step's loss (``models.value_and_grad``, as the built step takes it),
then ``--steps`` built steps' losses and grad norms from the same seeded
state. ``--save PATH`` writes the loss, the step metrics, every leaf's
gradient but the item table's whole, and the item table's gradient on the
rows the batch touches (every other row must be 0: the count of those
that are not is written too). ``--against PATH`` does the same and
prints, leaf by leaf, the largest absolute difference and the elements
that differ from the saved tree's, and the losses' differences, as one
JSON line. Run it with one tree's ``src`` and ``--save``, then with the
other's and ``--against``, in one call:

  python tools/table_grad_diff.py --src PARENT/src --save build/parent_grads.pt
  python tools/table_grad_diff.py --src src --against build/parent_grads.pt

Needs a card.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

B, SEED = 32_768, 19


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--steps", type=int, default=3)
    out = ap.add_mutually_exclusive_group(required=True)
    out.add_argument("--save")
    out.add_argument("--against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from dataclasses import replace

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.recsys_archs import TWO_TOWER
    from repro_torch.kernels.build import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, materialize_inputs
    from repro_torch.models import recsys, value_and_grad
    from repro_torch.train.checkpoint import _flatten_with_names

    build(("embedding_bag", "segment_sum"))
    arch = replace(TWO_TOWER, shapes={"train_batch": ShapeSpec("train_batch", "train",
                                                               {"batch": B})})
    cfg = arch.model_cfg
    dev = torch.device("cuda", 0)
    built = build_step(arch, "train_batch", make_mesh((1, 1), ("data", "model"), devices=[dev]))
    params, opt, batch = materialize_inputs(arch, "train_batch", built, seed=SEED)
    loss, grads = value_and_grad(lambda p, b: recsys.twotower_loss(cfg, p, b), params, batch)
    rows = torch.unique(torch.cat([batch["hist"].reshape(-1), batch["item"]]).long())
    named = dict(_flatten_with_names(grads))
    item = named.pop("item_emb")
    off = torch.ones(item.shape[0], dtype=torch.bool, device=dev)
    off[rows] = False
    rec = {"loss": loss.cpu(), "item_rows": rows.cpu(), "item_emb": item[rows].cpu(),
           "item_nonzero_off_rows": int(((item != 0).any(dim=1) & off).sum()),
           **{k: v.cpu() for k, v in named.items()}}
    del grads, named, item, off
    torch.cuda.empty_cache()
    metrics = []
    for _ in range(args.steps):
        params, opt, m = built.fn(params, opt, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    rec["metrics"] = torch.tensor(metrics, dtype=torch.float64)
    if args.save:
        Path(args.save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(rec, args.save)
        print(json.dumps({"saved": args.save, "loss": float(rec["loss"]), "metrics": metrics,
                          "item_nonzero_off_rows": rec["item_nonzero_off_rows"]}))
        return
    want = torch.load(args.against)
    if not torch.equal(want["item_rows"], rec["item_rows"]):
        raise SystemExit("the two runs' batches differ")
    leaves = {}
    for k, v in rec.items():
        if k in ("item_rows", "metrics", "item_nonzero_off_rows"):
            continue
        d = (v.double() - want[k].double()).abs()
        leaves[k] = {"max_abs_diff": float(d.max()), "differing": int((v != want[k]).sum()),
                     "elements": v.numel(), "max_abs": float(want[k].abs().max())}
    print(json.dumps({"leaves": leaves, "metrics": metrics,
                      "against_metrics": want["metrics"].tolist(),
                      "metrics_max_rel_diff": float((rec["metrics"] / want["metrics"] - 1)
                                                    .abs().max()),
                      "item_nonzero_off_rows": [want["item_nonzero_off_rows"],
                                                rec["item_nonzero_off_rows"]],
                      "card": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
