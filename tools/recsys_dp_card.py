"""The recsys data shards on the card, alone: ``chip_smoke.py``'s pieces.

Builds the embedding bag, runs two-tower-retrieval's train_batch at
B 32,768 on a (1, 1) mesh of the card (the train phase's
``twotower_train``), then data-parallel on a (2, 1) mesh of the card
(and a (4, 1) mesh of four cards when four are visible) against it
(``md_twotower_train``), the reduced four recsys archs on (2, 1) and
(2, 2) meshes of the card and the host (``md_recsys_dp``), din's and
bert4rec's serving replicas (``md_serving_replicas``) and the tp phase.

  python tools/recsys_dp_card.py

Lines as ``chip_smoke.py`` prints them; the records also go to
``results/recsys_dp_card.json``. Needs a card.
"""

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.build import build  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = cs.header()
    cs.log(smi)
    t0 = time.perf_counter()
    cs.log("build", build(("embedding_bag",)))
    one = make_mesh((1, 1), ("data", "model"), devices=[dev])
    tt = cs.twotower_train(dev, one)
    out = {"1x1": {k: tt[k] for k in ("losses", "grad_norms", "step_ms", "peak_bytes")}}
    cs.log("(1, 1)", out["1x1"])
    for name, mesh in cs.md_dp_meshes(dev):
        out[name] = cs.md_twotower_train(mesh, {}, tt)
        cs.log(name, json.dumps(out[name], default=str))
    out["recsys_dp"] = cs.md_recsys_dp(dev, one, {})
    for k, v in out["recsys_dp"].items():
        cs.log("data shards", k, json.dumps(v))
    out["serving_replicas"] = cs.md_serving_replicas(dev, one)
    cs.log("serving replicas", json.dumps(out["serving_replicas"]))
    cs.tp_phase(dev, smi)
    cs.log("total s", time.perf_counter() - t0)
    (ROOT / "results").mkdir(exist_ok=True)
    (ROOT / "results" / "recsys_dp_card.json").write_text(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
