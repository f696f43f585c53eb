"""Where AdamW rounds otherwise on the card and on the host.

Replicas of a parameter held once per data shard, one on the card and
one on the host, stay equal only if the two round every op of the update
alike. This prints:

* op by op, float32 ``mul``/``add``/``div``/``sqrt``/``square``/``sub`` on
  the card against the host, the number of elements that differ;
* ``sqrt`` on each against the correctly rounded root (float64's root
  rounded once to float32);
* three ``adamw_update`` steps on the card and on the host from one state:
  the elements of the parameters and moments that differ, and by how much;
* ``adamw_update``'s time over two-tower-retrieval's tables (2.59G float32
  parameters) on the card.

  python tools/adamw_root_check.py

Needs a card.
"""

import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state  # noqa: E402

ELEMS = 1 << 20
V, D, CATES = 10_000_000, 256, 100_000  # two-tower-retrieval's tables


def timed_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    print(torch.cuda.get_device_name(0))
    torch.manual_seed(0)
    x, y, s = torch.randn(ELEMS), torch.rand(ELEMS) + 0.5, torch.tensor(0.731)
    ops = {"mul scalar": lambda a, c, d: a * 0.9, "add": lambda a, c, d: a + c,
           "mul": lambda a, c, d: a * c, "div 0-dim": lambda a, c, d: a / d,
           "div": lambda a, c, d: a / c, "sqrt": lambda a, c, d: c.sqrt(),
           "square": lambda a, c, d: a * a, "sub": lambda a, c, d: a - c}
    for name, f in ops.items():
        host, card = f(x, y, s), f(x.to(dev), y.to(dev), s.to(dev)).cpu()
        print(f"op {name}: card against host, {int((host != card).sum())} of {ELEMS} differ")
    torch.manual_seed(0)
    v = torch.rand(ELEMS) * 3 + 1e-6
    exact = v.double().sqrt().float()
    print("sqrt against the correctly rounded root, elements that differ: host",
          int((v.sqrt() != exact).sum()), "card", int((v.to(dev).sqrt().cpu() != exact).sum()))
    cfg = AdamWConfig(lr=1e-3, weight_decay=0.0)
    p, g = torch.randn(4096, 64), torch.randn(4096, 64) * 0.01
    outs = []
    for where in (cpu, dev):
        q = {"w": p.clone().to(where)}
        state = init_opt_state(q)
        for _ in range(3):
            q, state, _ = adamw_update(cfg, q, {"w": g.to(where)}, state)
        outs.append((q["w"].cpu(), state["mu"]["w"].cpu(), state["nu"]["w"].cpu()))
    print("adamw_update, 3 steps, card against host (params, mu, nu): elements that differ",
          [int((a != b).sum()) for a, b in zip(*outs)], "of", p.numel(), "each, max abs diff",
          [float((a - b).abs().max()) for a, b in zip(*outs)])
    params = {"item_emb": torch.randn(V, D, device=dev), "cate_emb": torch.randn(CATES, D, device=dev)}
    grads = {k: torch.randn_like(t) * 1e-3 for k, t in params.items()}
    state = init_opt_state(params)
    times = [timed_ms(lambda: adamw_update(cfg, params, grads, state)) for _ in range(5)]
    print(f"adamw_update over {sum(t.numel() for t in params.values())} parameters, ms:",
          [round(t, 2) for t in times], "median", round(statistics.median(times), 2))

if __name__ == "__main__":
    main()
