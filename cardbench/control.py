"""The control of the benchmark's correctness check, at a cell's own size.

    python3 cardbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's corpus and the first block of its stream, made
from the seed as a run makes them, a sample of those queries drawn with
the judge's seed, the plain reference computed with
bfloat16 scores (the precision below the float32 that the configuration
states) put in the program's place, and the same judge a run uses. Prints
one JSON line a seed with the numbers compared; the control has to fail
them. It needs no card and builds no index.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sample", type=int, default=256)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))

    import numpy as np

    from harness import judge
    from harness.cell import Bench, inputs, seeds
    from reference.search import Reference

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    top_k = int(config["serve"].get("top_k", 16))
    for seed in args.seeds:
        t = time.perf_counter()
        corpus, stream = inputs(config, mix, seed)
        pool = stream.queries
        ref = Reference(corpus.doc_ids, corpus.positions, corpus.lemma_ids, corpus.doc_lengths,
                        corpus.doc_freqs, max_distance=int(config["max_distance"]),
                        sw_count=corpus.sw_count, fu_count=corpus.fu_count)
        rng = np.random.default_rng(seeds(seed)[2])
        picks = rng.choice(len(pool), size=min(args.sample, len(pool)), replace=False)
        served = {"control": [(pool[i], ref.answer(pool[i], "qt1", top_k, precision="bfloat16"))
                              for i in picks]}
        # the control's answers are judged as compiled-route answers
        verdict = judge.judge(_Compiled(ref), served, top_k)
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": "bfloat16",
                          "numbers": verdict["numbers"], "limits": judge.LIMITS,
                          "compared": verdict["compared"],
                          "correct": judge.passed(verdict),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


class _Compiled:
    """The reference, asked for compiled-route records whatever the label."""

    def __init__(self, ref):
        self.ref = ref

    def answer(self, q, route, k):
        return self.ref.answer(q, "qt1", k)


if __name__ == "__main__":
    sys.exit(main())
