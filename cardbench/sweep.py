"""Run one cell several times in a row and summarise the runs.

    python3 cardbench/sweep.py --workload <cell> --seeds <n> [<n> ...]
        --seconds <s> [--trace 0|1] --out <folder>

Each run is ``cardbench/run.py`` in a process of its own, one after the
other (one process on the card at a time). Its standard output and error
go to ``<folder>/<cell>-<seed>-t<trace>.{out,err}``, its result line to
``<folder>/runs.jsonl`` with the exit code and the wall time of the run.
At the end, for each metric: the values in run order, the median and the
spread, (Q3 - Q1) / median with ``statistics.quantiles(values, n=4)``.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    values: dict[str, list] = {}
    for seed in args.seeds:
        stem = out / f"{args.workload}-{seed}-t{args.trace}"
        t = time.perf_counter()
        with open(f"{stem}.out", "w") as so, open(f"{stem}.err", "w") as se:
            rc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", args.workload,
                                 "--seed", str(seed), "--seconds", str(args.seconds),
                                 "--trace", str(args.trace)], stdout=so, stderr=se,
                                cwd=BENCH.parent).returncode
        wall = time.perf_counter() - t
        lines = Path(f"{stem}.out").read_text().strip().splitlines()
        result = None
        if rc == 0 and lines:
            try:
                result = json.loads(lines[-1])
            except json.JSONDecodeError:
                result = None
        row = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": rc,
               "wall_s": wall, "result": result}
        with open(out / "runs.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")
        short = {k: round(v["value"], 4) for k, v in (result or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": rc, "wall_s": round(wall, 1),
                          "correct": (result or {}).get("correct"),
                          "checks": (result or {}).get("checks"), "metrics": short}), flush=True)
        for k, v in (result or {}).get("metrics", {}).items():
            values.setdefault(k, []).append(v["value"])
    for k, vs in values.items():
        print(json.dumps({"metric": k, "values": vs, "median": statistics.median(vs),
                          "spread": spread(vs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
