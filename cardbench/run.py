"""Run one cell of the port's benchmark once.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``src/repro_torch``). Standard error gets the set-up, the
window, the routes taken, the device's memory, the reference's verdict
and, as its last lines, each number compared beside its limit; the last
line of standard output is the result's JSON object. Without the cards
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with another code than 0.
"""

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def process_start() -> float:
    """When this process started (wall clock), from its age in /proc."""
    try:
        after_name = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start_ticks = int(after_name[19])  # field 22 of stat(5)
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def card_line() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    # build and kernel caches at fixed places inside the checkout
    cache = ROOT / "build" / "cardbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)

    from harness import cell

    card = card_line()
    if card:
        log(f"card: {card}")
    try:
        result = cell.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start, log=log)
    except cell.NoDevice as e:
        log(str(e))
        return 2
    bad = cell.forbidden_modules()
    if bad:
        log(f"loaded in this process once the window closed: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
