"""Puts the benchmark's folder and the port's sources on the import path, as
``cardbench/run.py`` finds them when it runs from the root of a checkout."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
