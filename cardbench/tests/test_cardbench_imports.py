"""What the benchmark may import and read: neither the harness nor the
reference imports JAX or the JAX package (``repro``), the reference
imports nothing of the port either, and nothing the harness runs reads the
JAX benchmarks' folder or their results. Module names are compared by the
part before the first dot, whole: the port's name begins with ``repro``."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}


def _sources(*parts):
    for p in parts:
        yield from sorted((BENCH / p).rglob("*.py")) if (BENCH / p).is_dir() else [BENCH / p]


def _top_level_imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_harness_imports_neither_jax_nor_the_jax_package():
    for path in _sources("run.py", "control.py", "harness", "metrics", "reference"):
        assert not (_top_level_imports(path) & NEVER), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert not (_top_level_imports(path) & (NEVER | {"repro_torch", "harness"})), path


def test_harness_reads_no_jax_benchmark_results():
    for path in _sources("run.py", "control.py", "harness", "metrics", "reference"):
        text = path.read_text()
        assert "BENCH_serve" not in text and "benchmarks/" not in text, path


def test_a_run_loads_none_of_them(tmp_path):
    """A whole CPU run of the cell machinery in a fresh process leaves no JAX
    module and no module of the JAX package in ``sys.modules``."""
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent / 'src')!r}]
        from pathlib import Path
        from harness import cell
        root = Path({str(tmp_path)!r})
        spec = json.loads(Path({str(BENCH.parent / 'BENCHMARK.json')!r}).read_text())
        cfg = json.loads(Path({str(BENCH / 'configs' / 'prox-d9.json')!r}).read_text())
        cfg.update(n_docs=120, mean_doc_len=60, vocab_size=900, sw_count=15, fu_count=30)
        (root / "cardbench" / "configs").mkdir(parents=True)
        (root / "cardbench" / "configs" / "t.json").write_text(json.dumps(cfg))
        import shutil
        for d in ("metrics", "traffic"):
            shutil.copytree(Path({str(BENCH)!r}) / d, root / "cardbench" / d)
        spec["configs"] = [dict(spec["configs"][1], name="t", file="cardbench/configs/t.json")]
        spec["workloads"] = [dict(spec["workloads"][1], name="t", config="t")]
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        result = cell.run(root, "t", 7, 0.5, False, t_start=time.time(), platform="cpu")
        assert result["correct"], result
        print(json.dumps(cell.forbidden_modules()))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
