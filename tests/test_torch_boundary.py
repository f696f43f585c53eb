"""Import boundary of the PyTorch port: ``src/repro_torch/`` and
``chip_smoke.py`` import neither JAX nor anything of the reference
package ``repro`` — the port keeps its own copies of what it needs."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"]

_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_REPRO = re.compile(r"^\s*(import|from)\s+repro(?!_torch)\b", re.M)
_DYNAMIC = re.compile(r"import_module\(\s*['\"](jax|repro(?!_torch))\b")


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_or_reference_import(rel):
    text = (REPO / rel).read_text()
    assert not _JAX.search(text), f"{rel} imports jax"
    assert not _REPRO.search(text), f"{rel} imports the reference package"
    assert not _DYNAMIC.search(text), f"{rel} imports jax/repro dynamically"


def test_every_module_imports_with_jax_and_repro_poisoned():
    """Each port module (and chip_smoke.py, which only defines functions
    at import) imports in a fresh interpreter where ``import jax`` and
    ``import repro`` fail."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 30
