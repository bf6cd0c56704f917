"""What the benchmark may import. No module of it imports JAX, jaxlib, flax or
the JAX package ``imm_tpu``; the plain reference imports nothing of the
program ``imm_tpu_torch`` either. Top-level names are compared whole:
``imm_tpu_torch`` begins with ``imm_tpu`` and is not it."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

HOME = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "imm_tpu"}


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources(HOME):
        assert not _top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(HOME / "reference"):
        assert "imm_tpu_torch" not in _top_level_imports(path), path


def test_the_top_level_names_are_compared_whole():
    from bench_port.run import forbidden_modules

    assert "imm_tpu_torch" not in FORBIDDEN
    assert all(m.split(".")[0] != "imm_tpu" for m in forbidden_modules() if m.startswith("imm_tpu_"))


def test_a_run_loads_no_jax():
    """A tiny run of each cell on the CPU in a fresh process, then the
    harness's own look at ``sys.modules``."""
    code = (
        "import json, sys\n"
        "from bench_port.run import run_cell, forbidden_modules\n"
        "from bench_port.test_bench_port_cells import TINY\n"
        "for name, over in TINY.items():\n"
        "    assert run_cell(name, 7, 0.1, False, device='cpu', overrides=over)['correct']\n"
        "print(json.dumps(forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=HOME.parent, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
