"""Nothing the benchmark imports is JAX or the JAX package: the top-level
name of every import in ``perfbench/`` is compared whole (``repro_torch``
begins with ``repro``), and the plain reference imports nothing of the
program either.  A child interpreter then runs a tiny cell through the
harness and reports every top-level module it has loaded."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FENCED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    found = {(str(p.relative_to(BENCH)), m)
             for p in BENCH.rglob("*.py") for m in _imports(p)
             if m.split(".")[0] in FENCED}
    assert not found


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert tops <= {"__future__", "torch", "numpy", "math"}, (p, tops)


CHILD = """
import json, sys
from perfbench.tests.tiny import tiny_cell
from perfbench.harness.main import run_cell
res, run = run_cell(tiny_cell("moe-serve-loose"), 7, 0.05, 0, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_fenced_module():
    root = BENCH.parent
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "src")]))
    out = subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FENCED
