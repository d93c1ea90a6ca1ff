"""What a benchmark run loads: no JAX and no JAX package (by whole
top-level module name, so the port, whose name begins with the JAX
package's, is allowed), nothing of ``benchmarks/``, and a plain reference
that imports nothing of the program."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from lartpcbench.session import forbidden_modules  # noqa: E402

#: everything a run imports, in the order ``run.py`` imports it
PROBE = """
import json, sys
sys.argv = ["run.py"]
import run
run.set_environment()
from lartpcbench import cells, check, control, counts, metrics, peaks
from lartpcbench import session, trace, window
from plainref import lartpc, threefry
import repro_torch.launch.sim, repro_torch.core.batch, repro_torch.core.stages
import repro_torch.tune.autotune, repro_torch.core.depo
for name in [w["name"] for w in cells.load_benchmark()["workloads"]]:
    cell = cells.load_cell(name)
    cells.program_config(cell)
    for m in cells.load_benchmark()["end_to_end"] + \\
            cells.load_benchmark()["per_layer"]:
        metrics.reader(m["name"])
print(json.dumps(sorted(sys.modules)))
"""


def test_forbidden_names_compare_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.core", "repro", "repro.core",
            "jax", "jax.numpy", "jaxlib", "flax.linen", "jaxtyping",
            "reprox"]
    assert forbidden_modules(mods) == ["flax.linen", "jax", "jax.numpy",
                                       "jaxlib", "repro", "repro.core"]


def test_a_run_loads_no_jax_nor_the_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=BENCH, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in loaded
    assert forbidden_modules(loaded) == []
    assert not [m for m in loaded if m.split(".", 1)[0] == "benchmarks"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "plainref").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch",
                    "plainref"}, tops


def test_no_benchmark_file_reads_the_old_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert "benchmarks" not in tops, path
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
