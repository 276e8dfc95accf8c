"""No file of the benchmark imports JAX or the JAX package, the plain
reference imports nothing of the program, and a whole run loads neither.

Names are compared by their top-level part (before the first dot), whole:
``repro_torch`` begins with ``repro`` and is not it.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from tcbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(spec.BENCH_DIR.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


def test_the_files_are_found():
    names = {p.name for p in FILES}
    assert {"run.py", "harness.py", "loop.py", "triangles.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not FORBIDDEN & set(_imports(path)), path


def test_the_reference_and_generators_import_nothing_of_the_program():
    for folder in ("references", "generators"):
        for path in (spec.BENCH_DIR / folder).glob("*.py"):
            mods = set(_imports(path))
            assert not mods & (FORBIDDEN | {"repro_torch"}), path
            assert mods <= {"__future__", "hashlib", "math", "numpy", "torch",
                            "typing", "tcbench"}, (path, mods)


def test_a_run_loads_no_jax(tmp_path):
    """A whole small run on the CPU, in a fresh interpreter, then the
    top-level names of every loaded module."""
    code = f"""
import json, sys, time, torch
sys.path[:0] = [{str(spec.ROOT / 'src')!r}, {str(spec.ROOT)!r}]
from tcbench import harness, spec
cfg = dict(spec.load_config("graph500-s19"),
           params={{"scale": 7, "edge_factor": 8, "a": 0.57, "b": 0.19,
                    "c": 0.19, "permute": True}})
run = harness.run_cell("g.warm", "graph500-s19", cfg, "warm",
                       dict(spec.load_mix("warm"), warm_seconds=0), 3, 0.01,
                       False,
                       torch.device("cpu"), time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "tcbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
