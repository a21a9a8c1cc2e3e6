"""What the benchmark may load: nothing of JAX or the JAX package anywhere
under portbench/, and nothing of the program in the reference. Top-level
module names are compared whole (``crop2seg_tpu_torch`` is the program,
``crop2seg_tpu`` the JAX package)."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "crop2seg_tpu"}


def _sources(top: str) -> list:
    return sorted(os.path.join(d, f) for d, _, files in os.walk(top) for f in files
                  if f.endswith(".py"))


def _imported(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(BENCH), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not _imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources(os.path.join(BENCH, "reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "crop2seg_tpu_torch" not in _imported(path)


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); {code}; "
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=300, check=True, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(out.stdout.split()[-1000:])


def test_harness_loads_no_jax():
    """Everything run.py loads, the program included, with a training cell
    driven end to end at a tiny size on the CPU."""
    code = ("from portbench.tests.tiny import tiny_run; "
            "from portbench.harness import train; "
            "assert train.run_cell(tiny_run('timeunet_v1', 'train'))['attempted']")
    loaded = _loaded(code)
    assert "crop2seg_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import portbench.reference.timeunet_v1, portbench.reference.utae")
    assert not loaded & (FORBIDDEN | {"crop2seg_tpu_torch"})
