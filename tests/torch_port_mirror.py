"""Helpers for the port's CPU tests of the modules it copies from the JAX
package (gis/, config.py, webapp/, utils/visualize.py, native/).

- ``mirror_jax_tests``: runs a numpy-only JAX test module against the port:
  its source with every ``crop2seg_tpu.`` module path pointed at
  ``crop2seg_tpu_torch.``, its tests and fixtures put into the caller's
  namespace, where pytest collects them.
- ``same_code``: the top-level functions and classes of a port module
  against those of its JAX twin, docstrings aside and module paths mapped:
  the same code gives the same result on every input.
- ``jax_native``: the JAX package's native loader, built by its own binding
  into a temporary directory rather than beside its source (test workers
  that build there at once could load a half-written library).
"""
from __future__ import annotations

import ast
import re
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


def _to_port(src: str) -> str:
    return re.sub(r"\bcrop2seg_tpu\.", "crop2seg_tpu_torch.", src)


def mirror_jax_tests(stem: str, namespace: dict, skip=()) -> list:
    """Exec ``tests/<stem>.py`` against the port; each ``test_<name>``
    becomes ``test_<stem minus test_>__<name>`` in ``namespace`` (fixtures
    keep their names). Returns the names of the mirrored tests."""
    src = _to_port((TESTS / f"{stem}.py").read_text())
    mod = types.ModuleType(f"tests._port_{stem}")
    mod.__file__ = str(TESTS / f"{stem}.py")
    exec(compile(src, f"<tests/{stem}.py on crop2seg_tpu_torch>", "exec"), mod.__dict__)
    names = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and callable(obj):
            if name in skip:
                continue
            new = f"test_{stem[len('test_'):]}__{name[len('test_'):]}"
            namespace[new] = obj
            names.append(new)
        elif hasattr(obj, "_fixture_function_marker") or hasattr(
                obj, "_pytestfixturefunction"):    # a fixture (pytest >= 8.4, older)
            namespace[name] = obj
    return names


class _StripDocs(ast.NodeTransformer):
    """Drops docstrings and maps crop2seg_tpu module paths to the port's."""

    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) and isinstance(
                getattr(body[0], "value", None), ast.Constant) and isinstance(
                body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _strip

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = _to_port(node.value)
        return node

    def visit_ImportFrom(self, node):
        if node.module and (node.module == "crop2seg_tpu"
                            or node.module.startswith("crop2seg_tpu.")):
            node.module = "crop2seg_tpu_torch" + node.module[len("crop2seg_tpu"):]
        return node

    def visit_Import(self, node):
        for alias in node.names:
            if alias.name.startswith("crop2seg_tpu."):
                alias.name = "crop2seg_tpu_torch." + alias.name[len("crop2seg_tpu."):]
        return node


def top_level_code(path: Path) -> dict:
    """{name: ast dump} of a module's top-level defs, classes and
    assignments, docstrings dropped and module paths mapped to the port."""
    tree = _StripDocs().visit(ast.parse(path.read_text()))
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node)
    return out


def same_code(rel: str, names=None) -> dict:
    """The names of ``crop2seg_tpu/<rel>`` whose code differs in
    ``crop2seg_tpu_torch/<rel>`` (or is missing there), as {name: reason};
    ``names`` restricts the comparison."""
    jax_code = top_level_code(REPO / "crop2seg_tpu" / rel)
    port_code = top_level_code(REPO / "crop2seg_tpu_torch" / rel)
    diff = {}
    for name in names or jax_code:
        if name not in port_code:
            diff[name] = "missing in the port"
        elif port_code[name] != jax_code[name]:
            diff[name] = "differs"
    return diff


def jax_native(tmp_dir: Path):
    """``crop2seg_tpu.native`` with its library built (by its own ``_build``,
    same flags) into ``tmp_dir`` unless it is loaded already."""
    from crop2seg_tpu import native as jn

    if jn._LIB is None:
        saved = jn._SO
        jn._SO = str(tmp_dir / "_loader.so")
        try:
            assert jn.available(), "the JAX package's native loader did not build"
        finally:
            jn._SO = saved
    return jn
