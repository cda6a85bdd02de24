"""The benchmark's import rules, by the source of every module under it."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "multimodalemotionrecognition_tpu"}
PORT = "multimodalemotionrecognition_torch"
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imported(path: Path) -> set:
    """Top-level names of every module `path` imports, compared whole."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & JAX_SIDE


def test_the_port_name_is_not_the_jax_package_name():
    assert PORT.split(".")[0] not in JAX_SIDE
    assert PORT.startswith("multimodalemotionrecognition")


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imported(path)
    # Nor anything of the harness that does.
    assert not {"perfbench.drivers", "perfbench.harness"} & {
        n.module for n in ast.walk(ast.parse(path.read_text()))
        if isinstance(n, ast.ImportFrom) and n.module}


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_reads_the_jax_benchmarks(path):
    strings = {n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    folder, script = "bench" + "marks", "bench" + ".py"
    assert not any(s == folder or s.startswith(folder + "/") or s == script
                   or s.endswith("/" + script) for s in strings)
