"""No run loads JAX or the JAX package, and the reference stands alone."""

import ast
import sys
import types
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(run.__file__).resolve().parent


@pytest.mark.parametrize("name, bad", [
    ("autogp_tpu_torch", False), ("autogp_tpu_torch.ops.cov", False),
    ("jaxtyping", False), ("autogp_tpu", True), ("autogp_tpu.ops", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True)])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, name,
                                                         bad):
    for key in list(sys.modules):
        if key.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, key)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in run.forbidden_modules()) is bad


def imported_top_levels(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = imported_top_levels(path)
    assert "autogp_tpu_torch" not in names
    assert names <= {"__future__", "math", "torch", "numpy", "benchmark"}
    text = path.read_text()
    assert "autogp_tpu_torch" not in text.replace(
        "imports nothing of the program", "")
