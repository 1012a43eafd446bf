"""Nothing under perfbench/ imports JAX or the JAX package, the reference
imports nothing of the program, and nothing reads the JAX package's
benchmark suite or its result files."""
import ast
from pathlib import Path

import pytest

from perfbench.harness.main import FOREIGN, foreign_modules
from perfbench.harness.manifest import PERFBENCH

SOURCES = sorted(p for p in PERFBENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names |= {a.value for a in node.args if isinstance(a, ast.Constant)}
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(PERFBENCH).as_posix())
def test_no_jax_and_no_reference_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FOREIGN
    if "reference" in path.relative_to(PERFBENCH).parts:
        assert "repro_torch" not in tops
    if path.name != Path(__file__).name:  # this file names what it looks for
        text = path.read_text().replace("BENCH_RUN", "")
        assert "BENCH_" not in text and '"benchmarks' not in text and "'benchmarks" not in text


def test_foreign_module_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("repro_torch_lookalike"))
    assert "repro_torch_lookalike" not in foreign_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert "repro.core" in foreign_modules()
