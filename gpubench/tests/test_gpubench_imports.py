"""Nothing in ``gpubench/`` imports JAX or the JAX package, and the
reference imports nothing of the program either.  Top-level module
names are compared whole: ``tempo_tpu_torch`` is not ``tempo_tpu``."""

import ast
from pathlib import Path

import pytest

from gpubench import harness

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "tempo_tpu"}


def _top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_import(path):
    assert not (_top_imports(path) & JAX_NAMES), path


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "tempo_tpu_torch" not in _top_imports(path)
    assert "gpubench" not in _top_imports(path)


def test_whole_name_comparison(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "tempo_tpu_torch_fake",
                        types.ModuleType("tempo_tpu_torch_fake"))
    assert "tempo_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tempo_tpu.sub",
                        types.ModuleType("tempo_tpu.sub"))
    assert "tempo_tpu.sub" in harness.forbidden_modules()
