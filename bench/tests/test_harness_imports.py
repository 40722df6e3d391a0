"""Nothing under ``bench/`` imports JAX or the JAX package, the plain
references import nothing of the port, and nothing reads the JAX
package's ``benchmarks/``.  Top-level module names are compared whole:
the port's name, ``repro_torch``, begins with the JAX package's."""
from __future__ import annotations

import ast

import pytest

from harness_tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN
    if path.name != "test_harness_imports.py":
        assert "benchmarks" not in set(_top_level_imports(path))
        assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    mods = set(_top_level_imports(path))
    assert "repro_torch" not in mods and "harness" not in mods


def test_whole_names_are_compared():
    assert "repro_torch" not in FORBIDDEN
    assert "repro_torch".split(".", 1)[0] != "repro"
