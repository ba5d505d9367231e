"""Nothing in the benchmark imports JAX or the JAX package, and the
references import nothing of the port: each import's top-level name is
compared whole, so the port (`repro_torch`) is not taken for `repro`."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from perfbench import harness

HOME = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HOME.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(
    HOME).as_posix())
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HOME / "refs").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "repro" not in top_level_imports(path)


def test_runner_takes_the_port():
    assert "repro_torch" in set().union(*(
        top_level_imports(p) for p in (HOME / "drivers").glob("*.py")))


def test_guard_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "jaxtyping", "flax_like"]) == []
    assert harness.forbidden_modules(["repro.models", "jax", "jaxlib._x",
                                      "flax"]) == ["flax", "jax", "jaxlib",
                                                   "repro"]
