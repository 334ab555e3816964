"""What the benchmark imports, read from its sources: nothing of JAX or
the JAX package anywhere, and nothing of the program in the reference
or the counts. Top-level names are compared whole, so the port
``repro_torch`` is not the JAX package ``repro``."""

import ast
import sys
from pathlib import Path

import pytest

from chipbench import harness

PKG = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_top_levels(path: Path) -> set[str]:
    """Top-level names of every module a source file imports, relative
    imports resolved inside the benchmark's package."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(PKG.name if node.level else
                      node.module.split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name in (
    "reference", "counts")], ids=lambda p: str(p.relative_to(PKG)))
def test_reference_and_counts_import_nothing_of_the_program(path):
    assert "repro_torch" not in imported_top_levels(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro.fake" in harness.forbidden_modules()
