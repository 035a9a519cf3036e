"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the program, compared by whole top-level
module name (the program's name begins with the JAX package's)."""

import ast
import sys
from pathlib import Path

import harness
import pytest

BENCH = harness.BENCH
FILES = sorted(BENCH.rglob("*.py"))
PROGRAM = "alphazeroforhnefatafl_tpu_torch"


def top_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    assert not set(top_names(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    names = set(top_names(path))
    assert PROGRAM not in names and not names & {"harness", "kinds"}


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PROGRAM + "_fake_probe", sys)
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.probe", sys)
    assert "jaxlib" in harness.forbidden_modules()
