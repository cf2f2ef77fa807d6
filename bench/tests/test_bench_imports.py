"""Nothing under ``bench/`` imports JAX or the JAX package, and the
reference imports nothing of the program."""

from __future__ import annotations

import ast

import pytest

from bench.tests.tiny import BENCH

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_or_jax_package(path):
    held = set(top_level_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
    assert not held, f"{path} imports {held}"


@pytest.mark.parametrize("name", ["reference.py", "work.py", "loadgen.py", "schedule.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in set(top_level_imports(BENCH / name))
