"""Nothing of the benchmark imports JAX, its libraries or the JAX
package: top-level import names compared whole (the port's package,
``repro_torch``, begins with the JAX package's name)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(ROOT.rglob("*.py"))


def _top_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    names = set(_top_names(ast.parse(path.read_text())))
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").glob("*.py"):
        names = set(_top_names(ast.parse(path.read_text())))
        assert names <= {"__future__", "math", "typing", "numpy", "torch"}, \
            f"{path} imports {names}"


def test_the_check_compares_whole_names():
    from perfbench.bench import forbidden_modules
    import sys
    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    assert "repro" not in forbidden_modules()
