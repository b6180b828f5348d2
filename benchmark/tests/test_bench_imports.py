"""What the benchmark may import: nothing of the JAX package or JAX (by
whole top-level name: ``tpurt_torch`` is allowed, ``tpurt`` is not), and
its reference nothing of the program at all."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpurt"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert not {n for n in names if n.split(".")[0] == "tpurt_torch"}
    assert "benchmark.program" not in names and "benchmark.harness" not in names


def test_the_import_check_compares_whole_names():
    tops = {n.split(".")[0] for n in ("tpurt_torch.render", "tpurt.render", "jaxtyping")}
    assert tops & FORBIDDEN == {"tpurt"}
