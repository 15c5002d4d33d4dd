"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (``repro_torch`` is not ``repro``); the reference
imports nothing of the port; no source names the JAX package's harness
folder."""
import ast

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the JAX package's own harness folder, which the benchmark never reads
JAX_HARNESS = "bench" + "marks"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN
    assert JAX_HARNESS not in path.read_text()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imported(path)
    assert "repro_torch" not in names and not names & {"system", "harness"}
    assert names <= {"__future__", "math", "torch"}


def test_the_whole_name_is_compared():
    assert "repro_torch" not in FORBIDDEN and "repro_torch".split(".")[0] != "repro"
