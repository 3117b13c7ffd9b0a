"""Nothing in the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), the
yardstick imports nothing of the program, and nothing reads the JAX
package's benchmarks."""
import ast

import pytest

from portbench import common

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: counts, inputs, the comparison and the references
NO_PROGRAM = ("counts.py", "inputs.py", "check.py", "reference/")
FILES = sorted(p for p in common.BENCH.rglob("*.py"))


def imported(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(common.BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES
                                  if str(p.relative_to(common.BENCH)).startswith(NO_PROGRAM)],
                         ids=lambda p: str(p.relative_to(common.BENCH)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(common.BENCH)))
def test_nothing_reads_the_jax_benchmarks(path):
    text = path.read_text()
    for folder in ("bench" + "marks/", "res" + "ults/"):
        assert folder not in text


def test_the_guard_compares_whole_names():
    from portbench.run import FORBIDDEN as GUARD

    assert set(GUARD) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in GUARD
