"""No module of the benchmark imports JAX or the JAX package, or reads its
CPU benchmark; names are compared whole, so ``repro_torch`` passes."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE) for f in fs
                 if f.endswith(".py"))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_nor_the_jax_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN
    with open(path) as f:
        text = f.read()
    cpu_harness = "bench" + "marks/"
    assert cpu_harness not in text.replace("servebench/", "")


def test_the_reference_imports_nothing_of_the_program():
    for name in ("model.py", "quant.py"):
        names = set(top_level_imports(os.path.join(HERE, "reference", name)))
        assert names <= {"__future__", "typing", "torch", "servebench"}, names


def test_the_check_compares_whole_names():
    from servebench.run import FORBIDDEN as RUN_FORBIDDEN

    assert "repro" in RUN_FORBIDDEN and "repro_torch" not in RUN_FORBIDDEN
    assert "repro_torch".split(".")[0] not in set(RUN_FORBIDDEN)
