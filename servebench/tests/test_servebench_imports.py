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


def servebench_imports(path):
    """The modules of ``servebench`` that ``path`` imports, by whole name."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names if a.name.split(".")[0] == "servebench")
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module == "servebench":
                yield from (f"servebench.{a.name}" for a in node.names)
            elif node.module.split(".")[0] == "servebench":
                yield node.module


def test_the_reference_imports_nothing_of_the_program():
    """Every kind's reference and counts, and what they share, import
    nothing but torch, the standard library's few, and one another."""
    paths = [os.path.join(d, f) for part in ("reference", "counts")
             for d, _, fs in os.walk(os.path.join(HERE, part)) for f in fs if f.endswith(".py")]
    assert {os.path.basename(p) for p in paths} >= {"transformer.py", "quant.py", "padding.py"}
    for path in paths:
        names = set(top_level_imports(path))
        assert names <= {"__future__", "typing", "re", "torch", "servebench"}, (path, names)
        for mod in servebench_imports(path):
            assert mod.startswith(("servebench.reference", "servebench.counts")), (path, mod)


def test_the_check_compares_whole_names():
    from servebench.run import FORBIDDEN as RUN_FORBIDDEN

    assert "repro" in RUN_FORBIDDEN and "repro_torch" not in RUN_FORBIDDEN
    assert "repro_torch".split(".")[0] not in set(RUN_FORBIDDEN)
