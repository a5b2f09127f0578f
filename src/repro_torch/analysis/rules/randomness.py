"""R2 ``unseeded-random``: all randomness must flow through explicit seeds.

Module-level RNGs (``random.random()``, ``np.random.uniform()``,
``torch.randn(...)`` without ``generator=``) draw from hidden global state:
results then depend on import order and on every other caller, so two runs
of the same workload diverge.  Simulator and driver code alike must
construct an explicitly seeded generator (``np.random.RandomState(seed)``,
``np.random.default_rng(seed)``, a ``torch.Generator`` seeded with
``manual_seed``) and thread it through.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding

RULE = "unseeded-random"

# constructors that are fine WITH a seed argument but hidden-global without
_CTORS = {"RandomState", "default_rng", "PRNGKey", "SeedSequence", "Random"}

# torch's draws from its module-global generator unless given ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
                "multinomial"}


def _torch_aliases(tree: ast.AST) -> Set[str]:
    """Names bound to the ``torch`` module, and draws imported from it."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch":
                    out.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name in _TORCH_DRAWS:
                    out.add("draw:" + (a.asname or a.name))
    return out


def _module_aliases(tree: ast.AST) -> Set[str]:
    """Names bound to the stdlib ``random`` or ``numpy.random`` modules."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in ("random", "numpy.random"):
                    out.add((a.asname or a.name).split(".")[0]
                            if a.name == "random" else (a.asname or a.name))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "numpy" and any(a.name == "random"
                                              for a in node.names):
                for a in node.names:
                    if a.name == "random":
                        out.add(a.asname or "random")
    return out


def check(ctx: FileContext) -> Iterator[Finding]:
    rand_modules = _module_aliases(ctx.tree)
    torch_names = _torch_aliases(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        # torch.<draw>(...) (or a draw imported from torch) on the global
        # generator: no generator= keyword
        draw = None
        if (isinstance(func, ast.Attribute) and func.attr in _TORCH_DRAWS
                and isinstance(func.value, ast.Name)
                and func.value.id in torch_names):
            draw = func.attr
        elif isinstance(func, ast.Name) and "draw:" + func.id in torch_names:
            draw = func.id
        if draw is not None:
            if not any(kw.arg == "generator" for kw in node.keywords):
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, RULE,
                    f"torch.{draw}() without generator= draws from torch's "
                    "module-global generator; pass a seeded torch.Generator")
            continue
        # np.random.<fn>(...) — attribute chain ending in .random.<fn>
        if isinstance(func, ast.Attribute):
            base = func.value
            # numpy's module-global RNG only: a keyed (functional) random
            # module is explicit, so X.random.<fn> is flagged just for
            # numpy-rooted chains
            via_np = (isinstance(base, ast.Attribute)
                      and base.attr == "random"
                      and isinstance(base.value, ast.Name)
                      and base.value.id in ("np", "numpy"))
            via_alias = (isinstance(base, ast.Name)
                         and base.id in rand_modules)
            if (via_np or via_alias) and func.attr not in _CTORS:
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, RULE,
                    f"module-global RNG call {func.attr}() draws from "
                    "hidden state; construct an explicitly seeded "
                    "generator and thread it through")
                continue
        # RandomState()/default_rng()/PRNGKey() with no seed argument
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        if name in _CTORS and not node.args and not node.keywords:
            yield Finding(
                ctx.path, node.lineno, node.col_offset, RULE,
                f"{name}() without a seed is entropy-seeded; pass an "
                "explicit seed so runs replay bit-identically")
