"""R2 ``set-iteration`` / ``id-key``: order- and identity-stable containers.

Two container idioms leak nondeterminism into an otherwise seeded run:

  * iterating a set (literal or ``set(...)`` call) feeds hash order —
    stable within one process, but ``PYTHONHASHSEED``-dependent across
    runs for strings — into whatever consumes the loop; scheduling code
    must sort first (``sorted(set(...))`` is the sanctioned spelling and
    is naturally not flagged, since the iterable is then the ``sorted``
    call);
  * keying a container on ``id(obj)`` ties results to allocator addresses,
    which no two processes share — a replayed run can't reproduce the
    mapping.  Intentional identity-memo sites carry
    ``# simlint: allow(id-key)``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding

SET_RULE = "set-iteration"
ID_RULE = "id-key"


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


def check(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        iters = []
        if isinstance(node, ast.For):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            iters.extend(g.iter for g in node.generators)
        for it in iters:
            if _is_set_expr(it):
                yield Finding(
                    ctx.path, it.lineno, it.col_offset, SET_RULE,
                    "iterating a set feeds hash order into the loop; "
                    "wrap it in sorted() so replays are order-stable")
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "id" and len(node.args) == 1):
            yield Finding(
                ctx.path, node.lineno, node.col_offset, ID_RULE,
                "id() keys tie results to allocator addresses that no "
                "replay can reproduce; key on stable identity (name, rid) "
                "or mark an intentional memo with `# simlint: allow(id-key)`")
