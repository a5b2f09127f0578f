"""R2 ``wall-clock``: no wall-clock reads inside simulator code.

The serving simulator is a virtual-time machine: given a workload and a
seed, every replica timeline, joule, and gram must replay bit-identically.
A ``time.time()`` / ``perf_counter()`` read inside scheduling code couples
results to the host, silently breaking determinism.  Sanctioned measurement
sites (step-time calibration in ``stepcache.py``, the measure closures in
``scheduler.py``, codec timing in ``server.py``) carry a
``# simlint: allow(wall-clock)`` pragma.

Driver code (``chip_smoke.py``, ``scripts/torch_*.py``) is out of scope: timing real
hardware and real simulator runtime is its job.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding

RULE = "wall-clock"

_TIME_FNS = {"time", "perf_counter", "monotonic", "process_time", "clock",
             "time_ns", "perf_counter_ns", "monotonic_ns"}
_DATETIME_FNS = {"now", "utcnow", "today"}


def _aliases(tree: ast.AST) -> Dict[str, str]:
    """name-in-scope -> canonical ``module.attr`` for time/datetime reads."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in ("time", "datetime"):
                    out[a.asname or a.name] = f"module:{a.name}"
        elif isinstance(node, ast.ImportFrom):
            if node.module == "time":
                for a in node.names:
                    if a.name in _TIME_FNS:
                        out[a.asname or a.name] = f"time.{a.name}"
            elif node.module == "datetime":
                for a in node.names:
                    if a.name == "datetime":
                        out[a.asname or a.name] = "module:datetime"
    return out


def check(ctx: FileContext) -> Iterator[Finding]:
    if ctx.scope != "sim":
        return
    aliases = _aliases(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        hit = None
        if isinstance(func, ast.Name):
            hit = aliases.get(func.id)
            if hit is not None and hit.startswith("module:"):
                hit = None
        elif isinstance(func, ast.Attribute) and isinstance(func.value,
                                                            ast.Name):
            base = aliases.get(func.value.id)
            if base == "module:time" and func.attr in _TIME_FNS:
                hit = f"time.{func.attr}"
            elif base == "module:datetime" and func.attr in _DATETIME_FNS:
                hit = f"datetime.{func.attr}"
        elif (isinstance(func, ast.Attribute)
              and isinstance(func.value, ast.Attribute)
              and isinstance(func.value.value, ast.Name)):
            # the two-level spelling: datetime.datetime.now()
            base = aliases.get(func.value.value.id)
            if (base == "module:datetime" and func.value.attr == "datetime"
                    and func.attr in _DATETIME_FNS):
                hit = f"datetime.{func.attr}"
        if hit:
            yield Finding(
                ctx.path, node.lineno, node.col_offset, RULE,
                f"{hit}() reads the wall clock inside simulator code; "
                "derive instants from the virtual clock, or mark a "
                "sanctioned measurement site with "
                "`# simlint: allow(wall-clock)`")
