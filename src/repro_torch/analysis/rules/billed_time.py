"""R1 ``billed-time``: no inline wall x power arithmetic outside the meter.

PR 1 centralized all serving-side joule accounting in
:class:`repro_torch.energy.meter.EnergyMeter` precisely because every scheduler
used to compute ``wall * power`` inline — and each copy drifted.  This rule
keeps it that way: any multiplication combining a power-like name (``power``,
``*_w``, ``active_power``, ...) with a duration-like name (``*_s``, ``wall``,
``elapsed``, ...) outside ``energy/meter.py`` is a billing bypass.

The analytic roofline estimator's ``t_compute``/``t_step`` terms are derived
from FLOP counts, not measured wall time, and deliberately do not match the
duration predicate — R1 polices *billing* of simulated/measured time, not
closed-form performance models.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding

RULE = "billed-time"

# the meter owns billing; the sanitizer re-derives the same arithmetic to
# AUDIT it, which is the opposite of a bypass
_EXEMPT = ("repro_torch/energy/meter.py", "repro_torch/energy/sanitize.py")

_DUR_EXACT = {"wall", "dur", "dt", "elapsed", "seconds", "secs"}
_DUR_SUBSTR = ("wall", "elapsed", "duration")


def _power_like(name: str) -> bool:
    # bare "w" is too generic (angular frequency, weights); the suffix and
    # substring forms are how every power variable in this repo is spelled
    n = name.lower()
    return "power" in n or n.endswith("_w")


def _duration_like(name: str) -> bool:
    n = name.lower()
    if _power_like(n) or n.endswith("per_s"):   # rates are not durations
        return False
    return (n.endswith("_s") or n.endswith("_ms") or n in _DUR_EXACT
            or any(s in n for s in _DUR_SUBSTR))


def _names(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def check(ctx: FileContext) -> Iterator[Finding]:
    if any(ctx.is_file(e) for e in _EXEMPT):
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult)):
            continue
        left, right = _names(node.left), _names(node.right)
        powered = any(map(_power_like, left)) or any(map(_power_like, right))
        timed = any(map(_duration_like, left)) or any(
            map(_duration_like, right))
        # the power and duration operands must sit on OPPOSITE sides of the
        # multiply; a single side mixing both is already a composite term
        same_side = (any(map(_power_like, left))
                     and any(map(_duration_like, left))) or (
                         any(map(_power_like, right))
                         and any(map(_duration_like, right)))
        if powered and timed and not same_side:
            yield Finding(
                ctx.path, node.lineno, node.col_offset, RULE,
                "inline duration x power arithmetic bypasses EnergyMeter "
                "billing; route joules through repro_torch.energy.meter")
