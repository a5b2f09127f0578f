"""R4 ``clock-causality``: the virtual clock only moves through the event API.

``SchedulerCore`` owns the virtual timeline: ``advance_to`` bills idle gaps,
``advance_active`` bills compute, ``provision`` bootstraps a cold-started
replica.  A bare ``core.clock = t`` anywhere else can skip billing entirely
(time passes, nobody pays for it) or move time backwards — both corrupt the
energy ledger silently.

The same causality applies to billing instants: every ``record_active`` /
``record_idle`` / ``record_preempt`` / ``record_xfer`` call outside the meter
module itself must carry ``t_s=`` derived from the virtual clock, because
grams are priced at the instant the energy is drawn — an unstamped event is
billed at t=0 on the carbon signal, which misprices it on any time-varying
grid.  (``record_active_shared`` carries its instant positionally as
``start_s`` and is exempt.)
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding

RULE = "clock-causality"

# SchedulerCore's own event loop IS the sanctioned writer
_CLOCK_WRITER = "repro_torch/serving/core.py"
# the meter's internal/legacy paths own their defaults; the sanitizer's
# super().record_*(dur_s, t_s) overrides forward the caller's stamp
_METER = ("repro_torch/energy/meter.py", "repro_torch/energy/sanitize.py")

_STAMPED = {"record_active", "record_idle", "record_preempt", "record_xfer"}


def check(ctx: FileContext) -> Iterator[Finding]:
    allow_clock_writes = ctx.is_file(_CLOCK_WRITER)
    allow_unstamped = any(ctx.is_file(m) for m in _METER)
    for node in ast.walk(ctx.tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and t.attr == "clock" \
                    and not allow_clock_writes:
                yield Finding(
                    ctx.path, t.lineno, t.col_offset, RULE,
                    "virtual clock written outside SchedulerCore's event "
                    "API; advance time through advance_to()/provision() so "
                    "the skipped interval is billed")
        if isinstance(node, ast.Call) and not allow_unstamped:
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in _STAMPED:
                if not any(kw.arg == "t_s" for kw in node.keywords):
                    yield Finding(
                        ctx.path, node.lineno, node.col_offset, RULE,
                        f"{func.attr}() without t_s=: grams are priced at "
                        "the drawing instant, so every billing event must "
                        "carry its virtual time")
