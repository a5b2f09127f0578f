"""The simlint rule catalog.

Per-file rules run over a :class:`~repro_torch.analysis.context.FileContext`;
which ones fire depends on the file's scope:

  * ``sim`` — the simulator layers ``src/repro_torch/{serving,carbon,
    workload,energy}``: the full catalog.  Wall-clock reads, hidden RNG state, hash
    order and identity keys all corrupt virtual-time determinism there.
  * ``driver`` — ``chip_smoke.py`` and ``scripts/torch_*.py``: everything except
    ``wall-clock`` (timing real hardware and real simulator runtime is the
    drivers' job) — but drivers still must not bypass the meter, draw
    unseeded randomness, or poke the virtual clock.

``spec-roundtrip`` is a project-level analysis that anchors on
``serving/api.py`` and reads its sibling spec modules itself.
"""

from __future__ import annotations

from typing import Iterator, List

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import (
    billed_time,
    clock_causality,
    collections_det,
    randomness,
    spec_complete,
    wall_clock,
)

RULE_IDS = (
    "billed-time",        # R1
    "wall-clock",         # R2
    "unseeded-random",    # R2
    "set-iteration",      # R2
    "id-key",             # R2
    "clock-causality",    # R4
    "spec-roundtrip",     # R3
)

_SIM_CHECKS = (billed_time.check, wall_clock.check, randomness.check,
               collections_det.check, clock_causality.check,
               spec_complete.check)
_DRIVER_CHECKS = (billed_time.check, randomness.check,
                  collections_det.check, clock_causality.check)


def run_rules(ctx: FileContext) -> List[Finding]:
    checks = _SIM_CHECKS if ctx.scope == "sim" else _DRIVER_CHECKS
    out: List[Finding] = []
    for check in checks:
        out.extend(check(ctx))
    return out
