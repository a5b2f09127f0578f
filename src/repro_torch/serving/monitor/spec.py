"""Declarative monitor config: the green-SRE layer as one sweepable field.

In the JAX package ``MonitorSpec`` rides on ``ServingSpec`` like every
other design decision (the spec API is not ported yet).  The monitor
consumes the telemetry stream, so ``monitor.enabled`` requires
``telemetry.enabled``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from repro_torch.serving.monitor.burnrate import BudgetSpec


@dataclasses.dataclass(frozen=True)
class MonitorSpec:
    """Switchboard for the streaming green-SRE monitor.

    ``window_s`` is the signal aggregation cadence: golden + green signals
    are sealed per window at fleet boundaries and fed to the burn-rate
    engine.  ``budgets`` declares what the operator promised
    (:class:`~repro_torch.serving.monitor.burnrate.BudgetSpec`); alert episodes
    closer than ``incident_gap_s`` merge into one incident.
    """

    enabled: bool = False
    window_s: float = 0.25
    budgets: Tuple[BudgetSpec, ...] = ()
    incident_gap_s: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "budgets", tuple(self.budgets))

    def problems(self) -> Sequence[Tuple[str, str]]:
        out = []
        if self.window_s <= 0:
            out.append(("window_s", f"must be > 0, got {self.window_s}"))
        if self.incident_gap_s < 0:
            out.append(("incident_gap_s",
                        f"must be >= 0, got {self.incident_gap_s}"))
        seen = set()
        for i, b in enumerate(self.budgets):
            out.extend((f"budgets[{i}].{f}", msg)
                       for f, msg in b.problems())
            if b.name in seen:
                out.append((f"budgets[{i}].name",
                            f"duplicate budget name {b.name!r}"))
            seen.add(b.name)
            if 0 < b.fast_window_s < self.window_s:
                out.append((f"budgets[{i}].fast_window_s",
                            f"fast window ({b.fast_window_s}) cannot be "
                            f"finer than the monitor window "
                            f"({self.window_s})"))
        return out
