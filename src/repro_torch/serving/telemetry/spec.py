"""Declarative telemetry config: one sweepable switch for the trace layer.

In the JAX package ``TelemetrySpec`` rides on ``ServingSpec`` like every
other design decision (the spec API is not ported yet).  ``enabled`` is a
legitimate grid axis: the observer-purity tests flip it and assert the
joules don't move.  Disabled is the default and costs one attribute check
per billing event.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Switchboard for the virtual-time tracing/metrics subsystem.

    ``enabled`` turns the whole recorder on; ``spans`` and ``metrics``
    select the two event families (request lifecycle spans + replica
    energy-billing spans, and sampled gauges respectively).  ``max_events``
    caps the recorded event stream so a million-request traced run cannot
    eat the host: events past the cap are *counted*, never silently
    vanished — the exporter stamps the drop count into the trace metadata
    and the report, so a truncated trace always says so.
    """

    enabled: bool = False
    spans: bool = True
    metrics: bool = True
    max_events: int = 2_000_000

    def problems(self) -> Sequence[Tuple[str, str]]:
        out = []
        if self.max_events <= 0:
            out.append(("max_events",
                        f"must be > 0, got {self.max_events}"))
        if self.enabled and not (self.spans or self.metrics):
            out.append(("spans",
                        "enabled telemetry must record spans or metrics "
                        "(both are off)"))
        return out
