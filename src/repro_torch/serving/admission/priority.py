"""Priority classes and the preemptive admission contract.

Serving traffic is not one class: an interactive chat turn, a standard API
call and a bulk batch job tolerate very different waiting.  The ladder here
is deliberately small and fixed — ``interactive > standard > batch`` — so a
priority is an ordinal the scheduler can compare, not an open-ended float
knob:

  * **priority-ordered admission** — under backlog, a
    :class:`~repro_torch.serving.core.SchedulerCore` with an
    :class:`AdmissionControl` pops the most urgent *arrived* request first
    (FIFO within a class); with no backlog nothing changes, so enabling the
    ladder on an uncongested fleet is a no-op;
  * **in-replica preemption** — an arriving higher-priority request may
    *pause* a lower-priority batch mid-decode: the core bills a pause
    overhead, runs the urgent dispatch, bills a resume overhead, and the
    paused batch finishes late by exactly the interruption.  Pause/resume
    seconds are billed to the meter's ``preempt`` bucket (the KV save /
    restore work), so the cost of the tactic is visible in the energy story
    and the joule/gram conservation invariants extend across pauses.

:class:`PrioritySpec` is the declarative form (JSON-round-trippable,
sweepable — ``sweep(spec, {"priority.preempt": [False, True]})``);
``build()`` produces the runtime :class:`AdmissionControl` the cores consult.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# the ladder, most urgent first; smaller level = more urgent
PRIORITY_LEVELS = {"interactive": 0, "standard": 1, "batch": 2}
DEFAULT_PRIORITY = "standard"


def priority_level(name: Optional[str]) -> int:
    """Ordinal for a class name; ``None`` means :data:`DEFAULT_PRIORITY`."""
    if name is None:
        return PRIORITY_LEVELS[DEFAULT_PRIORITY]
    try:
        return PRIORITY_LEVELS[name]
    except KeyError:
        raise ValueError(
            f"unknown priority class {name!r}; "
            f"known: {sorted(PRIORITY_LEVELS)}") from None


@dataclasses.dataclass(frozen=True)
class AdmissionControl:
    """Runtime admission contract a :class:`SchedulerCore` consults.

    ``preempt=False`` keeps the priority-ordered queue but never pauses an
    in-flight dispatch — the control arm for measuring what preemption
    itself buys (and costs, via the ``preempt`` energy bucket).
    """

    preempt: bool = True
    pause_s: float = 0.002
    resume_s: float = 0.002
    # per-dispatch cap: a decode batch is paused at most this many times, so
    # a flash crowd of interactive arrivals cannot starve a batch forever
    max_preemptions: int = 4


@dataclasses.dataclass(frozen=True)
class PrioritySpec:
    """The priority ladder as pure data (JSON-round-trippable, sweepable).

    ``enabled=False`` (the default) is the pre-admission world: FIFO
    admission, no preemption — specs that never mention priority behave
    exactly as before.  Requests name their class via
    ``Request.priority`` / ``SLOClass.priority`` / ``WorkloadSpec.priority``;
    unnamed requests are ``standard``.
    """

    enabled: bool = False
    preempt: bool = True
    pause_ms: float = 2.0
    resume_ms: float = 2.0
    max_preemptions: int = 4

    def problems(self) -> Sequence[Tuple[str, str]]:
        """(relative_field, message) violations — the spec layer prefixes
        its own field path (same contract as ``CarbonSpec.problems``)."""
        out = []
        if self.pause_ms < 0:
            out.append(("pause_ms", f"must be >= 0, got {self.pause_ms}"))
        if self.resume_ms < 0:
            out.append(("resume_ms", f"must be >= 0, got {self.resume_ms}"))
        if self.max_preemptions < 0:
            out.append(("max_preemptions",
                        f"must be >= 0, got {self.max_preemptions}"))
        return out

    def build(self) -> Optional[AdmissionControl]:
        probs = self.problems()
        if probs:
            raise ValueError(f"{probs[0][0]}: {probs[0][1]}")
        if not self.enabled:
            return None
        return AdmissionControl(preempt=self.preempt,
                                pause_s=self.pause_ms / 1e3,
                                resume_s=self.resume_ms / 1e3,
                                max_preemptions=self.max_preemptions)
