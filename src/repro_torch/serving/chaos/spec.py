"""Chaos: a deterministic, seeded failure script on the virtual clock.

The Green-Tactics synthesis (Järvenpää et al.) catalogs the resilience
tactics — retry/failover, graceful degradation, brownout — that an
availability-blind simulator cannot price.  A :class:`ChaosSpec` injects the
failures those tactics answer, as *pure data*: a script of
:class:`ChaosEvent` s (replica crash mid-batch, whole-region outage,
brownout power caps), each carrying its virtual instant ``t_s``.  The fleet
applies events between scheduling windows; chaos code never writes
``core.clock`` (the clock-causality contract, ``docs/INVARIANTS.md`` R4) —
it drains the victim's core *to* the event instant and reclassifies through
the meter API, so every joule the failure wastes lands in the ``lost``
bucket instead of vanishing.

:class:`RetrySpec` declares the recovery tactics the same way: bounded
retry-with-backoff, cross-region failover, and graceful degradation that
sheds batch-class work first via the admission ladder.  Both are plain
data, so runs under identical failures can compare availability x energy x
latency per tactic.

Determinism: an unnamed crash target is chosen by a ``numpy`` RandomState
seeded from ``ChaosSpec.seed`` over the *sorted* candidate names, so the
same spec and seed replay the same failures bit-identically.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

_KINDS = ("crash", "outage", "brownout")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scripted failure at virtual instant ``t_s``.

    ``kind`` selects the failure; ``target`` names its victim — a replica
    (``"llm/r0"``, or ``""`` for a seeded pick among the replicas serving at
    ``t_s``) for a crash, a region for an outage, a region (``""`` = every
    region) for a brownout.  ``duration_s`` bounds outage/brownout windows;
    ``power_cap_frac`` clamps the package power during a brownout (steps
    stretch by its inverse, energy per step is conserved to first order).
    """

    kind: str = "crash"
    t_s: float = 0.0
    target: str = ""
    duration_s: float = 0.0
    power_cap_frac: float = 1.0

    def problems(self) -> Sequence[Tuple[str, str]]:
        out = []
        if self.kind not in _KINDS:
            out.append(("kind", f"unknown chaos kind {self.kind!r}; "
                                f"known: {sorted(_KINDS)}"))
        if self.t_s < 0:
            out.append(("t_s", f"must be >= 0, got {self.t_s}"))
        if self.kind in ("outage", "brownout") and self.duration_s <= 0:
            out.append(("duration_s",
                        f"{self.kind} needs duration_s > 0, "
                        f"got {self.duration_s}"))
        if self.kind == "outage" and not self.target:
            out.append(("target", "outage needs a region name"))
        if not 0.0 < self.power_cap_frac <= 1.0:
            out.append(("power_cap_frac",
                        f"must be in (0, 1], got {self.power_cap_frac}"))
        if self.kind == "brownout" and self.power_cap_frac >= 1.0:
            out.append(("power_cap_frac",
                        "a brownout must actually cap power "
                        f"(< 1.0), got {self.power_cap_frac}"))
        return out


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """The failure script as pure data (JSON-round-trippable, sweepable).

    The default — no events — is the healthy world: the fleet byte-for-byte
    reproduces its pre-chaos timeline.  ``seed`` drives the pick of unnamed
    crash targets (and nothing else), so one seed is one reproducible
    failure history.
    """

    events: Tuple[ChaosEvent, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def problems(self) -> Sequence[Tuple[str, str]]:
        out = []
        for i, ev in enumerate(self.events):
            out.extend((f"events[{i}].{f}", msg)
                       for f, msg in ev.problems())
        return out


@dataclasses.dataclass(frozen=True)
class RetrySpec:
    """The recovery tactics as pure data (JSON-round-trippable, sweepable).

    ``max_retries`` bounds the attempts a crashed/shed request gets beyond
    its first (exhausted work is a recorded drop); each retry re-enters the
    fleet ``backoff_s * backoff_mult**k`` after the failure.  ``failover``
    lets retries and routing leave the request's origin region (the
    cross-region tactic; off = naive same-region retry).  ``degrade`` sheds
    batch-class arrivals at the front door while any chaos window is active
    — the graceful-degradation tactic riding the priority ladder.
    """

    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    failover: bool = True
    degrade: bool = True

    def problems(self) -> Sequence[Tuple[str, str]]:
        out = []
        if self.max_retries < 0:
            out.append(("max_retries",
                        f"must be >= 0, got {self.max_retries}"))
        if self.backoff_s < 0:
            out.append(("backoff_s", f"must be >= 0, got {self.backoff_s}"))
        if self.backoff_mult < 1.0:
            out.append(("backoff_mult",
                        f"must be >= 1, got {self.backoff_mult}"))
        return out


@dataclasses.dataclass
class RetryRuntime:
    """What the fleet executes for the recovery tactics."""

    max_retries: int
    backoff_s: float
    backoff_mult: float
    failover: bool
    degrade: bool

    def backoff(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (1-based) re-enters."""
        return self.backoff_s * self.backoff_mult ** max(attempt - 1, 0)

    def allows(self, retries: int) -> bool:
        """May a request that already retried ``retries`` times try again?"""
        return retries < self.max_retries

    @classmethod
    def from_spec(cls, spec: RetrySpec) -> "RetryRuntime":
        probs = spec.problems()
        if probs:
            raise ValueError(f"{probs[0][0]}: {probs[0][1]}")
        return cls(max_retries=spec.max_retries, backoff_s=spec.backoff_s,
                   backoff_mult=spec.backoff_mult, failover=spec.failover,
                   degrade=spec.degrade)


@dataclasses.dataclass
class ChaosRuntime:
    """What the fleet executes: the sorted script plus window predicates.

    Outage and brownout windows are known from the spec alone, so the
    predicates (``region_down``, ``caps_for``, ``degraded``) are pure
    functions of virtual time — only crash/outage *application* (stopping
    replicas, reclassifying lost work, minting retries) runs in the fleet's
    event loop, via :meth:`pop_due`.
    """

    events: List[ChaosEvent]
    _rng: np.random.RandomState
    _cursor: int = 0

    @classmethod
    def from_spec(cls, spec: ChaosSpec) -> "ChaosRuntime":
        probs = spec.problems()
        if probs:
            raise ValueError(f"{probs[0][0]}: {probs[0][1]}")
        events = sorted(spec.events,
                        key=lambda e: (e.t_s, e.kind, e.target))
        return cls(events=events, _rng=np.random.RandomState(spec.seed))

    # -- event-loop face ------------------------------------------------------
    def next_due_t(self) -> float:
        """Virtual instant of the next unapplied event (inf when done)."""
        if self._cursor < len(self.events):
            return self.events[self._cursor].t_s
        return float("inf")

    def pop_due(self, t_end: float) -> List[ChaosEvent]:
        """Unapplied events with ``t_s < t_end``, in script order."""
        out = []
        while (self._cursor < len(self.events)
               and self.events[self._cursor].t_s < t_end):
            out.append(self.events[self._cursor])
            self._cursor += 1
        return out

    def pick_crash_target(self, candidates: Sequence[str]) -> str:
        """Seeded pick among *sorted* candidate replica names."""
        ordered = sorted(candidates)
        if not ordered:
            return ""
        return ordered[int(self._rng.randint(len(ordered)))]

    # -- window predicates ----------------------------------------------------
    def region_down(self, region: str, t: float) -> bool:
        """Is ``region`` inside one of its outage windows at ``t``?"""
        for ev in self.events:
            if ev.kind == "outage" and ev.target == region \
                    and ev.t_s <= t < ev.t_s + ev.duration_s:
                return True
        return False

    def caps_for(self, region: str) -> List[Tuple[float, float, float]]:
        """Brownout windows that clamp ``region``: (t0, t1, cap_frac)."""
        return [(ev.t_s, ev.t_s + ev.duration_s, ev.power_cap_frac)
                for ev in self.events
                if ev.kind == "brownout"
                and (ev.target == "" or ev.target == region)]

    def degraded(self, t: float) -> bool:
        """Is any outage/brownout window active at ``t``?  (The graceful-
        degradation predicate: shed batch-class work while True.)"""
        return any(ev.t_s <= t < ev.t_s + ev.duration_s
                   for ev in self.events
                   if ev.kind in ("outage", "brownout"))
