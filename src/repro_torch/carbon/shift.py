"""Temporal demand shifting: hold deferrable work for low-carbon windows.

Demand *shifting* (move work in time) is the green tactic the spatial fleet
cannot express on its own: its routers trade **where** a request runs, never
**when**.  The :class:`TemporalShifter` adds the missing axis for a new
batch-class of requests that carry a completion *deadline* instead of a
TTFT budget (:attr:`repro_torch.serving.request.Request.deadline_s`):

  * at arrival, a deferrable request is **planned**: the shifter samples the
    carbon signal over ``[arrival, latest_release]`` and picks the earliest
    minimum-intensity instant (``latest_release`` backs off the deadline by
    a safety margin covering the measured service time, so deadline pressure
    always wins over carbon greed);
  * the fleet's window loop **releases** due requests at window boundaries
    and routes them like fresh arrivals (their ``arrival_s`` is re-stamped
    to the release instant, and the hold is recorded in
    :attr:`TemporalShifter.events` so nothing is hidden);
  * requests whose deadline leaves no slack are released immediately — the
    shifter never *adds* deadline misses, it only moves slack into valleys.

Everything is deterministic: signals are pure functions of virtual time, so
the plan is decided at arrival and the whole run replays bit-identically.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

from repro_torch.carbon.signal import CarbonSignal

if TYPE_CHECKING:  # typing only: keeps repro_torch.carbon importable standalone
    from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class DeferralSpec:
    """Declarative config for the deferral queue (JSON-round-trippable).

    ``enabled=False`` (the default) serves every request the instant it
    arrives — the pre-carbon behavior.  ``window_s`` is both the planning
    sample step and the release cadence when the fleet has no autoscaler
    window of its own; ``margin_s + service_margin * measured_service_time``
    is backed off the deadline to absorb queueing at the release instant.

    ``valley_tolerance`` keeps planning herd-safe on recorded traces: the
    plan takes the *earliest* instant within that relative band of the
    window minimum, so a long flat valley is entered at its start instead
    of every deferrable request stampeding a marginally-deeper minimum at
    the far edge of its slack (where a queueing herd breaks deadlines).
    """

    enabled: bool = False
    window_s: float = 0.25
    margin_s: float = 0.5
    service_margin: float = 4.0
    valley_tolerance: float = 0.10

    def problems(self) -> Sequence[Tuple[str, str]]:
        out = []
        if self.window_s <= 0:
            out.append(("window_s", f"must be > 0, got {self.window_s}"))
        if self.margin_s < 0:
            out.append(("margin_s", f"must be >= 0, got {self.margin_s}"))
        if self.service_margin < 0:
            out.append(("service_margin",
                        f"must be >= 0, got {self.service_margin}"))
        if self.valley_tolerance < 0:
            out.append(("valley_tolerance",
                        f"must be >= 0, got {self.valley_tolerance}"))
        return out


class TemporalShifter:
    """The deferral queue: plan at arrival, release at window boundaries."""

    def __init__(self, signal: CarbonSignal, spec: DeferralSpec):
        self.signal = signal
        self.spec = spec
        # (planned_release_s, rid, endpoint, request) — rid breaks ties so
        # heap order (and therefore the run) is deterministic
        self._heap: List[Tuple[float, int, str, Request]] = []
        self.events: List[dict] = []

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def pending(self) -> bool:
        return bool(self._heap)

    def next_release_s(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def plan_release_s(self, req: Request, service_time_s: float) -> float:
        """Earliest minimum-intensity instant in the request's slack window."""
        assert req.deadline_s is not None
        margin = self.spec.margin_s + self.spec.service_margin * max(
            service_time_s, 0.0)
        latest = max(req.arrival_s, req.deadline_s - margin)
        return self.signal.lowest_window_t(req.arrival_s, latest,
                                           self.spec.window_s,
                                           tolerance=self.spec
                                           .valley_tolerance)

    def defer(self, endpoint: str, req: Request,
              service_time_s: float) -> float:
        """Queue ``req`` for its planned release; returns the plan time."""
        t = self.plan_release_s(req, service_time_s)
        heapq.heappush(self._heap, (t, req.rid, endpoint, req))
        return t

    def release_due(self, now: float) -> List[Tuple[str, Request]]:
        """Pop every request whose planned release lies before ``now``,
        re-stamped to arrive at its release instant (the hold is logged)."""
        out = []
        while self._heap and self._heap[0][0] < now:
            planned, _, endpoint, req = heapq.heappop(self._heap)
            release = max(planned, req.arrival_s)
            self.events.append({
                "rid": req.rid,
                "endpoint": endpoint,
                "arrival_s": req.arrival_s,
                "release_s": release,
                "held_s": release - req.arrival_s,
                "deadline_s": req.deadline_s,
                "intensity_at_arrival": self.signal.intensity(req.arrival_s),
                "intensity_at_release": self.signal.intensity(release),
            })
            out.append(
                (endpoint, dataclasses.replace(req, arrival_s=release)))
        return out

    def summary(self, endpoint: Optional[str] = None) -> dict:
        """Hold statistics over the released events (one endpoint's, or
        all); the single source of truth the fleet stats expose."""
        events = [e for e in self.events
                  if endpoint is None or e["endpoint"] == endpoint]
        held = [e["held_s"] for e in events]
        moved = [e["intensity_at_arrival"] - e["intensity_at_release"]
                 for e in events]
        return {
            "deferred": len(events) + len(self._heap),
            "released": len(events),
            "mean_held_s": (sum(held) / len(held)) if held else 0.0,
            "max_held_s": max(held, default=0.0),
            "mean_intensity_drop_g_per_kwh":
                (sum(moved) / len(moved)) if moved else 0.0,
        }
