"""Traffic calendars: expected arrival rate as a function of virtual time.

The windowed autoscaler is purely reactive — it sees a ramp only
after a window full of queueing has already happened, then pays a cold
start *during* the crowd.  A :class:`TrafficCalendar` is the predictive
complement: a piecewise-constant ``t -> expected requests/s`` profile
(yesterday's logs, a release schedule, a cron calendar) that the fleet's
autoscaler consults *ahead* of its cold-start horizon, pre-warming replicas
so they are ready when the predicted ramp arrives instead of after it.

``repro_torch.serving.api.AutoscaleSpec.calendar`` is the declarative form
(a tuple of ``(t_s, rate_per_s)`` breakpoints);
:meth:`TrafficCalendar.from_requests` builds one empirically from any
recorded workload.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterable, Sequence, Tuple

if TYPE_CHECKING:  # typing only: the calendar itself is pure data
    from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class TrafficCalendar:
    """Piecewise-constant expected rate: ``points[i] = (t_s, rate_per_s)``
    holds from ``t_s`` until the next breakpoint (0 req/s before the first
    breakpoint, the last rate forever after)."""

    points: Tuple[Tuple[float, float], ...]

    def __post_init__(self):
        object.__setattr__(
            self, "points",
            tuple((float(t), float(r)) for t, r in self.points))
        ts = [t for t, _ in self.points]
        if any(b <= a for a, b in zip(ts, ts[1:])):
            raise ValueError(
                f"calendar times must be strictly increasing: {ts}")

    def rate_at(self, t_s: float) -> float:
        rate = 0.0
        for t, r in self.points:
            if t > t_s:
                break
            rate = r
        return rate

    def peak_rate(self, t0_s: float, t1_s: float) -> float:
        """Highest expected rate anywhere in ``[t0_s, t1_s]`` — what a
        pre-warming autoscaler sizes for across its cold-start horizon."""
        peak = self.rate_at(t0_s)
        for t, r in self.points:
            if t0_s < t <= t1_s:
                peak = max(peak, r)
        return peak

    @classmethod
    def from_requests(cls, requests: Iterable[Request],
                      window_s: float = 1.0) -> "TrafficCalendar":
        """Empirical calendar: arrivals histogrammed into ``window_s`` bins
        (the "yesterday's traffic predicts today's" forecast)."""
        arrivals = sorted(r.arrival_s for r in requests)
        if not arrivals:
            return cls(points=())
        counts: dict = {}
        for t in arrivals:
            counts[int(t // window_s)] = counts.get(int(t // window_s), 0) + 1
        points = tuple((k * window_s, c / window_s)
                       for k, c in sorted(counts.items()))
        return cls(points=points)


def calendar_points(requests: Sequence[Request],
                    window_s: float = 1.0) -> Tuple[Tuple[float, float], ...]:
    """The ``AutoscaleSpec.calendar`` tuple for a recorded workload."""
    return TrafficCalendar.from_requests(requests, window_s).points
