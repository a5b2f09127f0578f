"""Carbon-intensity signals: virtual time -> grid gCO2e per kWh.

Lewis et al.'s synthesis of green architectural tactics names *carbon-aware
scheduling* — doing the same joules when (or where) the grid is cleaner — as
a first-class tactic that pure energy metering cannot express: a joule at
solar noon and a joule during the evening peak are the same J but very
different grams.  A :class:`CarbonSignal` is the missing axis: a
deterministic map from the serving stack's virtual clock to grid carbon
intensity, so every metered joule can also be billed in grams *at the time
it was drawn* (see :class:`repro_torch.energy.meter.EnergyMeter`).

Three concrete signals cover the reproduction's needs:

  * :class:`ConstantSignal` — one flat intensity; the default is the IEA
    2023 global grid average, which is THE single source of truth for the
    static constant (``repro_torch.energy.hw.CARBON_G_PER_KWH`` re-exports it);
  * :class:`DiurnalSignal` — a synthetic day/night sinusoid (solar valley,
    evening peak) with configurable period/phase, so benchmarks can compress
    a "day" into seconds of virtual time;
  * :class:`TraceSignal` — piecewise-linear interpolation of recorded
    ``(t_s, g_per_kwh)`` points (CSV/JSON), cyclic beyond the last point,
    for replaying real grid traces.

All signals are frozen dataclasses: deterministic, hashable, serializable
(the spec layer's :class:`CarbonSpec` is their declarative form).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Sequence, Tuple

# Global-average grid carbon intensity (IEA 2023), g CO2e per kWh.  This is
# the one home of the constant: ``repro_torch.energy.hw`` re-exports it for legacy
# importers, ``ConstantSignal`` defaults to it.
CARBON_G_PER_KWH = 475.0

J_PER_KWH = 3.6e6


class CarbonSignal:
    """Deterministic map: virtual time (s) -> grid intensity (gCO2e/kWh)."""

    kind = "abstract"

    def intensity(self, t_s: float) -> float:
        raise NotImplementedError

    def grams(self, energy_j: float, t0_s: float = 0.0,
              t1_s: Optional[float] = None) -> float:
        """Bill ``energy_j`` drawn over ``[t0_s, t1_s]`` in grams.

        Uses the interval's midpoint intensity (exact for constant signals,
        a first-order quadrature elsewhere); with ``t1_s`` omitted the
        energy is billed at the instant ``t0_s``.
        """
        if t1_s is None or t1_s <= t0_s:
            return energy_j / J_PER_KWH * self.intensity(t0_s)
        mid = 0.5 * (t0_s + t1_s)
        return energy_j / J_PER_KWH * self.intensity(mid)

    def lowest_window_t(self, t0_s: float, t1_s: float, step_s: float,
                        tolerance: float = 0.0) -> float:
        """Earliest time in ``[t0_s, t1_s]`` with (near-)minimum sampled
        intensity — the planning primitive for temporal shifting (defer
        work into the valley instead of serving it on the peak).

        ``tolerance`` is a relative band above the window minimum: the
        earliest sample within ``min * (1 + tolerance)`` wins.  A long flat
        valley is then entered at its *start*, and a marginally-deeper
        minimum at the far edge of the window (where deadline slack — and
        queueing room — has run out) never outweighs the earlier,
        nearly-as-clean instant.  ``tolerance=0`` is the strict minimum.
        """
        if t1_s <= t0_s or step_s <= 0:
            return t0_s
        samples = [(t0_s, self.intensity(t0_s))]
        n = int(math.floor((t1_s - t0_s) / step_s))
        for k in range(1, n + 1):
            t = min(t0_s + k * step_s, t1_s)
            samples.append((t, self.intensity(t)))
        best_i = min(i for _, i in samples)
        cut = best_i * (1.0 + max(tolerance, 0.0)) + 1e-12
        for t, i in samples:
            if i <= cut:
                return t
        return samples[0][0]


@dataclasses.dataclass(frozen=True)
class ConstantSignal(CarbonSignal):
    """A flat grid: intensity does not depend on time (the carbon-blind world)."""

    g_per_kwh: float = CARBON_G_PER_KWH
    kind = "constant"

    def intensity(self, t_s: float) -> float:
        return self.g_per_kwh


@dataclasses.dataclass(frozen=True)
class DiurnalSignal(CarbonSignal):
    """Synthetic day/night sinusoid.

    ``intensity(t) = base + amplitude * sin(2*pi*(t - phase_s)/period_s)``,
    clamped at ``floor_g_per_kwh`` — t=0 with phase 0 sits at the base, the
    first quarter-period is the rising (dirty) flank and the third quarter
    is the valley.  ``period_s`` defaults to a real day but benchmarks
    compress it so a seconds-long virtual run spans several "days".
    """

    base_g_per_kwh: float = CARBON_G_PER_KWH
    amplitude_g_per_kwh: float = 200.0
    period_s: float = 86_400.0
    phase_s: float = 0.0
    floor_g_per_kwh: float = 0.0
    kind = "diurnal"

    def intensity(self, t_s: float) -> float:
        w = 2.0 * math.pi * (t_s - self.phase_s) / self.period_s
        return max(self.floor_g_per_kwh,
                   self.base_g_per_kwh
                   + self.amplitude_g_per_kwh * math.sin(w))


@dataclasses.dataclass(frozen=True)
class TraceSignal(CarbonSignal):
    """Piecewise-linear replay of recorded ``(t_s, g_per_kwh)`` points.

    Interpolates linearly between points and repeats cyclically past the
    last point (a day-long trace tiles an arbitrarily long run).  Points
    must be strictly increasing in time and start at t >= 0.
    """

    points: Tuple[Tuple[float, float], ...]
    kind = "trace"

    def __post_init__(self):
        object.__setattr__(self, "points",
                           tuple((float(t), float(g)) for t, g in self.points))
        if not self.points:
            raise ValueError("TraceSignal needs at least one (t, g) point")
        ts = [t for t, _ in self.points]
        if any(b <= a for a, b in zip(ts, ts[1:])):
            raise ValueError(f"trace times must be strictly increasing: {ts}")
        if ts[0] < 0:
            raise ValueError(f"trace times must be >= 0, got {ts[0]}")

    def intensity(self, t_s: float) -> float:
        pts = self.points
        if len(pts) == 1:
            return pts[0][1]
        t0 = pts[0][0]
        span = pts[-1][0] - t0
        # cyclic: fold t into [t0, t0 + span]
        t = t0 + ((t_s - t0) % span) if t_s > pts[-1][0] else max(t_s, t0)
        for (ta, ga), (tb, gb) in zip(pts, pts[1:]):
            if t <= tb:
                f = (t - ta) / (tb - ta)
                return ga + f * (gb - ga)
        return pts[-1][1]

    @classmethod
    def from_csv(cls, text: str) -> "TraceSignal":
        """Parse ``t_s,g_per_kwh`` lines (header and blank lines skipped)."""
        pts = []
        for line in text.strip().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            a, b = line.split(",")[:2]
            try:
                pts.append((float(a), float(b)))
            except ValueError:
                continue                     # header row
        return cls(points=tuple(pts))

    @classmethod
    def from_json(cls, text: str) -> "TraceSignal":
        """Parse ``[[t_s, g_per_kwh], ...]`` JSON."""
        return cls(points=tuple((t, g) for t, g in json.loads(text)))


# -- the declarative form ------------------------------------------------------


_KINDS = ("constant", "diurnal", "trace")


@dataclasses.dataclass(frozen=True)
class CarbonSpec:
    """A :class:`CarbonSignal` as pure data (JSON-round-trippable, sweepable).

    ``kind`` selects the signal; the other fields parameterize it.  The
    default is the constant IEA world, so a spec that never mentions carbon
    behaves exactly like the pre-carbon stack.
    """

    kind: str = "constant"
    g_per_kwh: float = CARBON_G_PER_KWH      # constant / diurnal base
    amplitude_g_per_kwh: float = 200.0       # diurnal
    period_s: float = 86_400.0               # diurnal
    phase_s: float = 0.0                     # diurnal
    trace: Tuple[Tuple[float, float], ...] = ()   # trace points

    def __post_init__(self):
        object.__setattr__(
            self, "trace",
            tuple((float(t), float(g)) for t, g in self.trace))

    def problems(self) -> Sequence[Tuple[str, str]]:
        """(relative_field, message) constraint violations — the spec layer
        prefixes its own field path and raises its own error type."""
        out = []
        if self.kind not in _KINDS:
            out.append(("kind",
                        f"unknown carbon signal {self.kind!r}; "
                        f"known: {sorted(_KINDS)}"))
        if self.g_per_kwh < 0:
            out.append(("g_per_kwh", f"must be >= 0, got {self.g_per_kwh}"))
        if self.kind == "diurnal":
            if self.amplitude_g_per_kwh < 0:
                out.append(("amplitude_g_per_kwh",
                            f"must be >= 0, got {self.amplitude_g_per_kwh}"))
            if self.period_s <= 0:
                out.append(("period_s", f"must be > 0, got {self.period_s}"))
        if self.kind == "trace":
            if not self.trace:
                out.append(("trace", "trace signal needs >= 1 (t, g) point"))
            else:
                ts = [t for t, _ in self.trace]
                if ts[0] < 0 or any(b <= a for a, b in zip(ts, ts[1:])):
                    out.append(("trace",
                                "trace times must be >= 0 and strictly "
                                f"increasing, got {ts}"))
                if any(g < 0 for _, g in self.trace):
                    out.append(("trace", "trace intensities must be >= 0"))
        return out

    def build(self) -> CarbonSignal:
        probs = self.problems()
        if probs:
            raise ValueError(f"{probs[0][0]}: {probs[0][1]}")
        if self.kind == "constant":
            return ConstantSignal(g_per_kwh=self.g_per_kwh)
        if self.kind == "diurnal":
            return DiurnalSignal(base_g_per_kwh=self.g_per_kwh,
                                 amplitude_g_per_kwh=self.amplitude_g_per_kwh,
                                 period_s=self.period_s,
                                 phase_s=self.phase_s)
        return TraceSignal(points=self.trace)
