"""Regions: carbon zones promoted to first-class *places* that can fail.

Durán et al. pair the deployment-topology decisions with the quality axes
the rest of this repo already measures; a carbon zone alone is a label —
a replica's zone picks its gram signal and nothing else.  A
:class:`RegionSpec` makes the zone a place on the network: it carries the
region's own carbon signal (offset diurnal phases give the follow-the-sun
router something to chase) plus the egress link the region reaches the rest
of the fleet through (one-way latency, bandwidth, draw while a payload is in
flight).

Cross-region serving is billed honestly on the virtual timeline: a request
whose ``origin`` region differs from the serving replica's region pays
request-leg transit before it can start and response-leg transit before the
client sees tokens, both billed through the meter's existing ``xfer`` bucket
at the link power (the same contract as disaggregation's KV handoffs).

:class:`RegionSpec` is the declarative form (its JSON lives with the spec
API, ``repro_torch.serving.api``); :class:`RegionTopology` is what the fleet executes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

from repro_torch.carbon.signal import CarbonSignal, CarbonSpec


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """One serving region as pure data (JSON-round-trippable, sweepable).

    ``carbon`` is the region's grid signal — regions at different longitudes
    model their sun by offsetting a diurnal signal's ``phase_s``.  The link
    fields describe the region's egress: a cross-region payload pays both
    endpoints' one-way latencies and streams at the slower side's bandwidth,
    billed at the *sending* region's link power.
    """

    carbon: CarbonSpec = CarbonSpec()
    latency_ms: float = 30.0          # one-way egress latency to the backbone
    gbps: float = 10.0                # egress bandwidth
    link_power_w: float = 10.0        # draw while a payload is in flight

    def problems(self) -> Sequence[Tuple[str, str]]:
        """(relative_field, message) violations — the spec layer prefixes
        its own field path (same contract as ``CarbonSpec.problems``)."""
        out = []
        if self.latency_ms < 0:
            out.append(("latency_ms",
                        f"must be >= 0, got {self.latency_ms}"))
        if self.gbps <= 0:
            out.append(("gbps", f"must be > 0, got {self.gbps}"))
        if self.link_power_w < 0:
            out.append(("link_power_w",
                        f"must be >= 0, got {self.link_power_w}"))
        out.extend((f"carbon.{f}", msg) for f, msg in self.carbon.problems())
        return out


@dataclasses.dataclass
class RegionTopology:
    """What the fleet executes: per-region signals plus the transit model."""

    signals: Dict[str, CarbonSignal]
    latency_s: Dict[str, float]
    bytes_per_s: Dict[str, float]
    power_w: Dict[str, float]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.signals))

    def transit_s(self, src: str, dst: str, payload_bytes: int) -> float:
        """One-way transit time for ``payload_bytes`` between two regions.

        Zero within a region, and zero when either side is region-less
        (``""`` — every workload without regions), so such traffic never pays.
        """
        if src == dst or not src or not dst:
            return 0.0
        if src not in self.latency_s or dst not in self.latency_s:
            return 0.0
        bw = min(self.bytes_per_s[src], self.bytes_per_s[dst])
        return (self.latency_s[src] + self.latency_s[dst]
                + max(payload_bytes, 0) / max(bw, 1e-9))

    def link_power_w(self, src: str) -> float:
        """Draw billed for a transit, at the sending region's link."""
        return self.power_w.get(src, 0.0)

    @classmethod
    def from_specs(cls, regions: Mapping[str, "RegionSpec"]
                   ) -> "RegionTopology":
        for name, r in regions.items():
            probs = r.problems()
            if probs:
                raise ValueError(f"regions[{name}].{probs[0][0]}: "
                                 f"{probs[0][1]}")
        return cls(
            signals={n: r.carbon.build() for n, r in regions.items()},
            latency_s={n: r.latency_ms / 1e3 for n, r in regions.items()},
            bytes_per_s={n: r.gbps * 1e9 / 8.0 for n, r in regions.items()},
            power_w={n: r.link_power_w for n, r in regions.items()},
        )
