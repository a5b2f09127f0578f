"""Serving request/response types and metrics."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.energy.meter import EnergyMeter


# slots: a million-request workload materializes one Request per arrival
# (plus a Response per retirement); dropping the per-instance __dict__
# roughly halves the object footprint and speeds attribute access on the
# event loop's hot path
@dataclasses.dataclass(slots=True)
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32 token ids
    max_new_tokens: int = 16
    arrival_s: float = 0.0             # workload timeline (virtual clock)
    # per-request time-to-first-token budget: the SLO-aware admission policy
    # sizes batches to the tightest budget visible in its window, and the
    # fleet router prefers replicas whose queue can still honor it
    slo_ms: Optional[float] = None
    # batch-class currency: an absolute completion deadline (virtual clock).
    # A deadline-carrying request is deferrable — the fleet's temporal
    # shifter may hold it for a low-carbon window and release it with
    # enough slack to finish in time (carbon-aware shifting)
    deadline_s: Optional[float] = None
    # admission priority class ("interactive" | "standard" | "batch";
    # None = standard): under a PrioritySpec ladder, backlogged queues pop
    # urgent work first and an interactive arrival may preempt an in-flight
    # lower-priority decode batch (admission control)
    priority: Optional[str] = None
    # two-phase lifecycle state for disaggregated serving: "full" is the
    # unified world; the fleet re-stamps the decode-pool leg to "decode"
    # after the prefill pool hands the KV cache off
    phase: str = "full"
    # KV-cache payload this request's handoff moved (stamped by the fleet
    # on the decode leg; 0 for unified serving)
    kv_bytes: int = 0
    # client region (RegionSpec name): serving the request from a replica in
    # another region bills request/response transit on the inter-region link
    # and delays the effective arrival.  "" = region-less (all legacy
    # workloads), which never pays transit
    origin: str = ""
    # retry generation under a RetrySpec: 0 for the original attempt; the
    # chaos layer re-mints crashed/shed work with retries+1 until the
    # spec's max_retries is exhausted
    retries: int = 0


@dataclasses.dataclass(slots=True)
class Response:
    rid: int
    tokens: np.ndarray                 # (n,) generated ids
    arrival_s: float
    start_s: float                     # compute start (virtual clock)
    first_token_s: float               # TTFT point
    done_s: float
    deadline_s: Optional[float] = None   # copied from the request
    priority: Optional[str] = None       # copied from the request

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def queue_s(self) -> float:
        return self.start_s - self.arrival_s

    @property
    def met_deadline(self) -> Optional[bool]:
        if self.deadline_s is None:
            return None
        return self.done_s <= self.deadline_s + 1e-9


@dataclasses.dataclass
class ServingMetrics:
    responses: List[Response]
    wall_compute_s: float              # compute time on the virtual clock
    energy_j: float                    # metered energy (active + idle)
    total_tokens: int
    meter: Optional[EnergyMeter] = None  # full active/idle + per-request J
    fleet: Optional[dict] = None         # replica-fleet stats (the fleet fills it)

    @property
    def throughput_tok_s(self) -> float:
        if not self.responses:
            return 0.0
        span = max(r.done_s for r in self.responses) - min(
            r.arrival_s for r in self.responses
        )
        return self.total_tokens / max(span, 1e-9)

    @staticmethod
    def _percentile(vals: List[float], p: float) -> float:
        vals = sorted(vals)
        if not vals:
            return 0.0
        i = min(int(p / 100 * len(vals)), len(vals) - 1)
        return vals[i]

    def latency_percentile(self, p: float,
                           priority: Optional[str] = None) -> float:
        """End-to-end latency percentile, optionally restricted to one
        priority class."""
        return self._percentile([r.latency_s for r in self.responses
                                 if priority is None
                                 or r.priority == priority], p)

    def ttft_percentile(self, p: float,
                        priority: Optional[str] = None) -> float:
        """TTFT percentile, optionally restricted to one priority class —
        the admission layer's headline is the *interactive* p95 TTFT."""
        return self._percentile([r.ttft_s for r in self.responses
                                 if priority is None
                                 or r.priority == priority], p)

    def priority_classes(self) -> List[str]:
        """Priority classes present among the responses (sorted)."""
        return sorted({r.priority for r in self.responses
                       if r.priority is not None})

    @property
    def mean_latency_s(self) -> float:
        if not self.responses:
            return 0.0
        return float(np.mean([r.latency_s for r in self.responses]))

    @property
    def mean_ttft_s(self) -> float:
        if not self.responses:
            return 0.0
        return float(np.mean([r.ttft_s for r in self.responses]))

    @property
    def energy_per_request_j(self) -> float:
        return self.energy_j / max(len(self.responses), 1)

    @property
    def energy_per_token_j(self) -> float:
        return self.energy_j / max(self.total_tokens, 1)

    @property
    def gco2_total(self) -> float:
        """Grams CO2e from the meter (0.0 for meterless legacy metrics)."""
        return self.meter.total_g if self.meter is not None else 0.0

    @property
    def gco2_per_token(self) -> float:
        return self.gco2_total / max(self.total_tokens, 1)

    @property
    def deadline_compliance(self) -> Optional[float]:
        """Fraction of deadline-carrying responses that finished in time
        (None when the workload had no deadlines)."""
        met = [r.met_deadline for r in self.responses
               if r.deadline_s is not None]
        if not met:
            return None
        return sum(met) / len(met)

    def summary(self) -> dict:
        d = {
            "n_requests": len(self.responses),
            "mean_latency_s": round(self.mean_latency_s, 6),
            "p95_latency_s": round(self.latency_percentile(95), 6),
            "mean_ttft_s": round(self.mean_ttft_s, 6),
            "throughput_tok_s": round(self.throughput_tok_s, 3),
            "energy_per_request_j": round(self.energy_per_request_j, 6),
            "energy_per_token_j": round(self.energy_per_token_j, 6),
        }
        if self.meter is not None:
            d["energy_active_j"] = round(self.meter.active_j, 6)
            d["energy_idle_j"] = round(self.meter.idle_j, 6)
            d["gco2_total"] = round(self.meter.total_g, 6)
            # grams/token sits at 1e-6..1e-5: 9 decimals keeps ~4 sig figs
            d["gco2_per_token"] = round(self.gco2_per_token, 9)
        if self.deadline_compliance is not None:
            d["deadline_compliance"] = round(self.deadline_compliance, 6)
        classes = self.priority_classes()
        if classes:
            d["ttft_p95_by_class"] = {
                c: round(self.ttft_percentile(95, c), 6) for c in classes}
        if self.fleet is not None:
            d["fleet"] = {
                "replicas_created": self.fleet.get("replicas_created"),
                "peak_replicas": self.fleet.get("peak_replicas"),
                "cold_starts": self.fleet.get("cold_starts"),
                "replica_seconds": round(
                    self.fleet.get("replica_seconds", 0.0), 6),
                # replica count over (virtual) time: [(t, n_serving), ...]
                "replica_timeline": self.fleet.get("replica_timeline"),
            }
            if self.meter is not None and self.meter.by_source:
                d["fleet"]["idle_j_by_replica"] = {
                    src: round(split["idle_j"], 6)
                    for src, split in sorted(self.meter.by_source.items())
                }
        return d


def synth_workload(
    n: int, prompt_len: int, max_new: int, vocab: int, rate_per_s: float,
    seed: int = 0, rid0: int = 0, slo_ms: Optional[float] = None,
    deadline_s: Optional[float] = None,
) -> List[Request]:
    """Poisson arrivals, uniform random prompts (deterministic given seed).

    Legacy alias for :func:`repro_torch.workload.generators.poisson` (bit-
    identical output for the same seed — the arrival-generator rewrite is
    regression-tested against this contract).  ``rid0`` offsets request ids
    so several endpoint workloads can share one fleet timeline without rid
    collisions; ``slo_ms`` stamps a per-request TTFT budget, ``deadline_s``
    a relative completion deadline (batch-class, deferrable work).
    """
    from repro_torch.workload.generators import poisson  # local: avoids a cycle

    return poisson(n, prompt_len, max_new, vocab, rate_per_s=rate_per_s,
                   seed=seed, rid0=rid0, slo_ms=slo_ms,
                   deadline_s=deadline_s)
