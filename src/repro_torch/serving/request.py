"""Serving request/response types.

``ServingMetrics``, which needs the energy meter, comes with the simulator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


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
