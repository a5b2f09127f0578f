"""Prefill/decode disaggregation: two pools, one request lifecycle.

LLM generation is two workloads in one request: a compute-bound *prefill*
(the whole prompt in one pass — this is where the first token, and therefore
TTFT, comes from) and a memory-bound *decode* (one token per step).  Serving
them on the same replica forces one pool size and one batching rhythm onto
both; disaggregating them — a prefill pool and a decode pool, with the KV
cache handed off in between — lets each phase batch at its own cadence, which
is exactly the kind of architectural tactic the green-serving catalog wants
measurable rather than asserted.

The handoff is not free: the prefill replica must ship the request's KV cache
to the decode replica.  :func:`kv_cache_bytes` models the payload from the
architecture (2 tensors x layers x kv-heads x head-dim x bytes per element,
per token), and :class:`DisaggSpec` declares the link it crosses (bandwidth,
per-handoff latency, transfer power).  The fleet bills the transfer's seconds
and joules to the sending replica's meter under the ``xfer`` bucket — so a
run can show both the regime where disaggregation wins J/token and the
regime where the handoff eats the gain.

:class:`DisaggSpec` is the declarative form (its JSON lives with the spec
API, ``repro_torch.serving.api``); :class:`DisaggRuntime` is what the fleet executes, with the phase-batching
policy factories injected by the layer that owns the policy vocabulary
(``repro_torch.serving.scheduler``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple


def kv_cache_bytes(cfg, seq_len: int, dtype_bytes: int = 2) -> int:
    """KV-cache payload for ``seq_len`` tokens of ``cfg``: the K and V
    tensors across every layer's KV heads, at ``dtype_bytes`` per element
    (2 = the fp16/bf16 cache a serving runtime keeps)."""
    heads = getattr(cfg, "num_kv_heads", 0) or getattr(cfg, "num_heads", 1)
    head_dim = getattr(cfg, "head_dim", 0) or 64
    layers = getattr(cfg, "num_layers", 1)
    return int(2 * layers * heads * head_dim * dtype_bytes * max(seq_len, 0))


@dataclasses.dataclass(frozen=True)
class DisaggSpec:
    """Disaggregated serving as pure data (JSON-round-trippable, sweepable).

    ``enabled=False`` (the default) is the unified world: one pool runs both
    phases and no handoff exists.  Enabled, the endpoint's pool becomes
    ``prefill_replicas`` + ``decode_replicas`` fixed-size pools (the windowed
    autoscaler does not resize disaggregated pools), and every request whose
    decode is non-trivial pays one KV handoff across the declared link.

    ``kv_bytes_per_token`` overrides the architecture-derived payload — the
    lever for modeling a production-size model's KV traffic while a smoke
    engine supplies the step timings.
    """

    enabled: bool = False
    prefill_replicas: int = 1
    decode_replicas: int = 1
    link_gbps: float = 25.0           # handoff link bandwidth
    link_latency_ms: float = 0.5      # fixed per-handoff latency
    link_power_w: float = 8.0         # draw while KV is in flight
    kv_dtype_bytes: int = 2           # cache element width (fp16/bf16)
    kv_bytes_per_token: Optional[float] = None   # override f(arch)

    def problems(self) -> Sequence[Tuple[str, str]]:
        """(relative_field, message) violations — the spec layer prefixes
        its own field path (same contract as ``CarbonSpec.problems``)."""
        out = []
        if self.prefill_replicas < 1:
            out.append(("prefill_replicas",
                        f"must be >= 1, got {self.prefill_replicas}"))
        if self.decode_replicas < 1:
            out.append(("decode_replicas",
                        f"must be >= 1, got {self.decode_replicas}"))
        if self.link_gbps <= 0:
            out.append(("link_gbps", f"must be > 0, got {self.link_gbps}"))
        if self.link_latency_ms < 0:
            out.append(("link_latency_ms",
                        f"must be >= 0, got {self.link_latency_ms}"))
        if self.link_power_w < 0:
            out.append(("link_power_w",
                        f"must be >= 0, got {self.link_power_w}"))
        if self.kv_dtype_bytes < 1:
            out.append(("kv_dtype_bytes",
                        f"must be >= 1, got {self.kv_dtype_bytes}"))
        if self.kv_bytes_per_token is not None and self.kv_bytes_per_token <= 0:
            out.append(("kv_bytes_per_token",
                        f"must be > 0, got {self.kv_bytes_per_token}"))
        return out


@dataclasses.dataclass
class DisaggRuntime:
    """What the fleet executes for a disaggregated endpoint.

    The policy factories come from the scheduling layer (the fleet injects
    them), so this module stays importable below the scheduler.
    """

    prefill_replicas: int
    decode_replicas: int
    bytes_per_s: float
    latency_s: float
    power_w: float
    kv_bytes_per_token: float
    prefill_policy_factory: Callable[[], object]
    decode_policy_factory: Callable[[], object]

    def kv_bytes(self, seq_len: int) -> int:
        return int(self.kv_bytes_per_token * max(seq_len, 0))

    def transfer_s(self, kv_bytes: int) -> float:
        """Wall time one handoff occupies the link."""
        return self.latency_s + kv_bytes / max(self.bytes_per_s, 1e-9)

    @classmethod
    def from_spec(cls, spec: DisaggSpec, cfg,
                  prefill_policy_factory: Callable[[], object],
                  decode_policy_factory: Callable[[], object],
                  ) -> "DisaggRuntime":
        probs = spec.problems()
        if probs:
            raise ValueError(f"{probs[0][0]}: {probs[0][1]}")
        per_tok = spec.kv_bytes_per_token
        if per_tok is None:
            per_tok = float(kv_cache_bytes(cfg, 1, spec.kv_dtype_bytes))
        return cls(
            prefill_replicas=spec.prefill_replicas,
            decode_replicas=spec.decode_replicas,
            bytes_per_s=spec.link_gbps * 1e9 / 8.0,
            latency_s=spec.link_latency_ms / 1e3,
            power_w=spec.link_power_w,
            kv_bytes_per_token=per_tok,
            prefill_policy_factory=prefill_policy_factory,
            decode_policy_factory=decode_policy_factory,
        )
