"""Admission subsystem: priority classes, preemption, phase disaggregation.

The paper treats the scheduling/admission layer (TD3) as a first-class green
design decision; this package makes *requests* first-class citizens of a
two-phase lifecycle on top of the fleet the earlier PRs built:

  * :mod:`repro_torch.serving.admission.priority` — the priority ladder
    (interactive > standard > batch), its declarative
    :class:`~repro_torch.serving.admission.priority.PrioritySpec` and the runtime
    :class:`~repro_torch.serving.admission.priority.AdmissionControl` the scheduler
    core consults for priority-ordered admission and in-replica preemption
    (a latency-critical prefill pausing an in-flight decode batch, pause and
    resume billed on the virtual clock and in the meter's ``preempt`` bucket);
  * :mod:`repro_torch.serving.admission.disagg` — prefill/decode pool
    disaggregation: :class:`~repro_torch.serving.admission.disagg.DisaggSpec`
    declares separate prefill and decode replica pools, the fleet routes each
    phase independently, and the KV-cache handoff between pools costs modeled
    time and energy (``kv_bytes = f(seq_len, arch)`` across a per-link
    transfer spec, billed in the meter's ``xfer`` bucket).

Import note: this package sits *below* ``repro_torch.serving.core`` (the core
consults :class:`AdmissionControl` on every pop), so nothing here may import
the scheduler/fleet layers — the phase-batching policies disaggregation
plugs into the pools live in ``repro_torch.serving.scheduler`` with the other
policies, and the fleet injects them into :class:`DisaggRuntime`.
"""

from repro_torch.serving.admission.disagg import (  # noqa: F401
    DisaggRuntime,
    DisaggSpec,
    kv_cache_bytes,
)
from repro_torch.serving.admission.priority import (  # noqa: F401
    DEFAULT_PRIORITY,
    PRIORITY_LEVELS,
    AdmissionControl,
    PrioritySpec,
    priority_level,
)

__all__ = [
    "AdmissionControl",
    "DEFAULT_PRIORITY",
    "DisaggRuntime",
    "DisaggSpec",
    "PRIORITY_LEVELS",
    "PrioritySpec",
    "kv_cache_bytes",
    "priority_level",
]
