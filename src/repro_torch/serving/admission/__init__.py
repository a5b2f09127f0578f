"""Admission subsystem: priority classes and preemption.

:mod:`repro_torch.serving.admission.priority` holds the priority ladder
(interactive > standard > batch), its declarative
:class:`~repro_torch.serving.admission.priority.PrioritySpec` and the runtime
:class:`~repro_torch.serving.admission.priority.AdmissionControl` the
scheduler core consults for priority-ordered admission and in-replica
preemption (a latency-critical prefill pausing an in-flight decode batch,
pause and resume billed on the virtual clock and in the meter's ``preempt``
bucket).  Prefill/decode pool disaggregation is not ported yet.

Import note: this package sits *below* ``repro_torch.serving.core`` (the
core consults :class:`AdmissionControl` on every pop), so nothing here may
import the scheduler layer.
"""

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
    "PRIORITY_LEVELS",
    "PrioritySpec",
    "priority_level",
]
