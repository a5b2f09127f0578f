"""Failure injection and degraded-mode serving (the resilience tactics).

See :mod:`repro_torch.serving.chaos.spec` for the declarative :class:`ChaosSpec`
(the seeded failure script), :class:`RetrySpec` (the recovery tactics) and
the :class:`ChaosRuntime` the fleet executes.
"""

from repro_torch.serving.chaos.spec import (
    ChaosEvent,
    ChaosRuntime,
    ChaosSpec,
    RetryRuntime,
    RetrySpec,
)

__all__ = ["ChaosEvent", "ChaosRuntime", "ChaosSpec", "RetryRuntime",
           "RetrySpec"]
