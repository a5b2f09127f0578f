"""Workload shapes as first-class data: arrival generators.

``repro_torch.workload.generators`` turns workload *shape* (steady Poisson,
diurnal swell, flash crowds, recorded traces) into deterministic
``Request`` streams.  Traffic calendars (rate forecasts for a predictive
autoscaler) are not ported yet.
"""

from repro_torch.workload.generators import (  # noqa: F401
    WorkloadSpec,
    bursty,
    diurnal,
    poisson,
    replay,
)
