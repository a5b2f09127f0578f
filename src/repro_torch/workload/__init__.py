"""Workload shapes as first-class data: arrival generators + traffic
calendars.

``repro_torch.workload.generators`` turns workload *shape* (steady Poisson,
diurnal swell, flash crowds, recorded traces) into deterministic
``Request`` streams for the serving fleet; ``repro_torch.workload.calendar``
turns the same shapes into rate forecasts the predictive autoscaler
pre-warms against.
"""

from repro_torch.workload.calendar import (  # noqa: F401
    TrafficCalendar,
    calendar_points,
)
from repro_torch.workload.generators import (  # noqa: F401
    WorkloadSpec,
    bursty,
    diurnal,
    poisson,
    replay,
)
