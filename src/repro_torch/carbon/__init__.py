"""Carbon-aware serving: intensity signals + temporal demand shifting.

``repro_torch.carbon.signal`` maps virtual time to grid gCO2e/kWh (constant /
diurnal / recorded trace); ``repro_torch.carbon.shift`` holds deadline-carrying
batch requests for low-carbon windows.  ``repro_torch.energy.meter.EnergyMeter``
bills every metered joule in grams through these signals, and
``repro_torch.serving.fleet`` consumes them for carbon-aware routing, deferral
and zone attribution.

Import note: :mod:`repro_torch.energy` modules import ``repro_torch.carbon.signal``
directly (the submodule), never this package root, so the root is free to
re-export ``shift`` (which itself depends on the serving layer).
"""

from repro_torch.carbon.signal import (  # noqa: F401
    CARBON_G_PER_KWH,
    J_PER_KWH,
    CarbonSignal,
    CarbonSpec,
    ConstantSignal,
    DiurnalSignal,
    TraceSignal,
)
from repro_torch.carbon.shift import (  # noqa: F401
    DeferralSpec,
    TemporalShifter,
)
