"""Carbon-aware serving: intensity signals.

``repro_torch.carbon.signal`` maps virtual time to grid gCO2e/kWh (constant /
diurnal / recorded trace); ``repro_torch.energy.meter.EnergyMeter`` bills
every metered joule in grams through these signals.  Temporal demand
shifting (the deferral of deadline-carrying batch work) is not ported yet.

Import note: :mod:`repro_torch.energy` modules import
``repro_torch.carbon.signal`` directly (the submodule), never this package
root.
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
