"""Hardware constants of the energy model.

``ChipSpec`` describes an accelerator for the roofline; no card's figures
are filled in yet (they come with the roofline).  The host constants are
the serving simulator's defaults: they turn a measured wall time into
indicative joules when no power reading of the device is passed in.  A run
on the card passes the draw it measured as ``active_power_w`` and
``idle_power_w`` instead (``SchedulerCore``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float          # FLOP/s
    hbm_bw: float                   # B/s
    ici_bw_per_link: float          # B/s per link
    ici_links: int                  # links per chip in a 2D torus
    hbm_bytes: int
    power_peak_w: float             # compute-bound sustained
    power_membound_w: float         # HBM-bound sustained
    power_idle_w: float


# Host CPU used ONLY to convert measured wall-times into indicative joules
# when no device power is given; an assumed package power (no RAPL access).
HOST_CPU_POWER_W = 65.0

# Idle package draw as a fraction of active draw: a provisioned endpoint that
# is not computing still burns power (the SI4 'pay for the abstraction' cost).
HOST_CPU_IDLE_FRACTION = 0.3
HOST_CPU_IDLE_POWER_W = HOST_CPU_POWER_W * HOST_CPU_IDLE_FRACTION

# Global-average grid carbon intensity (IEA 2023), g CO2e per kWh.  The
# constant lives with the carbon-intensity signals (it is the
# ConstantSignal default); re-exported here for legacy importers.
from repro_torch.carbon.signal import CARBON_G_PER_KWH  # noqa: E402,F401
