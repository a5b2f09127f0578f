"""Hardware constants of the energy model.

``ChipSpec`` describes an accelerator for the roofline and the derived
entries of the green report; ``H100_SXM`` is the card the port runs on.
Its rates and sizes are NVIDIA's data-sheet figures (*derived*: nothing
here measured them); its power bins are the power limit ``nvidia-smi``
reports and the card's own draw read through NVML.  The host constants are
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


# One NVIDIA H100 SXM ("NVIDIA H100 80GB HBM3" to nvidia-smi and torch).
# Derived, from NVIDIA's data sheet (dense rates): 989 TFLOP/s bf16, 3.35 TB/s
# HBM3, 80 GB, NVLink 4 at 900 GB/s over 18 links.  power_peak_w is the
# 700.00 W power limit nvidia-smi reports for the card.  power_membound_w and
# power_idle_w are NVML readings on that card at that limit (chip_smoke.py's
# api phase): 266.8 W, the mean draw while full-width minitron-4b calibrates
# SI2 at B = 1..8 (a decode-heavy, HBM-bound mix), and 126.9 W over 2 s idle.
H100_SXM = ChipSpec(
    name="NVIDIA H100 80GB HBM3",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_bw_per_link=50e9,
    ici_links=18,
    hbm_bytes=80 * 10**9,
    power_peak_w=700.0,
    power_membound_w=266.8,
    power_idle_w=126.9,
)


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
