"""Roofline-driven time/energy/carbon estimation.

The three roofline terms (seconds) for a compiled step on ``chips`` devices:

    compute    = FLOPs          / (chips * peak_FLOP/s)
    memory     = HBM bytes      / (chips * HBM_bw)
    collective = collective_B   / (chips * link_bw)

Estimated step time = max of the three (the bottleneck term); energy uses a
two-bin power model (compute-bound chips burn ~peak, memory/collective-bound
chips sit lower).  The chip defaults to the card the port runs on
(``H100_SXM``).  The same terms drive the GreenReport's derived
energy-efficiency entry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.carbon.signal import CarbonSignal, ConstantSignal
from repro_torch.energy.hw import H100_SXM, ChipSpec


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    flops: float                 # total FLOPs of the step (global)
    hbm_bytes: float             # total HBM bytes accessed (global)
    collective_bytes: float      # summed collective operand bytes (global)
    chips: int
    chip: ChipSpec = H100_SXM

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.chip.peak_flops_bf16)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.chip.hbm_bw)

    @property
    def t_collective(self) -> float:
        bw = self.chip.ici_bw_per_link * self.chip.ici_links
        return self.collective_bytes / (self.chips * bw)

    @property
    def t_step(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective, 1e-12)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    def mfu(self, model_flops: float) -> float:
        """Model-FLOPs utilization at the estimated step time."""
        return model_flops / (
            self.t_step * self.chips * self.chip.peak_flops_bf16
        )


def step_power_w(terms: RooflineTerms) -> float:
    """Per-chip power during the step (two-bin linear interpolation)."""
    c = terms.chip
    # fraction of the step the tensor cores are the binding resource
    frac_compute = terms.t_compute / terms.t_step
    return c.power_membound_w + frac_compute * (
        c.power_peak_w - c.power_membound_w
    )


def step_energy_j(terms: RooflineTerms) -> float:
    """Energy per step across all chips (derived)."""
    return step_power_w(terms) * terms.chips * terms.t_step


def energy_per_token_j(terms: RooflineTerms, tokens_per_step: int) -> float:
    return step_energy_j(terms) / max(tokens_per_step, 1)


_CONSTANT_SIGNAL = ConstantSignal()


def carbon_g(energy_j: float, signal: Optional[CarbonSignal] = None,
             t_s: float = 0.0) -> float:
    """Joules -> grams CO2e through a carbon-intensity signal.

    The default signal is the constant IEA grid average — the single source
    of truth that used to be an inline ``/ 3.6e6 * CARBON_G_PER_KWH`` here;
    pass a :class:`~repro_torch.carbon.signal.CarbonSignal` and a virtual time to
    price the same joules on a time-varying grid.
    """
    return (signal if signal is not None else _CONSTANT_SIGNAL).grams(
        energy_j, t_s)


def measured_energy_j(wall_s: float, power_w: float) -> float:
    """Host-side: joules from measured wall time and an assumed package power.

    Delegates to the meter module's :func:`~repro_torch.energy.meter.measured_j` —
    the one sanctioned wall x power conversion (simlint R1) — so billing
    arithmetic has a single home.
    """
    from repro_torch.energy.meter import measured_j

    return measured_j(wall_s, power_w)
