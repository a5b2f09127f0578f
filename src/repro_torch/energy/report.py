"""GreenReport: score a Deployment on the paper's 8 quality characteristics.

This is the paper's Table 1 turned into an executable artifact: measured
values where this host can measure (latency, throughput, bytes), derived
values from the card's roofline model (energy at production scale), and
qualitative 1-5 scores — taken from the paper's own survey findings — where
the characteristic is structural (usability, maintainability, ...).

Measured serving energy flows in through :class:`ServingMetrics`, which the
event-driven ``SchedulerCore`` populates from one
:class:`repro_torch.energy.meter.EnergyMeter` — active vs idle draw tracked
separately, per-request/per-token attribution conserved — rather than from
ad-hoc ``wall * power`` math inside each scheduler.  When a metrics object
carries its meter, the energy-efficiency entry reflects active + idle joules
(the provisioned-endpoint view the paper's SI4 discussion cares about).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.add import (
    Containerization,
    Deployment,
    ModelFormat,
    Protocol,
    RequestProcessing,
    ServingInfrastructure,
)
from repro_torch.core.quality import Provenance, Quality, QualityReport
from repro_torch.energy.estimator import RooflineTerms, energy_per_token_j
from repro_torch.serving.container import overhead
from repro_torch.serving.request import ServingMetrics

# Qualitative scores distilled from the paper's Table 1 / §6 discussion.
_USABILITY = {  # "ease-of-use": SI3/SI4 eliminate the hand-built API
    ServingInfrastructure.SI1_NO_RUNTIME: 2,
    ServingInfrastructure.SI2_RUNTIME_ENGINE: 2,
    ServingInfrastructure.SI3_DL_SERVER: 4,
    ServingInfrastructure.SI4_CLOUD_SERVICE: 5,
}
_ANALYSABILITY = {  # SI1: direct function-level analysis (Georgiou'22)
    ServingInfrastructure.SI1_NO_RUNTIME: 5,
    ServingInfrastructure.SI2_RUNTIME_ENGINE: 4,
    ServingInfrastructure.SI3_DL_SERVER: 3,
    ServingInfrastructure.SI4_CLOUD_SERVICE: 1,  # opaque managed stack
}
_MAINTAINABILITY = {  # custom components you now own
    ServingInfrastructure.SI1_NO_RUNTIME: 2,   # hand API + glue
    ServingInfrastructure.SI2_RUNTIME_ENGINE: 3,
    ServingInfrastructure.SI3_DL_SERVER: 4,
    ServingInfrastructure.SI4_CLOUD_SERVICE: 4,  # vendor lock-in tempers it
}
_SCALABILITY = {
    ServingInfrastructure.SI1_NO_RUNTIME: 1,
    ServingInfrastructure.SI2_RUNTIME_ENGINE: 2,
    ServingInfrastructure.SI3_DL_SERVER: 4,
    ServingInfrastructure.SI4_CLOUD_SERVICE: 5,  # autoscaling (Lwakatare'19)
}
_INTEROP = {  # manifest-style interchange formats score highest (Koubaa'21)
    ModelFormat.NATIVE: 2,
    ModelFormat.RSM: 5,
    ModelFormat.RSM_INT8: 3,  # needs an int8-capable runtime engine
}


def build_green_report(
    dep: Deployment,
    metrics: Optional[ServingMetrics] = None,
    roofline: Optional[RooflineTerms] = None,
    tokens_per_step: int = 1,
) -> QualityReport:
    rep = QualityReport(subject=dep.describe())
    ovh = overhead(dep.containerization)

    # -- energy efficiency -----------------------------------------------------
    if roofline is not None:
        e = energy_per_token_j(roofline, tokens_per_step) * ovh.energy_overhead
        rep.add(Quality.ENERGY_EFFICIENCY, e, "J/token", Provenance.DERIVED,
                f"roofline ({roofline.bottleneck}-bound), "
                f"{roofline.chips} chips, container x{ovh.energy_overhead}")
    elif metrics is not None:
        note = "host-proxy EnergyMeter"
        if metrics.meter is not None:
            note += (f" (active {metrics.meter.active_j:.2f}J"
                     f" + idle {metrics.meter.idle_j:.2f}J)")
        rep.add(Quality.ENERGY_EFFICIENCY,
                metrics.energy_per_token_j * ovh.energy_overhead, "J/token",
                Provenance.MEASURED,
                note + "; container overhead simulated")

    # -- performance efficiency -------------------------------------------------
    if metrics is not None:
        rep.add(Quality.PERFORMANCE_EFFICIENCY, metrics.throughput_tok_s,
                "tok/s", Provenance.MEASURED,
                f"p95 latency {metrics.latency_percentile(95):.4f}s "
                f"(x{ovh.latency_overhead} container, simulated)")
    elif roofline is not None:
        rep.add(Quality.PERFORMANCE_EFFICIENCY,
                tokens_per_step / roofline.t_step, "tok/s",
                Provenance.DERIVED, "roofline step time")

    # -- qualitative (paper Table 1 / §6) ---------------------------------------
    rep.add(Quality.USABILITY, _USABILITY[dep.si], "1-5",
            Provenance.QUALITATIVE, "paper Table 1: ease-of-use")
    rep.add(Quality.ANALYSABILITY, _ANALYSABILITY[dep.si], "1-5",
            Provenance.QUALITATIVE, "Georgiou'22 function-level analysis")
    rep.add(Quality.MAINTAINABILITY, _MAINTAINABILITY[dep.si], "1-5",
            Provenance.QUALITATIVE, "components owned by the practitioner")
    rep.add(Quality.SCALABILITY, _SCALABILITY[dep.si], "1-5",
            Provenance.QUALITATIVE, "paper: cloud autoscaling (Lwakatare'19)")
    rep.add(Quality.PORTABILITY, overhead(dep.containerization).portability_score,
            "1-5", Provenance.QUALITATIVE,
            f"containerization={dep.containerization.value} (Hampau'22)")
    rep.add(Quality.INTEROPERABILITY, _INTEROP[dep.model_format], "1-5",
            Provenance.QUALITATIVE, f"format={dep.model_format.value}")
    return rep
