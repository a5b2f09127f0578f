"""Virtual-clock-native observability for the serving simulator.

The missing instrument of the green-serving decision space: the simulator
models regions, chaos, disaggregation and preemption, but until now only
end-of-run aggregates came out — nobody could see *where inside a request's
lifetime* the joules, grams and milliseconds went.  This package adds:

  * :class:`~repro_torch.serving.telemetry.spec.TelemetrySpec` — the declarative
    switch (the spec API that carries it is not ported yet);
  * :class:`~repro_torch.serving.telemetry.recorder.TraceRecorder` — lifecycle
    spans per request, per-replica energy-billing spans observed straight
    off the :class:`~repro_torch.energy.meter.EnergyMeter`, fleet instants
    (shed / retry / failover / crash-loss / deferral holds) and a
    :class:`~repro_torch.serving.telemetry.recorder.MetricsRegistry` of sampled
    gauges — all stamped in virtual time, all observer-pure;
  * :mod:`~repro_torch.serving.telemetry.export` — lossless Chrome/Perfetto
    ``trace_event`` JSON export, a trace schema validator, and the
    per-SLO-class phase-breakdown table the report embeds.

The reconciliation contract: span-attributed joules AND grams equal the
meter's ``active + idle + preempt + xfer + lost`` buckets — enforced after
every billing event by the ``REPRO_SANITIZE=1`` sanitizer.
"""

from repro_torch.serving.telemetry.export import (
    phase_breakdown,
    to_perfetto,
    validate_trace,
    write_trace,
)
from repro_torch.serving.telemetry.recorder import MetricsRegistry, TraceRecorder
from repro_torch.serving.telemetry.spec import TelemetrySpec

__all__ = [
    "MetricsRegistry",
    "TelemetrySpec",
    "TraceRecorder",
    "phase_breakdown",
    "to_perfetto",
    "validate_trace",
    "write_trace",
]
