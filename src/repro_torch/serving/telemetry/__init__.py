"""Observability for the serving simulator: virtual-clock traces, and the
wall-clock spans of the executed path.

The missing instrument of the green-serving decision space: the simulator
models regions, chaos, disaggregation and preemption, but until now only
end-of-run aggregates came out — nobody could see *where inside a request's
lifetime* the joules, grams and milliseconds went.  This package adds:

  * :class:`~repro_torch.serving.telemetry.spec.TelemetrySpec` — the declarative
    switch, a field of ``repro_torch.serving.api.ServingSpec``;
  * :class:`~repro_torch.serving.telemetry.recorder.TraceRecorder` — lifecycle
    spans per request, per-replica energy-billing spans observed straight
    off the :class:`~repro_torch.energy.meter.EnergyMeter`, fleet instants
    (shed / retry / failover / crash-loss / deferral holds) and a
    :class:`~repro_torch.serving.telemetry.recorder.MetricsRegistry` of sampled
    gauges — all stamped in virtual time, all observer-pure;
  * :mod:`~repro_torch.serving.telemetry.export` — lossless Chrome/Perfetto
    ``trace_event`` JSON export, a trace schema validator, and the
    per-SLO-class phase-breakdown table the report embeds;
  * :mod:`~repro_torch.serving.telemetry.wall` — the one wall-clock record:
    :class:`~repro_torch.serving.telemetry.wall.WallLog`, a ring of the last
    65 536 spans of the work the continuous-batching policy really executes
    (``repro_torch.step``, ``repro_torch.admit``, ``repro_torch.drain``, ``repro_torch.prefill``,
    ``repro_torch.insert``, ``repro_torch.decode``, ``repro_torch.token_read``,
    ``repro_torch.retire``), always on and owned by every ``SchedulerCore`` as
    ``core.wall_log``.  An operator reads ``core.wall_log.spans()`` (or
    ``spans(t0_ns, t1_ns)`` for a window of ``time.perf_counter_ns``
    instants): each span's start and end, parent, request id, tokens, a
    prefill's bucket and enqueue instant, a decode's graph-replay device
    time.  To put them on a profiler timeline, run the server under
    ``torch.profiler.profile``: each span then also enters
    ``record_function`` under its name, and ``span.start_ns +
    core.wall_log.epoch_offset_ns`` is its start on the profiler's clock.

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
