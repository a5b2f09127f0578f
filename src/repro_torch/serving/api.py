"""The declarative green-serving API: every design decision as spec data.

Durán et al.'s catalog of ML-serving architectural design decisions only
becomes *usable* when a complete assignment of decisions is one comparable,
serializable value.  This module is the single public entry point to the
port's serving stack, the counterpart of the JAX package's ``serving/api``
(the same fields, defaults, validation, field paths and JSON, byte for byte,
so a spec written by either package loads in the other):

  * :class:`ServingSpec` -- the whole deployment as data: a shared virtual
    timeline, a global TTFT budget, a hardware/power envelope, and named
    :class:`EndpointSpec` s, each a full decision assignment -- serving
    infrastructure (SI1..SI4), containerization (TD1), **model format**
    (TD2 -- it really selects the replica's weights: ``rsm_int8`` endpoints
    serve QTensor weights through the int8 kernel), scheduling policy (TD3),
    wire protocol (TD4), router, :class:`AutoscaleSpec` and per-class
    :class:`SLOClass` latency budgets; the temporal (carbon signal,
    deferral, declared workloads, calendars), admission (priority ladder,
    disaggregation), resilience (regions, chaos, retry) and observability
    (telemetry, monitor) decisions are spec fields too;
  * :class:`ServingSession` -- ``deploy(spec)`` / ``submit(...)`` / ``run()``
    over one :class:`~repro_torch.serving.fleet.ReplicaFleet` on one device,
    returning a typed :class:`ServingReport` (latency percentiles,
    J/request, J/token, replica timeline, and per-decision energy
    attribution including the simulated TD1 container overhead);
  * ``spec.to_json()`` / :func:`ServingSpec.from_json` -- lossless
    round-trip, so sweeps and experiment grids are pure data;
  * :func:`sweep` -- expand ``{field_path: [values]}`` overrides into the
    cartesian grid of validated spec variants.

Validation is eager and names the offending field: every constraint violation
raises :class:`SpecError` with a ``endpoints[name].field`` style path.

A session runs on the GPU unless it is given ``device="cpu"``; without a GPU
it raises.  ``CloudService``, ``ServingServer`` and
``repro_torch.launch.serve`` are thin adapters over this module.
"""

from __future__ import annotations

import collections.abc as _abc
import dataclasses
import itertools
import json
import math
import os
import tempfile
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.carbon.shift import DeferralSpec
from repro_torch.carbon.signal import CarbonSpec
from repro_torch.configs import get_arch
from repro_torch.core.add import (
    Containerization,
    Deployment,
    ModelFormat,
    Protocol,
    ServingInfrastructure,
)
from repro_torch.core.engines import CompiledEngine, EagerEngine, Engine
from repro_torch.devices import resolve_device
from repro_torch.energy.hw import HOST_CPU_IDLE_POWER_W, HOST_CPU_POWER_W
from repro_torch.serving import container as td1
from repro_torch.serving.admission.disagg import DisaggRuntime, DisaggSpec
from repro_torch.serving.admission.priority import PRIORITY_LEVELS, PrioritySpec
from repro_torch.serving.chaos import (
    ChaosEvent,
    ChaosRuntime,
    ChaosSpec,
    RetryRuntime,
    RetrySpec,
)
from repro_torch.serving.fleet import ROUTERS, Autoscaler, FleetResult, ReplicaFleet
from repro_torch.serving.fleet import EndpointSpec as FleetEndpoint
from repro_torch.serving.regions import RegionSpec, RegionTopology
from repro_torch.serving.request import Request, ServingMetrics
from repro_torch.serving.scheduler import (
    POLICIES,
    DecodePhasePolicy,
    PrefillPhasePolicy,
    make_policy,
)
from repro_torch.serving.stepcache import StepTimeCache, calibrate, shape_bucket
from repro_torch.serving.monitor import BudgetSpec, MonitorRuntime, MonitorSpec
from repro_torch.serving.telemetry import (
    TelemetrySpec,
    TraceRecorder,
    phase_breakdown,
)
from repro_torch.workload.calendar import TrafficCalendar
from repro_torch.workload.generators import WorkloadSpec


class SpecError(ValueError):
    """A spec constraint violation, carrying the offending field's path."""

    def __init__(self, field: str, message: str):
        self.field = field
        super().__init__(f"{field}: {message}")


def _check(ok: bool, field: str, message: str) -> None:
    if not ok:
        raise SpecError(field, message)


def _check_sub(spec, path: str) -> None:
    """Surface a sub-spec's ``problems()`` (carbon/workload/deferral specs,
    which live outside the serving layer) as SpecErrors with full paths."""
    for field, message in spec.problems():
        raise SpecError(f"{path}.{field}", message)


def _construct(cls, kwargs: Mapping, path: str):
    """Build a spec dataclass from deserialized data, turning unknown or
    misspelled field names into a SpecError with the field path (rather
    than a bare TypeError from ``__init__``)."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(kwargs) - names)
    if unknown:
        raise SpecError(f"{path}.{unknown[0]}",
                        f"unknown field(s) {unknown} for {cls.__name__}; "
                        f"known: {sorted(names)}")
    return cls(**kwargs)


_FORMATS = tuple(f.value for f in ModelFormat)
_CONTAINERS = tuple(c.value for c in Containerization)
_PROTOCOLS = tuple(p.value for p in Protocol)
_SIS = tuple(s.value for s in ServingInfrastructure)


# -- the decision fields -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A named latency class: requests submitted under it inherit its budget.

    ``slo_ms`` is a per-request TTFT budget — it steers both the fleet router
    (SLO-feasibility pre-filter) and adaptive batch sizing
    (tightest-in-queue).  ``deadline_s`` mints the *batch class* instead: a
    relative completion deadline stamped on every request (absolute =
    arrival + deadline_s), which makes the request deferrable — the carbon
    shifter may hold it for a low-carbon window (``ServingSpec.deferral``).
    ``None`` for both means best-effort, serve-on-arrival.

    ``priority`` names the admission class every request submitted under
    this SLO class belongs to (``interactive`` > ``standard`` > ``batch``):
    under a :class:`~repro_torch.serving.admission.priority.PrioritySpec` ladder,
    backlogged queues serve urgent classes first and an interactive arrival
    may preempt an in-flight lower-priority decode batch.
    """

    slo_ms: Optional[float] = None
    deadline_s: Optional[float] = None
    priority: Optional[str] = None

    def validate(self, path: str) -> None:
        if self.slo_ms is not None:
            _check(self.slo_ms > 0, f"{path}.slo_ms",
                   f"budget must be > 0 ms, got {self.slo_ms}")
        if self.deadline_s is not None:
            _check(self.deadline_s > 0, f"{path}.deadline_s",
                   f"deadline must be > 0 s, got {self.deadline_s}")
        if self.priority is not None:
            _check(self.priority in PRIORITY_LEVELS, f"{path}.priority",
                   f"unknown priority class {self.priority!r}; "
                   f"known: {sorted(PRIORITY_LEVELS)}")


@dataclasses.dataclass(frozen=True)
class AutoscaleSpec:
    """THE autoscaling config — unifies the old ``cloud.AutoscalePolicy``
    (M/M/c initial sizing) and ``fleet.Autoscaler`` (windowed re-sizing).

    ``replicas_hint`` pins the initial pool; ``None`` sizes it M/M/c-style
    from the observed arrival rate and the service-time hint (exactly what
    ``AutoscalePolicy.replicas_for`` used to do).  ``enabled=False`` freezes
    the pool at its initial size (no windowed re-sizing at all).
    """

    enabled: bool = True
    min_replicas: int = 1
    max_replicas: int = 4
    replicas_hint: Optional[int] = None
    target_utilization: float = 0.7
    window_s: float = 1.0
    cold_start_s: float = 0.25
    down_windows: int = 2
    # traffic calendar: (t_s, expected requests/s) breakpoints.  The fleet
    # autoscaler provisions for the calendar's peak across its cold-start
    # horizon, pre-warming replicas ahead of predicted ramps; () = purely
    # reactive (the PR-2 behavior)
    calendar: Tuple[Tuple[float, float], ...] = ()
    # carbon-biased scale-down: > 0 shrinks this endpoint's pool harder
    # when the grid's current intensity runs above its trailing window
    # mean — desired /= (1 + carbon_bias * (intensity/mean - 1)).  The
    # traffic calendar pre-warms for *load*; this knob leans the same
    # scaler against the *carbon* forecast (both share the virtual clock)
    carbon_bias: float = 0.0

    def __post_init__(self):
        object.__setattr__(
            self, "calendar",
            tuple((float(t), float(r)) for t, r in self.calendar))

    def validate(self, path: str) -> None:
        _check(self.min_replicas >= 0, f"{path}.min_replicas",
               f"must be >= 0, got {self.min_replicas}")
        _check(self.max_replicas >= 1, f"{path}.max_replicas",
               f"must be >= 1, got {self.max_replicas}")
        _check(self.min_replicas <= self.max_replicas, f"{path}.min_replicas",
               f"min_replicas={self.min_replicas} exceeds "
               f"max_replicas={self.max_replicas}")
        if self.replicas_hint is not None:
            _check(self.replicas_hint >= 1, f"{path}.replicas_hint",
                   f"must be >= 1, got {self.replicas_hint}")
        _check(0 < self.target_utilization <= 1.0,
               f"{path}.target_utilization",
               f"must be in (0, 1], got {self.target_utilization}")
        _check(self.window_s > 0, f"{path}.window_s",
               f"must be > 0, got {self.window_s}")
        _check(self.cold_start_s >= 0, f"{path}.cold_start_s",
               f"must be >= 0, got {self.cold_start_s}")
        _check(self.down_windows >= 1, f"{path}.down_windows",
               f"must be >= 1, got {self.down_windows}")
        _check(self.carbon_bias >= 0, f"{path}.carbon_bias",
               f"must be >= 0, got {self.carbon_bias}")
        ts = [t for t, _ in self.calendar]
        _check(all(b > a for a, b in zip(ts, ts[1:])), f"{path}.calendar",
               f"calendar times must be strictly increasing, got {ts}")
        _check(all(r >= 0 for _, r in self.calendar), f"{path}.calendar",
               "calendar rates must be >= 0")

    def initial_pool(self, rate_per_s: float, service_time_s: float) -> int:
        """Initial replica count: the pinned hint, else M/M/c sizing (the
        folded-in ``AutoscalePolicy.replicas_for``)."""
        if self.replicas_hint is not None:
            return max(self.min_replicas,
                       min(self.max_replicas, self.replicas_hint))
        needed = rate_per_s * service_time_s / self.target_utilization
        return max(self.min_replicas,
                   min(self.max_replicas, math.ceil(needed)))


@dataclasses.dataclass(frozen=True)
class EndpointSpec:
    """One endpoint = one complete assignment of the paper's decisions."""

    name: str
    arch: str
    model: str = ""                    # registry model name; "" -> name
    version: int = 1
    format: str = "rsm"                # TD2 — selects the replica's weights
    si: str = "si4_cloud"              # SI1..SI4 (si1 -> eager engine)
    container: str = "none"            # TD1 — billed via container.overhead()
    protocol: str = "grpc_binary"      # TD4 — wire codec (server adapter)
    policy: str = "dynamic_batch"      # TD3 request processing
    max_batch: int = 8
    batch_timeout_ms: float = 20.0
    max_seq: int = 256
    # endpoint TTFT budget steering the router's SLO pre-filter and the
    # policy's batch sizing; None falls back to the spec-global
    # ttft_budget_s (and, for the policy target only, a 200 ms default)
    ttft_slo_ms: Optional[float] = None
    autoscale: AutoscaleSpec = AutoscaleSpec()
    slo_classes: Mapping[str, SLOClass] = dataclasses.field(
        default_factory=dict)
    service_time_hint_s: float = 0.1   # until a measurement exists
    # power envelope overrides; None inherits the ServingSpec envelope
    active_power_w: Optional[float] = None
    idle_power_w: Optional[float] = None
    # simulation knob: replay measured step times on fleet replicas (the
    # server adapter turns this off when registered without a cache, so an
    # uncached endpoint really executes the model every dispatch)
    step_cache: bool = True
    # carbon zones the endpoint's replicas cycle through (replica i sits in
    # zones[i % len]; names must exist in ServingSpec.carbon_zones); () =
    # every replica on the spec's default carbon signal
    zones: Tuple[str, ...] = ()
    # the endpoint's declared arrival stream: ``ServingSession.run_declared``
    # generates and serves exactly this workload, so a benchmark grid can
    # sweep traffic shape like any other decision field
    workload: Optional[WorkloadSpec] = None
    # prefill/decode disaggregation (repro_torch.serving.admission.disagg):
    # enabled, the endpoint serves from fixed prefill+decode pools with a
    # modeled KV handoff between them — sweepable like any decision field
    disagg: DisaggSpec = DisaggSpec()

    def __post_init__(self):
        object.__setattr__(self, "zones", tuple(self.zones))

    @property
    def model_name(self) -> str:
        return self.model or self.name

    def validate(self, path: str) -> None:
        _check(bool(self.name), f"{path}.name", "endpoint name is empty")
        _check(bool(self.arch), f"{path}.arch", "arch is required")
        _check(self.format in _FORMATS, f"{path}.format",
               f"unknown model format {self.format!r}; "
               f"known: {sorted(_FORMATS)}")
        _check(self.si in _SIS, f"{path}.si",
               f"unknown serving infrastructure {self.si!r}; "
               f"known: {sorted(_SIS)}")
        _check(self.container in _CONTAINERS, f"{path}.container",
               f"unknown containerization {self.container!r}; "
               f"known: {sorted(_CONTAINERS)}")
        _check(self.protocol in _PROTOCOLS, f"{path}.protocol",
               f"unknown protocol {self.protocol!r}; "
               f"known: {sorted(_PROTOCOLS)}")
        _check(self.policy in POLICIES, f"{path}.policy",
               f"unknown scheduling policy {self.policy!r}; "
               f"known: {sorted(POLICIES)}")
        _check(self.max_batch >= 1, f"{path}.max_batch",
               f"must be >= 1, got {self.max_batch}")
        if self.policy == "realtime":
            _check(self.max_batch == 1, f"{path}.max_batch",
                   "realtime processing implies max_batch == 1")
        _check(self.batch_timeout_ms >= 0, f"{path}.batch_timeout_ms",
               f"must be >= 0, got {self.batch_timeout_ms}")
        _check(self.max_seq >= 1, f"{path}.max_seq",
               f"must be >= 1, got {self.max_seq}")
        if self.ttft_slo_ms is not None:
            _check(self.ttft_slo_ms > 0, f"{path}.ttft_slo_ms",
                   f"budget must be > 0 ms, got {self.ttft_slo_ms}")
        _check(self.service_time_hint_s > 0, f"{path}.service_time_hint_s",
               f"must be > 0, got {self.service_time_hint_s}")
        # the paper's §4.1 compatibility constraints
        if self.si == "si1_no_runtime":
            _check(self.format != "rsm_int8", f"{path}.format",
                   "rsm_int8 requires a runtime engine (SI2/SI3/SI4)")
            _check(self.policy != "continuous_batch", f"{path}.policy",
                   "continuous batching requires SI2+ (compiled decode)")
        if self.si != "si4_cloud":
            _check(self.autoscale.max_replicas <= 1,
                   f"{path}.autoscale.max_replicas",
                   "autoscaling replicas are an SI4 (cloud) capability")
        _check_sub(self.disagg, f"{path}.disagg")
        if self.disagg.enabled:
            _check(self.si == "si4_cloud", f"{path}.disagg.enabled",
                   "prefill/decode disaggregation is an SI4 (cloud) "
                   "capability (separate replica pools)")
            _check(self.policy != "continuous_batch", f"{path}.policy",
                   "continuous batching is an in-replica loop; "
                   "disaggregated pools use windowed phase batching")
            # the phase split IS the provisioning decision: the windowed
            # autoscaler does not resize disaggregated pools, so a spec
            # declaring both would be a silent no-op — reject it eagerly
            _check(not self.autoscale.enabled, f"{path}.autoscale.enabled",
                   "disaggregated pools are fixed-size "
                   "(disagg.prefill_replicas/decode_replicas); set "
                   "autoscale.enabled=False")
        self.autoscale.validate(f"{path}.autoscale")
        for cls_name, cls in self.slo_classes.items():
            cls.validate(f"{path}.slo_classes[{cls_name}]")
        if self.workload is not None:
            _check_sub(self.workload, f"{path}.workload")
        if self.active_power_w is not None:
            _check(self.active_power_w > 0, f"{path}.active_power_w",
                   f"must be > 0, got {self.active_power_w}")
        if self.idle_power_w is not None:
            _check(self.idle_power_w >= 0, f"{path}.idle_power_w",
                   f"must be >= 0, got {self.idle_power_w}")

    def decisions(self) -> Dict[str, object]:
        """The decision assignment as a flat dict (report attribution)."""
        return {
            "si": self.si,
            "container": self.container,
            "format": self.format,
            "policy": self.policy,
            "protocol": self.protocol,
            "autoscale": "windowed" if self.autoscale.enabled else "fixed",
            "max_batch": self.max_batch,
            "disagg": "prefill/decode" if self.disagg.enabled else "unified",
        }


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """The whole deployment as one comparable, serializable value."""

    endpoints: Tuple[EndpointSpec, ...]
    router: str = "round_robin"
    ttft_budget_s: Optional[float] = None   # global TTFT budget (fallback)
    # hardware/power envelope (endpoint fields override)
    active_power_w: float = HOST_CPU_POWER_W
    idle_power_w: float = HOST_CPU_IDLE_POWER_W
    # the default-zone grid carbon signal (every joule is billed in gCO2e
    # through it) and any extra named zones endpoints may place replicas in
    carbon: CarbonSpec = CarbonSpec()
    carbon_zones: Mapping[str, CarbonSpec] = dataclasses.field(
        default_factory=dict)
    # temporal shifting of deadline-carrying (batch-class) requests; the
    # default is disabled == serve-on-arrival (the pre-carbon behavior)
    deferral: DeferralSpec = DeferralSpec()
    # the admission ladder (interactive > standard > batch) and in-replica
    # preemption contract, fleet-wide; disabled = FIFO, never preempt
    priority: PrioritySpec = PrioritySpec()
    # geo-distributed regions: named places with their own carbon
    # signal and an egress link; endpoint zones and chaos targets may name
    # them, and requests whose origin region differs from their serving
    # replica's pay inter-region transit through the xfer bucket
    regions: Mapping[str, RegionSpec] = dataclasses.field(
        default_factory=dict)
    # the seeded failure script (crash / outage / brownout) and the
    # recovery tactics answering it; no events = the healthy world, which
    # reproduces the pre-chaos timeline byte for byte
    chaos: ChaosSpec = ChaosSpec()
    retry: RetrySpec = RetrySpec()
    # observability: the virtual-clock trace/metrics recorder.  A
    # pure observer — enabling it changes no joule, gram or latency (the
    # bit-identity tests sweep exactly this switch); disabled (the
    # default) costs one attribute check per billing event
    telemetry: TelemetrySpec = TelemetrySpec()
    # green-SRE monitoring: windowed signals, budget burn-rate
    # alerting and incident detection over the telemetry stream.  Another
    # pure observer (invariant R6) — it *consumes* the trace, so enabling
    # it requires telemetry.enabled
    monitor: MonitorSpec = MonitorSpec()

    def __post_init__(self):
        if not isinstance(self.endpoints, tuple):
            object.__setattr__(self, "endpoints", tuple(self.endpoints))

    # -- access ----------------------------------------------------------------
    def endpoint(self, name: str) -> EndpointSpec:
        for ep in self.endpoints:
            if ep.name == name:
                return ep
        raise SpecError("endpoints",
                        f"no endpoint named {name!r}; "
                        f"known: {[e.name for e in self.endpoints]}")

    # -- validation ------------------------------------------------------------
    def validate(self) -> "ServingSpec":
        _check(len(self.endpoints) > 0, "endpoints",
               "a spec needs at least one endpoint")
        seen = set()
        for i, ep in enumerate(self.endpoints):
            if ep.name in seen:
                raise SpecError(f"endpoints[{i}].name",
                                f"duplicate endpoint name {ep.name!r}")
            seen.add(ep.name)
            ep.validate(f"endpoints[{ep.name}]")
        _check(self.router in ROUTERS, "router",
               f"unknown router {self.router!r}; known: {sorted(ROUTERS)}")
        if self.ttft_budget_s is not None:
            _check(self.ttft_budget_s > 0, "ttft_budget_s",
                   f"budget must be > 0 s, got {self.ttft_budget_s}")
        _check(self.active_power_w > 0, "active_power_w",
               f"must be > 0, got {self.active_power_w}")
        _check(self.idle_power_w >= 0, "idle_power_w",
               f"must be >= 0, got {self.idle_power_w}")
        _check_sub(self.carbon, "carbon")
        for zone, cs in self.carbon_zones.items():
            _check(bool(zone), "carbon_zones",
                   "zone names must be non-empty ('' is the default zone)")
            _check_sub(cs, f"carbon_zones[{zone}]")
        _check_sub(self.deferral, "deferral")
        _check_sub(self.priority, "priority")
        for rname, rs in self.regions.items():
            _check(bool(rname), "regions",
                   "region names must be non-empty")
            _check(rname not in self.carbon_zones, f"regions[{rname}]",
                   "region name collides with a carbon_zones entry; a "
                   "region already carries its own carbon signal")
            _check_sub(rs, f"regions[{rname}]")
        _check_sub(self.chaos, "chaos")
        _check_sub(self.retry, "retry")
        _check_sub(self.telemetry, "telemetry")
        _check_sub(self.monitor, "monitor")
        _check(not self.monitor.enabled or self.telemetry.enabled,
               "monitor.enabled",
               "the monitor consumes the telemetry stream; "
               "set telemetry.enabled=True too")
        ep_names = {e.name for e in self.endpoints}
        all_classes = {c for e in self.endpoints for c in e.slo_classes}
        for i, b in enumerate(self.monitor.budgets):
            if b.endpoint:
                _check(b.endpoint in ep_names,
                       f"monitor.budgets[{i}].endpoint",
                       f"unknown endpoint {b.endpoint!r}; "
                       f"known: {sorted(ep_names)}")
            if b.slo_class:
                scope = (set(self.endpoint(b.endpoint).slo_classes)
                         if b.endpoint else all_classes)
                # workloads may carry priority classes the endpoints never
                # declare (e.g. WorkloadSpec.priority); only enforce
                # membership when classes are declared at all
                _check(not scope or b.slo_class in scope,
                       f"monitor.budgets[{i}].slo_class",
                       f"unknown SLO class {b.slo_class!r}; "
                       f"known: {sorted(scope)}")
        places = set(self.regions) | set(self.carbon_zones)
        for i, ev in enumerate(self.chaos.events):
            if ev.kind == "outage" or (ev.kind == "brownout" and ev.target):
                _check(ev.target in self.regions,
                       f"chaos.events[{i}].target",
                       f"unknown region {ev.target!r}; "
                       f"known: {sorted(self.regions)}")
        for ep in self.endpoints:
            for z in ep.zones:
                _check(z == "" or z in places,
                       f"endpoints[{ep.name}].zones",
                       f"unknown carbon zone/region {z!r}; "
                       f"known: {sorted(places)} (plus '')")
            if ep.workload is not None:
                for o in ep.workload.origins:
                    _check(o in self.regions,
                           f"endpoints[{ep.name}].workload.origins",
                           f"unknown region {o!r}; "
                           f"known: {sorted(self.regions)}")
        # the shared-timeline knobs must agree (one fleet autoscaler)
        scaled = [ep for ep in self.endpoints if ep.autoscale.enabled]
        for field in ("window_s", "target_utilization", "down_windows"):
            vals = {getattr(ep.autoscale, field) for ep in scaled}
            if len(vals) > 1:
                raise SpecError(
                    f"endpoints[*].autoscale.{field}",
                    f"endpoints sharing a timeline disagree: {sorted(vals)}; "
                    "autoscale windows are fleet-global")
        return self

    # -- serialization ---------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ServingSpec":
        eps = []
        for i, e in enumerate(d.get("endpoints", ())):
            e = dict(e)
            path = f"endpoints[{e.get('name', i)}]"
            e["autoscale"] = _construct(AutoscaleSpec, e.get("autoscale", {}),
                                        f"{path}.autoscale")
            e["slo_classes"] = {
                k: _construct(SLOClass, v, f"{path}.slo_classes[{k}]")
                for k, v in e.get("slo_classes", {}).items()}
            if e.get("workload") is not None:
                e["workload"] = _construct(WorkloadSpec, e["workload"],
                                           f"{path}.workload")
            if e.get("disagg") is not None:
                e["disagg"] = _construct(DisaggSpec, e["disagg"],
                                         f"{path}.disagg")
            eps.append(_construct(EndpointSpec, e, path))
        top = {k: v for k, v in d.items() if k != "endpoints"}
        top["endpoints"] = tuple(eps)
        if top.get("carbon") is not None:
            top["carbon"] = _construct(CarbonSpec, top["carbon"], "carbon")
        top["carbon_zones"] = {
            z: _construct(CarbonSpec, cs, f"carbon_zones[{z}]")
            for z, cs in (top.get("carbon_zones") or {}).items()}
        if top.get("deferral") is not None:
            top["deferral"] = _construct(DeferralSpec, top["deferral"],
                                         "deferral")
        if top.get("priority") is not None:
            top["priority"] = _construct(PrioritySpec, top["priority"],
                                         "priority")
        regions = {}
        for rn, rs in (top.get("regions") or {}).items():
            rs = dict(rs)
            if rs.get("carbon") is not None:
                rs["carbon"] = _construct(CarbonSpec, rs["carbon"],
                                          f"regions[{rn}].carbon")
            regions[rn] = _construct(RegionSpec, rs, f"regions[{rn}]")
        top["regions"] = regions
        if top.get("chaos") is not None:
            ch = dict(top["chaos"])
            ch["events"] = tuple(
                _construct(ChaosEvent, e, f"chaos.events[{i}]")
                for i, e in enumerate(ch.get("events") or ()))
            top["chaos"] = _construct(ChaosSpec, ch, "chaos")
        if top.get("retry") is not None:
            top["retry"] = _construct(RetrySpec, top["retry"], "retry")
        if top.get("telemetry") is not None:
            top["telemetry"] = _construct(TelemetrySpec, top["telemetry"],
                                          "telemetry")
        if top.get("monitor") is not None:
            mon = dict(top["monitor"])
            mon["budgets"] = tuple(
                _construct(BudgetSpec, b, f"monitor.budgets[{i}]")
                for i, b in enumerate(mon.get("budgets") or ()))
            top["monitor"] = _construct(MonitorSpec, mon, "monitor")
        return _construct(cls, top, "spec")

    @classmethod
    def from_json(cls, text: str) -> "ServingSpec":
        return cls.from_dict(json.loads(text))


# -- spec sweeps: design-decision grids from pure data -------------------------


def _replace_path(obj, parts: Sequence[str], value, path: str):
    head = parts[0]
    if not any(f.name == head for f in dataclasses.fields(obj)):
        raise SpecError(path, f"{type(obj).__name__} has no field {head!r}")
    if len(parts) == 1:
        return dataclasses.replace(obj, **{head: value})
    cur = getattr(obj, head)
    if cur is None:
        raise SpecError(path, f"{type(obj).__name__}.{head} is unset; "
                              f"cannot descend into it")
    if isinstance(cur, _abc.Mapping):
        # mapping fields sweep by key: slo_classes.<name>.slo_ms or
        # slo_classes.*.slo_ms (all classes at once — the rate x SLO grid)
        key, rest = parts[1], parts[2:]
        if not rest:
            raise SpecError(path, f"mapping override needs a field after "
                                  f"the key, e.g. {head}.{key or '<name>'}"
                                  f".<field>")
        if key != "*" and key not in cur:
            raise SpecError(path, f"{head!r} has no key {key!r}; "
                                  f"known: {sorted(cur)}")
        new = {k: (_replace_path(v, rest, value, path)
                   if key in ("*", k) else v)
               for k, v in cur.items()}
        return dataclasses.replace(obj, **{head: new})
    sub = _replace_path(cur, parts[1:], value, path)
    return dataclasses.replace(obj, **{head: sub})


def with_override(spec: ServingSpec, path: str, value) -> ServingSpec:
    """A copy of ``spec`` with one dotted field path replaced.

    ``"router"`` and other top-level fields address the spec itself;
    ``"endpoints.<name>.<field...>"`` addresses one endpoint (``*`` = all),
    e.g. ``"endpoints.bulk.format"`` or ``"endpoints.*.autoscale.window_s"``.
    """
    parts = path.split(".")
    if parts[0] != "endpoints":
        return _replace_path(spec, parts, value, path)
    _check(len(parts) >= 3, path,
           "endpoint overrides look like endpoints.<name>.<field>")
    sel, rest = parts[1], parts[2:]
    if sel != "*":
        spec.endpoint(sel)             # raises SpecError if unknown
    eps = tuple(
        _replace_path(ep, rest, value, path) if sel in ("*", ep.name) else ep
        for ep in spec.endpoints
    )
    return dataclasses.replace(spec, endpoints=eps)


def sweep(spec: ServingSpec,
          overrides: Mapping[str, Sequence]) -> List[Tuple[dict, ServingSpec]]:
    """Expand ``{field_path: [values]}`` into the cartesian grid of variants.

    Returns ``[(assignment, spec), ...]`` where ``assignment`` maps each
    swept path to the value this variant uses.  Every variant is validated,
    so an infeasible cell fails at grid-construction time with the offending
    field path — not halfway through a benchmark run.
    """
    paths = list(overrides)
    out = []
    for combo in itertools.product(*(overrides[p] for p in paths)):
        variant = spec
        for path, value in zip(paths, combo):
            variant = with_override(variant, path, value)
        out.append((dict(zip(paths, combo)), variant.validate()))
    return out


# -- Deployment bridge (the legacy entry points build specs through this) ------


def endpoint_from_deployment(name: str, dep: Deployment, *,
                             model: str = "", version: int = 1,
                             max_seq: Optional[int] = None,
                             autoscale_enabled: bool = True) -> EndpointSpec:
    """Translate a legacy :class:`~repro_torch.core.add.Deployment` into the one
    declarative vocabulary (the adapters' shim path)."""
    return EndpointSpec(
        name=name,
        arch=dep.arch,
        model=model,
        version=version,
        format=dep.model_format.value,
        si=dep.si.value,
        container=dep.containerization.value,
        protocol=dep.protocol.value,
        policy=dep.request_processing.value,
        max_batch=dep.max_batch,
        batch_timeout_ms=dep.batch_timeout_ms,
        max_seq=max_seq if max_seq is not None else dep.max_seq,
        ttft_slo_ms=dep.ttft_slo_ms,
        autoscale=AutoscaleSpec(
            enabled=autoscale_enabled,
            min_replicas=dep.min_replicas,
            max_replicas=dep.max_replicas,
            window_s=dep.autoscale_window_s,
            cold_start_s=dep.cold_start_s,
        ),
    )


# -- the report ----------------------------------------------------------------


@dataclasses.dataclass
class EndpointReport:
    """Typed result slice for one endpoint (or the whole fleet)."""

    name: str
    decisions: Dict[str, object]
    n_requests: int
    total_tokens: int
    latency_p50_s: float
    latency_p95_s: float
    latency_p99_s: float
    mean_ttft_s: float
    throughput_tok_s: float
    j_active: float
    j_idle: float
    j_measured: float                  # meter total (active + idle)
    j_container_overhead: float        # simulated TD1 multiplier (Hampau'22)
    j_billed: float                    # measured + container overhead
    j_per_request: float               # billed
    j_per_token: float                 # billed
    replica_seconds: float
    cold_starts: int
    replica_timeline: List[Tuple[float, int]]
    j_by_replica: Dict[str, float]     # per-replica meter provenance
    # carbon attribution: every metered joule priced at its drawing
    # instant on the zone's intensity signal (conserved like joules);
    # billed = measured + the TD1 container overhead at the endpoint's
    # realized g/J ratio, mirroring j_measured vs j_billed
    gco2_total: float                  # measured (meter grams)
    gco2_active: float
    gco2_idle: float
    gco2_container_overhead: float
    gco2_billed: float
    gco2_per_request: float            # billed
    gco2_per_token: float              # billed
    gco2_by_replica: Dict[str, float]
    # fraction of deadline-carrying responses that finished in time
    # (None when the workload had no batch-class requests)
    deadline_compliance: Optional[float]
    metrics: ServingMetrics            # full object, not serialized
    # admission-layer attribution: preemption pause/resume overhead
    # and KV-handoff transfer energy (zero outside those tactics)
    j_preempt: float = 0.0
    j_xfer: float = 0.0
    gco2_preempt: float = 0.0
    gco2_xfer: float = 0.0
    # per-priority-class p95 TTFT ({} when the workload is classless)
    ttft_p95_by_class: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # resilience attribution: joules/grams a crash billed but never
    # delivered (the meter's ``lost`` bucket), and — for chaos-injected
    # runs — per-class availability with the recorded drops (retry budget
    # exhausted) and sheds (degraded-mode batch work) that explain the
    # gap.  ``availability`` is None for healthy (chaos-less) runs
    j_lost: float = 0.0
    gco2_lost: float = 0.0
    availability: Optional[float] = None
    availability_by_class: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    drops_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    shed_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    # observability: per-SLO-class time decomposition of every
    # delivered request — {class: {phase: {n, mean_s, p50_s, p95_s}}} over
    # queue_wait/prefill/xfer/decode/preempted.  {} when telemetry is off
    phase_breakdown: Dict[str, Dict[str, Dict[str, float]]] = \
        dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        # field-by-field, NOT dataclasses.asdict: asdict would deep-copy
        # every response token array inside `metrics` just to discard it
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "metrics"}


@dataclasses.dataclass
class ServingReport:
    """What :meth:`ServingSession.run` returns: every number a green-serving
    comparison needs, decomposed per endpoint and per design decision."""

    spec: ServingSpec
    endpoints: Dict[str, EndpointReport]
    fleet: EndpointReport
    result: FleetResult                # the raw fleet result (adapters)
    # the trace recorder when spec.telemetry.enabled (feed it to
    # repro_torch.serving.telemetry.write_trace for a Perfetto-loadable JSON);
    # None for untraced runs.  Not serialized.
    telemetry: Optional[TraceRecorder] = None
    # the finalized monitor runtime when spec.monitor.enabled (feed it to
    # repro_torch.serving.monitor.write_dashboard for the ops page); None for
    # unmonitored runs.  Not serialized — its operator-facing outputs are:
    monitor: Optional[MonitorRuntime] = None
    alerts: List[dict] = dataclasses.field(default_factory=list)
    incidents: List[dict] = dataclasses.field(default_factory=list)
    budget_remaining: Dict[str, dict] = dataclasses.field(
        default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "spec": self.spec.to_dict(),
            "endpoints": {n: r.to_dict() for n, r in self.endpoints.items()},
            "fleet": self.fleet.to_dict(),
            "alerts": list(self.alerts),
            "incidents": list(self.incidents),
            "budget_remaining": dict(self.budget_remaining),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)


def _percentiles(m: ServingMetrics) -> Tuple[float, float, float]:
    return (m.latency_percentile(50), m.latency_percentile(95),
            m.latency_percentile(99))


def _endpoint_report(name: str, decisions: Dict[str, object],
                     m: ServingMetrics, energy_mult: float) -> EndpointReport:
    stats = m.fleet or {}
    p50, p95, p99 = _percentiles(m)
    measured = m.meter.total_j if m.meter is not None else m.energy_j
    overhead_j = measured * (energy_mult - 1.0)
    billed = measured + overhead_j
    by_replica = {}
    g_by_replica = {}
    if m.meter is not None:
        # all five buckets, so the per-replica provenance sums to the
        # endpoint total even under preemption / KV handoffs / crash loss
        by_replica = {
            src: round(d["active_j"] + d["idle_j"]
                       + d.get("preempt_j", 0.0) + d.get("xfer_j", 0.0)
                       + d.get("lost_j", 0.0), 6)
            for src, d in sorted(m.meter.by_source.items())}
        g_by_replica = {
            src: round(d.get("active_g", 0.0) + d.get("idle_g", 0.0)
                       + d.get("preempt_g", 0.0) + d.get("xfer_g", 0.0)
                       + d.get("lost_g", 0.0), 9)
            for src, d in sorted(m.meter.by_source.items())}
    g_total = m.meter.total_g if m.meter is not None else 0.0
    return EndpointReport(
        name=name,
        decisions=decisions,
        n_requests=len(m.responses),
        total_tokens=m.total_tokens,
        latency_p50_s=p50, latency_p95_s=p95, latency_p99_s=p99,
        mean_ttft_s=m.mean_ttft_s,
        throughput_tok_s=m.throughput_tok_s,
        j_active=m.meter.active_j if m.meter else 0.0,
        j_idle=m.meter.idle_j if m.meter else 0.0,
        j_measured=measured,
        j_container_overhead=overhead_j,
        j_billed=billed,
        j_per_request=billed / max(len(m.responses), 1),
        j_per_token=billed / max(m.total_tokens, 1),
        replica_seconds=stats.get("replica_seconds", 0.0),
        cold_starts=stats.get("cold_starts", 0),
        replica_timeline=stats.get("replica_timeline", []),
        j_by_replica=by_replica,
        gco2_total=g_total,
        gco2_active=m.meter.active_g if m.meter else 0.0,
        gco2_idle=m.meter.idle_g if m.meter else 0.0,
        gco2_container_overhead=g_total * (energy_mult - 1.0),
        gco2_billed=g_total * energy_mult,
        gco2_per_request=g_total * energy_mult / max(len(m.responses), 1),
        gco2_per_token=g_total * energy_mult / max(m.total_tokens, 1),
        gco2_by_replica=g_by_replica,
        deadline_compliance=m.deadline_compliance,
        metrics=m,
        j_preempt=m.meter.preempt_j if m.meter else 0.0,
        j_xfer=m.meter.xfer_j if m.meter else 0.0,
        gco2_preempt=m.meter.preempt_g if m.meter else 0.0,
        gco2_xfer=m.meter.xfer_g if m.meter else 0.0,
        ttft_p95_by_class={c: m.ttft_percentile(95, c)
                           for c in m.priority_classes()},
        j_lost=m.meter.lost_j if m.meter else 0.0,
        gco2_lost=m.meter.lost_g if m.meter else 0.0,
        availability=stats.get("availability"),
        availability_by_class=stats.get("availability_by_class", {}),
        drops_by_class=stats.get("drops_by_class", {}),
        shed_by_class=stats.get("shed_by_class", {}),
    )


# -- the session ---------------------------------------------------------------


class ServingSession:
    """The single facade over the serving stack: deploy / submit / run.

    A session owns engines (memoized across deploys by (model, version,
    format, si, arch, max_seq), so sweeping a spec grid rebuilds nothing it
    has already built), calibration caches (keyed by engine, so a format
    calibrated once stays calibrated for every variant that uses it), and a
    model registry directory (supplied, or a session-private temp dir).
    Its engines and their weights live on ``device``: the GPU unless the
    caller names the CPU (``resolve_device``; no GPU raises).
    """

    def __init__(self, registry_root: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self._registry_root = registry_root
        self._tmp_registry: Optional[tempfile.TemporaryDirectory] = None
        self._endpoints: Dict[str, dict] = {}   # name -> {engine, spec}
        self._workloads: Dict[str, List[Request]] = {}
        self._hints: Dict[str, float] = {}
        # key -> (params, engine); see _build_engine for the key contract
        self._engine_memo: Dict[tuple, Tuple[object, Engine]] = {}
        # calibration caches keyed by engine object (identity hash): the
        # strong reference pins the engine so a recycled id() can never
        # attach another engine's measured step times
        self._cal: Dict[Engine, StepTimeCache] = {}
        self.spec: Optional[ServingSpec] = None

    # -- deploy ---------------------------------------------------------------
    def deploy(self, spec: ServingSpec, *,
               params: Optional[Mapping[str, object]] = None,
               engines: Optional[Mapping[str, Engine]] = None,
               ) -> "ServingSession":
        """Validate ``spec`` and stand its endpoints up.

        ``params`` maps model names to parameter trees (torch tensors, as
        ``init_params`` or ``params_from_numpy`` give them); each endpoint's
        params are pushed to the session registry in the endpoint's **model
        format** and pulled back through it onto the session's device
        (``rsm_int8`` endpoints serve QTensor weights), then wrapped in the
        SI-appropriate engine.
        ``engines`` short-circuits that for adapters that already own an
        engine.  Re-deploying replaces the previous spec; submitted-but-unrun
        workloads are dropped.
        """
        spec.validate()
        self.spec = spec
        self._endpoints = {}
        self._workloads = {}
        self._hints = {}
        for ep in spec.endpoints:
            if engines is not None and ep.name in engines:
                engine = engines[ep.name]
            else:
                if params is None or ep.model_name not in params:
                    raise SpecError(
                        f"endpoints[{ep.name}]",
                        f"no params for model {ep.model_name!r} and no "
                        "engine injected; pass params={...} or engines={...}")
                engine = self._build_engine(ep, params[ep.model_name])
            self._endpoints[ep.name] = {"engine": engine, "spec": ep}
        return self

    def _registry(self) -> str:
        if self._registry_root is None:
            # held on the session so its finalizer removes the serialized
            # weights when the session is collected (or at interpreter exit)
            self._tmp_registry = tempfile.TemporaryDirectory(
                prefix="repro-registry-")
            self._registry_root = self._tmp_registry.name
        os.makedirs(self._registry_root, exist_ok=True)
        return self._registry_root

    def _build_engine(self, ep: EndpointSpec, template_params) -> Engine:
        """Materialize the TD2 decision: the format on disk IS the format
        served — int8 endpoints pull QTensor weights, fp32 endpoints pull
        full precision, from the same uploaded checkpoint.

        The memo key includes the params' identity (and the memo entry pins
        the params object alive), so re-deploying the same model name with
        DIFFERENT weights rebuilds — it never silently serves the first
        deploy's checkpoint.
        """
        # intentional identity memo: the key pins the params object alive,
        # and the memo is process-local build caching — it never influences
        # the simulated timeline, so replay determinism is unaffected
        key = (id(template_params),                # simlint: allow(id-key)
               ep.model_name, ep.version, ep.format,
               ep.si, ep.arch, ep.max_seq)
        hit = self._engine_memo.get(key)
        if hit is not None:
            return hit[1]
        from repro_torch.serving import formats

        cfg = get_arch(ep.arch)
        path = os.path.join(self._registry(),
                            f"{ep.model_name}-v{ep.version}.{ep.format}")
        if ep.format == "native":
            formats.save_native(template_params, path)
            served = formats.load_native(template_params, path,
                                         device=self.device)
        else:
            formats.save_rsm(template_params, path,
                             quantize=(ep.format == "rsm_int8"))
            served = formats.load_rsm(template_params, path,
                                      as_qtensor=(ep.format == "rsm_int8"),
                                      device=self.device)
        if ep.si == "si1_no_runtime":
            engine: Engine = EagerEngine(cfg, served, ep.max_seq, self.device)
        else:
            engine = CompiledEngine(cfg, served, ep.max_seq, self.device)
        self._engine_memo[key] = (template_params, engine)
        return engine

    def engine(self, name: str) -> Engine:
        return self._endpoints[name]["engine"]

    # -- calibration / warm caches --------------------------------------------
    def calibrate(self, name: str, *, batch_sizes, prompt_len: int,
                  max_new: int,
                  num_slots: Optional[int] = None) -> StepTimeCache:
        """Measure step times once per engine; every replica of any variant
        that shares the engine replays them (sweeps stay sub-second).
        Already-measured shapes are skipped, so calibrating two endpoints
        that resolve to the same memoized engine costs one measurement."""
        engine = self.engine(name)
        cache = self._cal.setdefault(engine, StepTimeCache())
        ep: EndpointSpec = self._endpoints[name]["spec"]
        sb = shape_bucket(prompt_len)
        missing = [b for b in batch_sizes
                   if not cache.has(("generate", b, sb, max_new))]
        slots = num_slots
        if slots is not None and cache.has(("prefill1", sb)) \
                and cache.has(("decode", slots)):
            slots = None
        if not missing and slots is None:
            return cache
        cfg = get_arch(ep.arch)
        calibrate(engine, cache, batch_sizes=missing,
                  prompt_len=prompt_len, max_new=max_new,
                  vocab=cfg.vocab_size, num_slots=slots,
                  max_seq=ep.max_seq)
        return cache

    def warm(self, name: str, cache: StepTimeCache) -> None:
        """Adopt an externally calibrated cache for this endpoint's engine."""
        engine = self.engine(name)
        self._cal.setdefault(engine, StepTimeCache()).seed_from(cache)

    def _warm_cache(self, name: str) -> Optional[StepTimeCache]:
        return self._cal.get(self.engine(name))

    # -- submit ----------------------------------------------------------------
    def submit(self, name: str, workload: List[Request],
               slo_class: Optional[str] = None,
               service_time_hint_s: Optional[float] = None) -> None:
        """Queue a workload on an endpoint.  ``slo_class`` stamps every
        request that has no explicit budget with the class's ``slo_ms``
        (TTFT) and/or relative ``deadline_s`` (batch-class completion
        deadline — what makes a request deferrable)."""
        if name not in self._endpoints:
            raise SpecError("endpoints",
                            f"no endpoint named {name!r}; "
                            f"known: {sorted(self._endpoints)}")
        for r in workload:
            if r.priority is not None and r.priority not in PRIORITY_LEVELS:
                raise SpecError(
                    f"workloads[{name}]",
                    f"request {r.rid} names unknown priority class "
                    f"{r.priority!r}; known: {sorted(PRIORITY_LEVELS)}")
        ep: EndpointSpec = self._endpoints[name]["spec"]
        if slo_class is not None:
            if slo_class not in ep.slo_classes:
                raise SpecError(
                    f"endpoints[{name}].slo_classes",
                    f"unknown SLO class {slo_class!r}; "
                    f"known: {sorted(ep.slo_classes)}")
            cls = ep.slo_classes[slo_class]

            # stamp COPIES: the caller's requests stay unowned, so the same
            # workload can be resubmitted under a different class
            def stamp(r: Request) -> Request:
                slo = cls.slo_ms if r.slo_ms is None else r.slo_ms
                ddl = r.deadline_s
                if ddl is None and cls.deadline_s is not None:
                    ddl = r.arrival_s + cls.deadline_s
                pr = cls.priority if r.priority is None else r.priority
                if slo is r.slo_ms and ddl is r.deadline_s \
                        and pr is r.priority:
                    return r
                return dataclasses.replace(r, slo_ms=slo, deadline_s=ddl,
                                           priority=pr)

            workload = [stamp(r) for r in workload]
        if service_time_hint_s is not None:
            self._hints[name] = service_time_hint_s
        self._workloads.setdefault(name, []).extend(workload)

    # -- run -------------------------------------------------------------------
    def _slo_floor_check(self, name: str) -> None:
        """An opted-into SLO budget tighter than the measured floor (batch-1
        prefill) can never be met: fail with the field path instead of
        silently missing it for the whole run.

        Only the hard, opt-in budgets are enforced — per-class ``slo_ms``
        and the spec-global ``ttft_budget_s``.  The endpoint-level
        ``ttft_slo_ms`` stays a soft routing/batching target (the legacy
        ``Deployment.ttft_slo_ms`` semantic), so adapter traffic on a slow
        host degrades instead of erroring.
        """
        cache = self._warm_cache(name)
        if cache is None:
            return
        floor_s = cache.floor_ttft_s()
        if floor_s is None:
            return
        ep: EndpointSpec = self._endpoints[name]["spec"]
        budgets: Dict[str, Optional[float]] = {}
        if self.spec.ttft_budget_s is not None:
            budgets["ttft_budget_s"] = self.spec.ttft_budget_s * 1e3
        for cls_name, cls in ep.slo_classes.items():
            budgets[f"endpoints[{name}].slo_classes[{cls_name}].slo_ms"] = \
                cls.slo_ms
        for path, ms in budgets.items():
            if ms is not None and ms / 1e3 < floor_s:
                raise SpecError(
                    path,
                    f"budget {ms}ms is tighter than the measured floor "
                    f"({floor_s * 1e3:.3f}ms batch-1 prefill): "
                    "no schedule can meet it")

    def _rate(self, workload: List[Request]) -> float:
        if len(workload) > 1:
            span = (max(r.arrival_s for r in workload)
                    - min(r.arrival_s for r in workload))
            return len(workload) / max(span, 1e-6)
        return 1.0

    def _fleet_endpoint(self, ep: EndpointSpec,
                        workload: List[Request]) -> FleetEndpoint:
        hint = self._hints.get(ep.name, ep.service_time_hint_s)
        ovh = td1.overhead(Containerization(ep.container))
        ttft_s = (ep.ttft_slo_ms / 1e3 if ep.ttft_slo_ms is not None
                  else self.spec.ttft_budget_s)
        # the policy's TTFT target honors the same chain: endpoint budget,
        # else the spec-global budget, else the library default
        policy_ttft_ms = (ttft_s * 1e3 if ttft_s is not None else 200.0)
        initial = ep.autoscale.initial_pool(self._rate(workload), hint)
        if ep.autoscale.enabled:
            lo, hi = ep.autoscale.min_replicas, ep.autoscale.max_replicas
        else:
            # a frozen endpoint keeps its initial pool even when it shares
            # the timeline (and hence the fleet autoscaler) with scaled ones
            lo = hi = initial
        disagg_rt = None
        if ep.disagg.enabled:
            # the phase pools batch with the endpoint's own (max_batch,
            # timeout) rhythm; the KV payload defaults to f(seq_len, arch)
            disagg_rt = DisaggRuntime.from_spec(
                ep.disagg, get_arch(ep.arch),
                prefill_policy_factory=lambda ep=ep: PrefillPhasePolicy(
                    ep.max_batch, ep.batch_timeout_ms),
                decode_policy_factory=lambda ep=ep: DecodePhasePolicy(
                    ep.max_batch, ep.batch_timeout_ms),
            )
        return FleetEndpoint(
            name=ep.name,
            zones=ep.zones,
            calendar=(TrafficCalendar(ep.autoscale.calendar)
                      if ep.autoscale.calendar else None),
            engine=self.engine(ep.name),
            policy_factory=lambda ep=ep: make_policy(
                ep.policy, max_batch=ep.max_batch,
                timeout_ms=ep.batch_timeout_ms, max_seq=ep.max_seq,
                ttft_slo_ms=policy_ttft_ms,
            ),
            min_replicas=lo,
            max_replicas=hi,
            initial_replicas=initial,
            service_time_hint_s=hint,
            ttft_slo_s=ttft_s,
            warm_cache=self._warm_cache(ep.name),
            use_step_cache=ep.step_cache,
            # TD1: a containerized replica pays the container's cold start on
            # top of the provisioning penalty, every scale-up
            cold_start_s=ep.autoscale.cold_start_s + ovh.cold_start_s,
            active_power_w=(ep.active_power_w if ep.active_power_w is not None
                            else self.spec.active_power_w),
            idle_power_w=(ep.idle_power_w if ep.idle_power_w is not None
                          else self.spec.idle_power_w),
            admission=self.spec.priority.build(),
            disagg=disagg_rt,
            carbon_bias=ep.autoscale.carbon_bias,
        )

    def _autoscaler(self) -> Optional[Autoscaler]:
        scaled = [ep for ep in self.spec.endpoints if ep.autoscale.enabled]
        if not scaled:
            return None
        a = scaled[0].autoscale
        return Autoscaler(window_s=a.window_s,
                          target_utilization=a.target_utilization,
                          cold_start_s=a.cold_start_s,
                          down_windows=a.down_windows)

    def run(self) -> ServingReport:
        """Serve every submitted workload on ONE shared virtual timeline and
        return the typed report.  Consumes the submitted workloads."""
        if self.spec is None:
            raise SpecError("spec", "deploy(spec) before run()")
        if not self._workloads:
            raise SpecError("workloads", "nothing submitted; submit() first")
        for name in self._workloads:
            self._slo_floor_check(name)
        injected = bool(self.spec.chaos.events)
        ts = self.spec.telemetry
        recorder = (TraceRecorder(spans=ts.spans, metrics=ts.metrics,
                                  max_events=ts.max_events)
                    if ts.enabled else None)
        monitor = None
        if self.spec.monitor.enabled and recorder is not None:
            slo_targets = {
                (ep.name, cname): (sc.slo_ms or 0.0, sc.deadline_s or 0.0)
                for ep in self.spec.endpoints
                for cname, sc in ep.slo_classes.items()}
            monitor = MonitorRuntime(self.spec.monitor, recorder,
                                     slo_targets)
        fleet = ReplicaFleet(
            router=self.spec.router,
            autoscaler=self._autoscaler(),
            carbon=self.spec.carbon.build(),
            carbon_zones={z: cs.build()
                          for z, cs in self.spec.carbon_zones.items()},
            deferral=self.spec.deferral,
            regions=(RegionTopology.from_specs(self.spec.regions)
                     if self.spec.regions else None),
            # no scripted events = the healthy world: no chaos/retry
            # runtimes at all, so the timeline stays byte-identical to a
            # pre-chaos spec
            chaos=(ChaosRuntime.from_spec(self.spec.chaos)
                   if injected else None),
            retry=(RetryRuntime.from_spec(self.spec.retry)
                   if injected else None),
            telemetry=recorder,
            monitor=monitor,
        )
        for name, wl in self._workloads.items():
            fleet.add_endpoint(
                self._fleet_endpoint(self._endpoints[name]["spec"], wl))
        workloads, self._workloads = self._workloads, {}
        result = fleet.run(workloads)

        xfer_by_rid: Dict[int, float] = {}
        if recorder is not None:
            # exact per-request energy/carbon from the merged fleet meter
            # (resident-weighted shares — never re-derived by the recorder)
            fm0 = result.fleet
            if fm0.meter is not None:
                recorder.attach_request_energy(dict(fm0.meter.per_request_j),
                                               dict(fm0.meter.per_request_g))
            # per-request transfer time: KV handoffs (disagg) plus
            # inter-region request/response transit legs
            for ev in fleet.handoff_events:
                xfer_by_rid[ev["rid"]] = (xfer_by_rid.get(ev["rid"], 0.0)
                                          + ev["xfer_s"])
            for ev in fleet.transit_events:
                xfer_by_rid[ev["rid"]] = (xfer_by_rid.get(ev["rid"], 0.0)
                                          + ev["xfer_s"])

        reports: Dict[str, EndpointReport] = {}
        fleet_overhead_j = 0.0
        fleet_overhead_g = 0.0
        for name, m in result.endpoints.items():
            ep: EndpointSpec = self._endpoints[name]["spec"]
            mult = td1.overhead(Containerization(ep.container)).energy_overhead
            rep = _endpoint_report(name, ep.decisions(), m, mult)
            if recorder is not None:
                # phase decomposition over the FINAL responses (post
                # transit shift, post disagg stitch), so the table agrees
                # with the latencies the report quotes
                rep.phase_breakdown = phase_breakdown(
                    m.responses, recorder.preempt_by_rid, xfer_by_rid)
            reports[name] = rep
            fleet_overhead_j += rep.j_container_overhead
            fleet_overhead_g += rep.gco2_container_overhead
        fm = result.fleet
        fleet_measured = fm.meter.total_j if fm.meter else fm.energy_j
        fleet_rep = _endpoint_report(
            "fleet", {"router": self.spec.router,
                      "endpoints": [e.name for e in self.spec.endpoints]},
            fm, 1.0)
        # the fleet bills the sum of its endpoints' container overheads
        # (joules and grams alike; gco2_total stays the measured meter sum)
        fleet_rep.j_container_overhead = fleet_overhead_j
        fleet_rep.j_billed = fleet_measured + fleet_overhead_j
        fleet_rep.j_per_request = fleet_rep.j_billed / max(
            fleet_rep.n_requests, 1)
        fleet_rep.j_per_token = fleet_rep.j_billed / max(
            fleet_rep.total_tokens, 1)
        fleet_rep.gco2_container_overhead = fleet_overhead_g
        fleet_rep.gco2_billed = fleet_rep.gco2_total + fleet_overhead_g
        fleet_rep.gco2_per_request = fleet_rep.gco2_billed / max(
            fleet_rep.n_requests, 1)
        fleet_rep.gco2_per_token = fleet_rep.gco2_billed / max(
            fleet_rep.total_tokens, 1)
        if recorder is not None:
            fleet_rep.phase_breakdown = phase_breakdown(
                fm.responses, recorder.preempt_by_rid, xfer_by_rid)
        alerts: List[dict] = []
        incidents: List[dict] = []
        budget_remaining: Dict[str, dict] = {}
        if monitor is not None:
            # drain the stream tail (segments billed after the last fleet
            # boundary) and close any open incident; under REPRO_SANITIZE=1
            # this also re-proves R6 (read-only tick + alert determinism)
            monitor.finalize()
            alerts = list(monitor.alerts)
            incidents = list(monitor.incidents)
            budget_remaining = monitor.budget_remaining()
        return ServingReport(spec=self.spec, endpoints=reports,
                             fleet=fleet_rep, result=result,
                             telemetry=recorder, monitor=monitor,
                             alerts=alerts, incidents=incidents,
                             budget_remaining=budget_remaining)

    # -- one-shot convenience --------------------------------------------------
    def serve(self, workloads: Mapping[str, List[Request]]) -> ServingReport:
        """submit() every workload, then run()."""
        for name, wl in workloads.items():
            self.submit(name, wl)
        return self.run()

    def declared_workloads(self) -> Dict[str, List[Request]]:
        """Generate every endpoint's declared :class:`WorkloadSpec` stream
        (vocab taken from the endpoint's arch) — the spec IS the workload."""
        if self.spec is None:
            raise SpecError("spec", "deploy(spec) before declared_workloads()")
        out: Dict[str, List[Request]] = {}
        for ep in self.spec.endpoints:
            if ep.workload is not None:
                out[ep.name] = ep.workload.build(
                    get_arch(ep.arch).vocab_size)
        if not out:
            raise SpecError("endpoints[*].workload",
                            "no endpoint declares a workload spec")
        return out

    def run_declared(self) -> ServingReport:
        """serve() exactly the workloads the spec declares."""
        return self.serve(self.declared_workloads())
