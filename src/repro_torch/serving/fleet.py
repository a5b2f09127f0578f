"""Virtual-time replica fleet: shared-timeline routing + windowed autoscaling.

The paper's SI4 trade-off — a managed endpoint is "ready to use, but you pay
for the abstraction" in provisioned-but-idle replicas — only becomes an
*architectural* decision once replicas, routing and autoscaling are first
class.  ``ReplicaFleet`` runs N :class:`~repro_torch.serving.core.SchedulerCore`
instances (one per replica: engine + its own policy instance + its own
step-time cache + its own :class:`~repro_torch.energy.meter.EnergyMeter`) on one
shared virtual timeline, across any number of named endpoints:

  * a pluggable :class:`RoutingPolicy` decides per-arrival placement —
    ``round_robin``, ``least_loaded`` (join-shortest-queue),
    ``warmest`` (step-cache affinity: reuse a replica that has already
    measured this shape) and ``greenest`` (minimize the estimated *marginal*
    J/token of adding this request, which consolidates load so batches
    amortize and spare replicas can be scaled away);
  * every router first prefers replicas that can still honor an arrival's
    per-request :attr:`~repro_torch.serving.request.Request.slo_ms` budget;
  * a windowed :class:`Autoscaler` re-sizes each endpoint's pool every
    ``window_s`` of virtual time from the observed arrival rate and the
    *measured* per-request service time — scaled-down replicas drain their
    queue and then stop accruing idle energy; scaled-up replicas pay a
    cold-start penalty (provisioned-and-drawing but not yet serving).

The fleet also trades **when**, not just where (the carbon /
workload subsystem):

  * every replica lives in a **carbon zone** (``EndpointSpec.zones`` cycles
    an endpoint's replicas across zones, each zone a
    :class:`~repro_torch.carbon.signal.CarbonSignal`); its meter bills grams at
    the zone's intensity at the drawing instant, and the ``carbon_aware``
    router minimizes marginal **gCO2/token** — which differs from
    ``greenest`` (marginal J/token) exactly when the candidate replicas sit
    in zones of different current intensity;
  * deadline-carrying batch-class requests are **deferred** by a
    :class:`~repro_torch.carbon.shift.TemporalShifter`: held at the fleet edge for
    a planned low-carbon window and released (re-stamped to their release
    instant) with enough slack to finish before their deadline;
  * an endpoint with a :class:`~repro_torch.workload.calendar.TrafficCalendar`
    is **pre-warmed**: the autoscaler sizes for the forecast peak across
    its cold-start horizon, so replicas are ready when a predicted ramp
    arrives instead of cold-starting inside the crowd.

The fleet also owns the admission layer's *where-by-phase*
decision (the :mod:`repro_torch.serving.admission` subsystem):

  * an endpoint with a :class:`~repro_torch.serving.admission.disagg.DisaggRuntime`
    is **disaggregated**: its pool splits into fixed-size prefill and decode
    pools (``name/p*`` / ``name/d*`` replicas), a request's prompt phase is
    routed among prefill replicas, and each completed prefill mints a
    *decode-leg* arrival for the decode pool after a modeled **KV handoff**
    (``kv_bytes(seq_len)`` across the declared link, billed as ``xfer``
    seconds/joules/grams on the sending replica's meter); the final response
    stitches the two legs back together (arrival + TTFT from the prefill
    leg, completion from the decode leg);
  * endpoints carrying an :class:`~repro_torch.serving.admission.priority.
    AdmissionControl` serve backlogged queues most-urgent-first, and an
    interactive arrival may preempt an in-flight lower-priority decode batch
    *inside* its replica (pause/resume billed to the ``preempt`` bucket);
  * ``carbon_bias`` shrinks an endpoint's pool harder when the grid's
    current intensity sits above its trailing window mean — the carbon-aware
    sibling of the utilization target (both signals share the virtual
    clock).

The fleet is geo-distributed and failure-aware (the
:mod:`repro_torch.serving.regions` / :mod:`repro_torch.serving.chaos` subsystems):

  * a zone may be a first-class **region** (:class:`~repro_torch.serving.regions.
    RegionSpec`): serving a request whose ``origin`` region differs from its
    replica's pays request- and response-leg transit on the inter-region
    link (delaying arrival and client-observed tokens, billed through the
    ``xfer`` bucket at the link power), and the ``follow_sun`` router chases
    the currently-cleanest region across offset diurnal carbon signals;
  * a seeded :class:`~repro_torch.serving.chaos.ChaosSpec` script injects failures
    between scheduling windows — a **crash** loses the victim's in-flight
    work (reclassified into the meter's ``lost`` bucket: billed joules and
    grams that never produced a delivered response), an **outage** crashes a
    whole region and excludes it from routing for its window, a **brownout**
    clamps replica power (``SchedulerCore.power_caps``) so steps stretch;
    chaos code never writes ``core.clock`` — victims are *drained to* the
    event instant (the clock-causality contract, docs/INVARIANTS.md R4);
  * a :class:`~repro_torch.serving.chaos.RetrySpec` declares the recovery tactics:
    crashed/shed work re-enters after bounded backoff (exhausted work is a
    recorded drop), ``failover`` lets retries and placement leave the
    request's origin region, and ``degrade`` sheds batch-class arrivals at
    the front door while any chaos window is active — so degraded-mode runs
    report per-class availability, drops and sheds alongside the energy.

Simulation semantics: arrivals are processed in windows.  All arrivals of a
window are routed (and offered to their replica's core) before any core is
drained, so intra-window batching is exact; each core is then drained only up
to ``window_end - policy.admission_lookahead_s`` so a batch whose admission
window is still open waits for the next routing round.  Everything is
deterministic given the workload, and energy is conserved: the merged fleet
meter decomposes exactly into its per-replica contributions — in joules AND
in grams (tested).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.carbon.shift import DeferralSpec, TemporalShifter
from repro_torch.carbon.signal import CarbonSignal, ConstantSignal, J_PER_KWH
from repro_torch.energy.hw import HOST_CPU_IDLE_POWER_W, HOST_CPU_POWER_W
from repro_torch.energy.meter import estimate_j_per_token
from repro_torch.energy.sanitize import new_meter
from repro_torch.serving.admission.disagg import DisaggRuntime
from repro_torch.serving.admission.priority import (
    AdmissionControl,
    DEFAULT_PRIORITY,
    PRIORITY_LEVELS,
    priority_level,
)
from repro_torch.serving.chaos import ChaosRuntime, RetryRuntime
from repro_torch.serving.core import SchedulerCore, SchedulingPolicy
from repro_torch.serving.regions import RegionTopology
from repro_torch.serving.request import Request, Response, ServingMetrics
from repro_torch.serving.stepcache import StepTimeCache, shape_bucket
from repro_torch.workload.calendar import TrafficCalendar


# -- replicas ------------------------------------------------------------------


class Replica:
    """One scheduler core with a fleet lifecycle.

    States: ``starting`` (cold start: provisioned and drawing idle power but
    not yet serving) -> ``serving`` -> ``draining`` (router excludes it; it
    finishes queued work) -> ``stopped`` (deprovisioned: no further idle
    draw — this is the whole point of scaling down).
    """

    def __init__(self, name: str, endpoint: str, core: SchedulerCore,
                 created_s: float, ready_s: float, zone: str = "",
                 role: str = ""):
        self.name = name
        self.endpoint = endpoint
        self.core = core
        self.zone = zone                   # carbon zone (gram billing)
        self.role = role                   # "" unified | "prefill" | "decode"
        self.created_s = created_s
        self.ready_s = ready_s
        self.cold_start = ready_s > created_s
        self.draining = False
        self.drain_mark_s = 0.0            # when the scale-down was decided
        self.stopped_s: Optional[float] = None
        self.offered = 0
        core.begin()
        # cold start: the replica draws idle power while it provisions; its
        # clock starts where it becomes able to serve
        core.provision(created_s, ready_s)

    @property
    def backlog(self) -> int:
        """Offered-but-unretired requests (queued + in flight)."""
        return self.offered - len(self.core.responses)

    def serving(self, t: float) -> bool:
        """Can the router hand this replica an arrival at time ``t``?"""
        return self.stopped_s is None and not self.draining \
            and self.ready_s <= t

    def eta_wait_s(self, t: float, svc_s: float) -> float:
        """Estimated queueing delay for work arriving at ``t``: how far the
        replica's clock lags behind, plus its backlog at the measured
        per-request service time."""
        return max(self.core.clock - t, 0.0) + self.backlog * svc_s

    def uptime_end_s(self) -> float:
        return self.stopped_s if self.stopped_s is not None \
            else self.core.clock


# -- routing -------------------------------------------------------------------


class RoutingPolicy:
    """Per-arrival placement among an endpoint's serving replicas.

    ``choose`` sees the SLO-filtered candidate list (never empty) plus the
    fleet for load/energy estimates; it must be deterministic.
    """

    name = "abstract"

    def choose(self, fleet: "ReplicaFleet", candidates: List[Replica],
               req: Request, now: float) -> Replica:
        raise NotImplementedError


class RoundRobinRouter(RoutingPolicy):
    name = "round_robin"

    def __init__(self):
        self._next: Dict[str, int] = {}

    def choose(self, fleet, candidates, req, now):
        i = self._next.get(req_endpoint(candidates), 0)
        rep = candidates[i % len(candidates)]
        self._next[rep.endpoint] = i + 1
        return rep


class LeastLoadedRouter(RoutingPolicy):
    """Join-shortest-queue by offered-but-unretired backlog."""

    name = "least_loaded"

    def choose(self, fleet, candidates, req, now):
        return min(candidates, key=lambda r: (r.backlog, r.name))


class WarmestRouter(RoutingPolicy):
    """Step-cache affinity: prefer a replica that has already measured this
    arrival's execution shape, so replays stay replays (and on real hardware
    the compiled executable / weights stay hot)."""

    name = "warmest"

    def choose(self, fleet, candidates, req, now):
        sb = shape_bucket(len(req.prompt))
        return min(candidates,
                   key=lambda r: (0 if _cache_warm(r, sb) else 1,
                                  r.backlog, r.name))


class GreenestRouter(RoutingPolicy):
    """Route by estimated *marginal* J/token of placing the request here.

    Joining a replica with a backlog rides an amortized batch (lower
    marginal energy); waking an empty replica pays a whole dispatch alone.
    Minimizing marginal J/token therefore consolidates load onto few
    replicas, which both fattens batches and leaves the rest of the pool
    idle for the autoscaler to reclaim.  Ties (e.g. saturated estimates)
    fall back to shortest queue so the policy spreads once a replica's
    batch budget is exhausted.
    """

    name = "greenest"

    def choose(self, fleet, candidates, req, now):
        def marginal(rep: Replica) -> Tuple:
            mj = fleet.marginal_j_per_token(rep, req)
            if mj is None:             # no measurement yet: least-loaded
                return (1, 0.0, rep.backlog, rep.name)
            return (0, mj, rep.backlog, rep.name)

        return min(candidates, key=marginal)


class CarbonAwareRouter(RoutingPolicy):
    """Route by estimated marginal **gCO2/token**: the greenest-J marginal
    cost multiplied by the candidate's zone intensity *right now*.

    With every replica in one zone this degenerates to :class:`GreenestRouter`
    (intensity is a common factor); with replicas spread across zones it
    diverges exactly where the paper's placement discussion wants it to — a
    slightly less batch-efficient replica on a solar-valley grid beats a
    more efficient one on a coal peak.  Replicas with no measurement yet
    fall back to (lowest-intensity, least-loaded).
    """

    name = "carbon_aware"

    def choose(self, fleet, candidates, req, now):
        def marginal(rep: Replica) -> Tuple:
            mg = fleet.marginal_g_per_token(rep, req, now)
            if mg is None:             # no measurement yet
                return (1, fleet.zone_intensity(rep.zone, now),
                        rep.backlog, rep.name)
            return (0, mg, rep.backlog, rep.name)

        return min(candidates, key=marginal)


class FollowSunRouter(RoutingPolicy):
    """Chase the sun: place each arrival in the region whose grid is
    cleanest *right now*, then shortest queue.

    With per-region diurnal carbon signals at offset phases
    (``RegionSpec.carbon.phase_s``) this is the classic follow-the-sun
    placement — traffic migrates around the globe as each region's solar
    valley comes and goes.  Unlike :class:`CarbonAwareRouter` it needs no
    step-time measurement (intensity is a pure function of the virtual
    clock), so it works from the very first arrival; the price is that it
    ignores batch-amortization efficiency and cross-region transit."""

    name = "follow_sun"

    def choose(self, fleet, candidates, req, now):
        return min(candidates,
                   key=lambda r: (fleet.zone_intensity(r.zone, now),
                                  r.backlog, r.name))


def req_endpoint(candidates: List[Replica]) -> str:
    return candidates[0].endpoint


def _cache_warm(rep: Replica, sb: int) -> bool:
    cache = rep.core.step_cache
    return cache is not None and cache.has_shape(sb)


ROUTERS: Dict[str, Callable[[], RoutingPolicy]] = {
    "round_robin": RoundRobinRouter,
    "least_loaded": LeastLoadedRouter,
    "warmest": WarmestRouter,
    "greenest": GreenestRouter,
    "carbon_aware": CarbonAwareRouter,
    "follow_sun": FollowSunRouter,
}


def make_router(name: str) -> RoutingPolicy:
    if isinstance(name, RoutingPolicy):
        return name
    try:
        return ROUTERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown router {name!r}; known: {sorted(ROUTERS)}") from None


# -- autoscaling ---------------------------------------------------------------


@dataclasses.dataclass
class Autoscaler:
    """Windowed M/M/c-style pool sizing from *observed* load.

    Every ``window_s`` of virtual time, per endpoint: desired replicas =
    ceil(arrival_rate * measured_service_time / target_utilization), clamped
    to [min_replicas, max_replicas].  Scale-ups are immediate but pay
    ``cold_start_s`` before serving; scale-downs drain and stop (no more
    idle draw) and are hysteretic — the pool shrinks only after
    ``down_windows`` consecutive low windows, so measurement noise does not
    thrash replicas through repeated stop/cold-start cycles.
    """

    window_s: float = 1.0
    target_utilization: float = 0.7
    cold_start_s: float = 0.25
    down_windows: int = 2

    def desired(self, arrivals: int, window_s: float, svc_s: float,
                min_replicas: int, max_replicas: int,
                forecast_rate_per_s: float = 0.0) -> int:
        """Pool size for the observed window rate — lifted to the calendar
        forecast when one predicts a higher rate inside the cold-start
        horizon (the pre-warm path: replicas come up *before* the ramp)."""
        rate = max(arrivals / max(window_s, 1e-9), forecast_rate_per_s)
        need = math.ceil(rate * svc_s / max(self.target_utilization, 1e-9))
        return int(max(min_replicas, min(max_replicas, max(need, 0))))


# -- the fleet -----------------------------------------------------------------


@dataclasses.dataclass
class EndpointSpec:
    """Everything the fleet needs to mint replicas for one endpoint."""

    name: str
    engine: object
    policy_factory: Callable[[], SchedulingPolicy]
    min_replicas: int = 1
    max_replicas: int = 4
    initial_replicas: int = 1
    service_time_hint_s: float = 0.1   # until a measurement exists
    # endpoint-level TTFT budget for routing: consolidation-minded routers
    # (greenest/warmest) pack replicas only while the estimated queueing
    # delay still honors it; per-request Request.slo_ms overrides it
    ttft_slo_s: Optional[float] = None
    warm_cache: Optional[StepTimeCache] = None  # seeds replica caches
    # False: replicas run with NO step cache at all — every dispatch executes
    # the engine (the SI3 server's uncached registration path)
    use_step_cache: bool = True
    # per-endpoint cold-start override (e.g. containerized endpoints pay the
    # container's startup on top); None defers to the fleet Autoscaler's
    cold_start_s: Optional[float] = None
    active_power_w: float = HOST_CPU_POWER_W
    idle_power_w: float = HOST_CPU_IDLE_POWER_W
    # carbon zones this endpoint's replicas cycle through (replica i sits in
    # zones[i % len]); () = every replica in the fleet's default zone
    zones: Tuple[str, ...] = ()
    # expected-traffic forecast: the autoscaler pre-warms for the calendar's
    # peak rate across its cold-start horizon instead of reacting late
    calendar: Optional[TrafficCalendar] = None
    # admission layer: priority ladder + preemption contract shared
    # by every core of this endpoint; None = FIFO, never preempt
    admission: Optional[AdmissionControl] = None
    # prefill/decode disaggregation: fixed prefill+decode pools with a
    # modeled KV handoff; None = one unified pool running both phases
    disagg: Optional[DisaggRuntime] = None
    # carbon-biased scale-down: shrink the pool harder when the default
    # grid's intensity runs above its trailing window mean (0 = off)
    carbon_bias: float = 0.0


@dataclasses.dataclass
class FleetResult:
    endpoints: Dict[str, ServingMetrics]
    fleet: ServingMetrics


class ReplicaFleet:
    """N scheduler cores, one shared virtual timeline, one energy story."""

    def __init__(self, router: str = "round_robin",
                 autoscaler: Optional[Autoscaler] = None,
                 carbon: Optional[CarbonSignal] = None,
                 carbon_zones: Optional[Dict[str, CarbonSignal]] = None,
                 deferral: Optional[DeferralSpec] = None,
                 regions: Optional[RegionTopology] = None,
                 chaos: Optional[ChaosRuntime] = None,
                 retry: Optional[RetryRuntime] = None,
                 telemetry=None, monitor=None):
        self.router = make_router(router)
        # trace recorder: a pure observer — replica sinks are
        # installed on every core at spawn, fleet-level instants and gauges
        # are emitted below.  None = untraced (the default fast path).
        self.telemetry = telemetry
        # green-SRE monitor: a read-only consumer of the recorder,
        # ticked at every window boundary right after the gauges sample (so
        # it scores exactly what an operator could see at that instant).
        # None = unmonitored; requires a recorder to consume.
        self.monitor = monitor
        self.autoscaler = autoscaler
        # "" is the default zone: the fleet-wide grid signal
        self.carbon = carbon if carbon is not None else ConstantSignal()
        self.carbon_zones = dict(carbon_zones or {})
        # geo-distribution + resilience: region signals join the zone
        # map (an explicit carbon_zones entry wins), the chaos script and
        # retry tactics drive the failure/recovery paths below
        self.regions = regions
        self.chaos = chaos
        self.retry = retry
        if regions is not None:
            for rname, sig in regions.signals.items():
                self.carbon_zones.setdefault(rname, sig)
        self.shifter: Optional[TemporalShifter] = None
        if deferral is not None and deferral.enabled:
            # temporal shifting plans against the default-zone grid (the
            # decision is WHEN to serve; the router still decides where)
            self.shifter = TemporalShifter(self.carbon, deferral)
        self.specs: Dict[str, EndpointSpec] = {}
        self.replicas: List[Replica] = []
        self._counter: Dict[Tuple[str, str], int] = {}  # (endpoint, role)
        self._svc_obs: Dict[str, Tuple[float, int]] = {}  # (active_s, n_resp)
        self._down_streak: Dict[str, int] = {}  # consecutive low windows
        self.scale_events: List[dict] = []
        # [(t, {endpoint: serving replicas})] — sampled at window boundaries
        self.replica_timeline: List[Tuple[float, Dict[str, int]]] = []
        self.cold_starts = 0
        # disaggregation state: originals awaiting their decode leg, the
        # handoff queue (ready_s, rid, endpoint, decode-leg request), the
        # per-prefill-replica completion cursor, and the handoff log
        self._disagg_orig: Dict[int, Request] = {}
        self._handoff: List[Tuple[float, int, str, Request]] = []
        self._prefill_seen: Dict[str, int] = {}
        self.handoff_events: List[dict] = []
        # trailing default-grid intensity samples for carbon-biased scaling
        self._intensity_hist: deque = deque(maxlen=64)
        # chaos/retry state: every routed request by rid (so a crash can
        # recover the original Request of an in-flight casualty), the retry
        # re-entry heap (ready_s, rid, endpoint, request), per-endpoint
        # per-class submitted/drop/shed counters, and the applied-event log
        self._req_by_rid: Dict[int, Tuple[str, Request]] = {}
        self._retry_q: List[Tuple[float, int, str, Request]] = []
        self._submitted: Dict[str, Dict[str, int]] = {}
        self._drops: Dict[str, Dict[str, int]] = {}
        self._shed: Dict[str, Dict[str, int]] = {}
        self._retry_minted: Dict[str, int] = {}
        self.chaos_log: List[dict] = []
        self.transit_events: List[dict] = []

    # -- carbon zones ----------------------------------------------------------
    def zone_signal(self, zone: str) -> CarbonSignal:
        return self.carbon_zones.get(zone, self.carbon)

    def zone_intensity(self, zone: str, t: float) -> float:
        return self.zone_signal(zone).intensity(t)

    # -- pool management -------------------------------------------------------
    def add_endpoint(self, spec: EndpointSpec) -> None:
        if spec.name in self.specs:
            raise ValueError(f"endpoint {spec.name!r} already registered")
        self.specs[spec.name] = spec
        if spec.disagg is not None:
            # disaggregated pools are fixed-size: the phase split IS the
            # provisioning decision, the windowed autoscaler skips them
            for _ in range(spec.disagg.prefill_replicas):
                self._spawn(spec, created_s=0.0, ready_s=0.0, role="prefill")
            for _ in range(spec.disagg.decode_replicas):
                self._spawn(spec, created_s=0.0, ready_s=0.0, role="decode")
            return
        for _ in range(max(spec.initial_replicas, spec.min_replicas)):
            self._spawn(spec, created_s=0.0, ready_s=0.0)

    def _spawn(self, spec: EndpointSpec, created_s: float,
               ready_s: float, role: str = "",
               zone: Optional[str] = None) -> Replica:
        i = self._counter.get((spec.name, role), 0)
        self._counter[(spec.name, role)] = i + 1
        cache: Optional[StepTimeCache] = None
        if spec.use_step_cache:
            cache = StepTimeCache()
            if spec.warm_cache is not None:
                cache.seed_from(spec.warm_cache)
        if zone is None:
            zone = spec.zones[i % len(spec.zones)] if spec.zones else ""
        if role == "prefill":
            factory, prefix = spec.disagg.prefill_policy_factory, "p"
        elif role == "decode":
            factory, prefix = spec.disagg.decode_policy_factory, "d"
        else:
            factory, prefix = spec.policy_factory, "r"
        core = SchedulerCore(spec.engine, factory(),
                             step_cache=cache,
                             active_power_w=spec.active_power_w,
                             idle_power_w=spec.idle_power_w,
                             carbon=self.zone_signal(zone),
                             admission=spec.admission)
        if self.chaos is not None:
            # brownout windows are static spec data: install the zone's
            # power-cap schedule once, at provisioning time
            core.power_caps = self.chaos.caps_for(zone)
        name = f"{spec.name}/{prefix}{i}"
        if self.telemetry is not None:
            # must land before Replica(): its __init__ calls core.begin(),
            # and the provisioning idle billed there has to be observed
            core.tracer = self.telemetry.sink_for(spec.name, name)
        rep = Replica(name, spec.name, core, created_s,
                      ready_s, zone=zone, role=role)
        if rep.cold_start:
            self.cold_starts += 1
        self.replicas.append(rep)
        return rep

    def endpoint_replicas(self, name: str,
                          role: Optional[str] = None) -> List[Replica]:
        return [r for r in self.replicas if r.endpoint == name
                and (role is None or r.role == role)]

    def cold_start_s(self, spec: EndpointSpec) -> float:
        """Scale-up provisioning penalty for this endpoint: the spec's own
        override (e.g. container startup included), else the autoscaler's."""
        if spec.cold_start_s is not None:
            return spec.cold_start_s
        return self.autoscaler.cold_start_s if self.autoscaler else 0.0

    # -- estimates shared by routers / autoscaler ------------------------------
    def service_time_s(self, name: str) -> float:
        active_s, n = self._svc_obs.get(name, (0.0, 0))
        if n > 0:
            return active_s / n
        return self.specs[name].service_time_hint_s

    def _estimate(self, rep: Replica, req: Request,
                  batch: int) -> Optional[Tuple[float, float]]:
        cache = rep.core.step_cache
        if cache is None:
            return None
        sb = shape_bucket(len(req.prompt))
        return cache.estimate_generate(batch, sb, req.max_new_tokens)

    @staticmethod
    def _batch_cap(rep: Replica) -> int:
        """The batch a joining request could amortize over: the policy's
        batch budget (realtime never batches, so its cap is 1)."""
        policy = rep.core.policy
        return getattr(policy, "max_batch", None) \
            or getattr(policy, "num_slots", None) or 1

    def marginal_j_per_token(self, rep: Replica,
                             req: Request) -> Optional[float]:
        b = max(1, min(rep.backlog + 1, self._batch_cap(rep)))
        est = self._estimate(rep, req, b)
        if est is None:
            return None
        prefill_s, decode_s = est
        return estimate_j_per_token(rep.core.active_power_w, prefill_s,
                                    decode_s, b, req.max_new_tokens)

    def marginal_g_per_token(self, rep: Replica, req: Request,
                             now: float) -> Optional[float]:
        """Marginal gCO2/token of placing ``req`` on ``rep`` right now: the
        marginal joule cost priced at the replica zone's current intensity."""
        mj = self.marginal_j_per_token(rep, req)
        if mj is None:
            return None
        return mj * self.zone_intensity(rep.zone, now) / J_PER_KWH

    def _slo_ok(self, rep: Replica, req: Request, now: float) -> bool:
        budget_s = req.slo_ms / 1e3 if req.slo_ms is not None \
            else self.specs[rep.endpoint].ttft_slo_s
        if budget_s is None:
            return True
        est = self._estimate(rep, req,
                             max(1, min(rep.backlog + 1,
                                        self._batch_cap(rep))))
        prefill_s = est[0] if est is not None else 0.0
        wait = rep.eta_wait_s(now, self.service_time_s(rep.endpoint))
        return wait + prefill_s <= budget_s

    # -- routing ---------------------------------------------------------------
    def _routable_zone(self, zone: str, req: Request, t: float) -> bool:
        """May ``req`` be placed in ``zone`` at ``t``?  False inside the
        zone's outage window, and — with cross-region failover disabled —
        anywhere outside the request's own origin region."""
        if self.chaos is not None and self.chaos.region_down(zone, t):
            return False
        if (self.retry is not None and not self.retry.failover
                and req.origin and zone != req.origin):
            return False
        return True

    def _spawn_zone(self, spec: EndpointSpec, req: Request,
                    t: float) -> Optional[str]:
        """Zone for a scale-from-zero spawn; ``None`` = the default cycling
        (also the fallback when every allowed zone is down — the safety net
        for legs routed outside the :meth:`_admit` front door)."""
        if self.chaos is None:
            return None
        zones = list(spec.zones) if spec.zones else [""]
        ok = [z for z in zones if self._routable_zone(z, req, t)]
        return ok[0] if ok else None

    def route(self, name: str, req: Request) -> Replica:
        t = req.arrival_s
        spec = self.specs[name]
        role: Optional[str] = None
        if spec.disagg is not None:
            # phase-aware routing: the prompt phase goes to the prefill
            # pool; the decode leg (minted by the KV handoff) to the decode
            # pool.  The original is parked until its handoff fires.
            role = "decode" if req.phase == "decode" else "prefill"
            if req.phase != "decode":
                self._disagg_orig[req.rid] = req
        pool = [r for r in self.endpoint_replicas(name, role)
                if r.serving(t) and self._routable_zone(r.zone, req, t)]
        if not pool:
            # every serving replica is still cold: queue on the one that
            # becomes ready first (arrival waits out the cold start)
            pool = [r for r in self.endpoint_replicas(name, role)
                    if r.stopped_s is None and not r.draining
                    and self._routable_zone(r.zone, req, t)]
            pool.sort(key=lambda r: (r.ready_s, r.name))
            pool = pool[:1]
        if not pool:
            # prefer reviving a draining replica — still provisioned and
            # warm, so cancelling its drain is free — before cold-starting
            draining = [r for r in self.endpoint_replicas(name, role)
                        if r.stopped_s is None and r.draining
                        and self._routable_zone(r.zone, req, t)]
            if draining:
                rep = min(draining, key=lambda r: (r.backlog, r.name))
                rep.draining = False
                pool = [rep]
        if not pool:
            # scale-from-zero (min_replicas=0 and the pool was reclaimed):
            # the arrival itself provisions a replica and waits out its
            # cold start — the serverless corner of the SI4 trade-off
            cold = self.cold_start_s(spec)
            pool = [self._spawn(spec, created_s=t, ready_s=t + cold,
                                role=role or "",
                                zone=self._spawn_zone(spec, req, t))]
        ok = [r for r in pool if self._slo_ok(r, req, t)]
        rep = self.router.choose(self, ok or pool, req, t)
        if (self.regions is not None and req.origin
                and req.origin != rep.zone and req.phase != "decode"):
            # cross-region request leg: the prompt crosses the inter-region
            # link before the replica can see it — transit delays the
            # effective arrival and is billed as xfer at the *sending*
            # (origin) region's link power.  Decode legs are exempt: their
            # KV handoff already paid the intra-fleet move.
            xfer_s = self.regions.transit_s(req.origin, rep.zone,
                                            8 * len(req.prompt))
            if xfer_s > 0.0:
                rep.core.meter.record_xfer(
                    xfer_s, self.regions.link_power_w(req.origin), t_s=t)
                req = dataclasses.replace(req, arrival_s=t + xfer_s)
                self.transit_events.append({
                    "rid": req.rid, "endpoint": name, "leg": "request",
                    "from": req.origin, "to": rep.zone, "xfer_s": xfer_s})
                if self.telemetry is not None:
                    self.telemetry.instant(
                        "transit", t,
                        {"rid": req.rid, "leg": "request",
                         "from": req.origin, "to": rep.zone,
                         "xfer_s": xfer_s}, sink=rep.core.tracer)
        if (self.telemetry is not None and req.retries > 0
                and req.phase != "decode"):
            self.telemetry.instant(
                "failover" if (req.origin and rep.zone != req.origin)
                else "retry_route", req.arrival_s,
                {"rid": req.rid, "attempt": req.retries, "to": rep.name},
                sink=rep.core.tracer)
        rep.offered += 1
        rep.core.offer(req)
        self._req_by_rid[req.rid] = (name, req)
        return rep

    # -- KV handoffs (prefill pool -> decode pool) -----------------------------
    def _collect_handoffs(self) -> None:
        """Turn newly completed prefills into decode-pool arrivals.

        Each completed prefill leg ships its KV cache across the endpoint's
        link: the transfer time (latency + kv_bytes/bandwidth) delays the
        decode leg's arrival, and its seconds/joules/grams are billed to the
        *sending* replica's meter under the ``xfer`` bucket (the link draws
        power in parallel with the replica's own timeline)."""
        for rep in self.replicas:
            if rep.role != "prefill":
                continue
            seen = self._prefill_seen.get(rep.name, 0)
            fresh = rep.core.responses[seen:]
            self._prefill_seen[rep.name] = seen + len(fresh)
            d = self.specs[rep.endpoint].disagg
            for resp in fresh:
                req = self._disagg_orig.pop(resp.rid, None)
                if req is None:
                    continue
                if req.max_new_tokens <= 1:
                    continue           # prefill produced the only token
                kv = d.kv_bytes(len(req.prompt))
                xfer_s = d.transfer_s(kv)
                rep.core.meter.record_xfer(xfer_s, d.power_w,
                                           t_s=resp.done_s)
                if self.telemetry is not None:
                    self.telemetry.instant(
                        "kv_handoff", resp.done_s,
                        {"rid": req.rid, "kv_bytes": kv, "xfer_s": xfer_s},
                        sink=rep.core.tracer)
                ready = resp.done_s + xfer_s
                leg = dataclasses.replace(req, arrival_s=ready,
                                          phase="decode", kv_bytes=kv)
                heapq.heappush(self._handoff,
                               (ready, req.rid, rep.endpoint, leg))
                self.handoff_events.append({
                    "rid": req.rid, "endpoint": rep.endpoint,
                    "from": rep.name, "kv_bytes": kv,
                    "xfer_s": xfer_s, "ready_s": ready,
                })

    def _release_handoffs(self, before_s: float) -> int:
        """Route every decode leg whose KV landed before ``before_s``."""
        n = 0
        while self._handoff and self._handoff[0][0] < before_s:
            _, _, name, leg = heapq.heappop(self._handoff)
            self.route(name, leg)
            n += 1
        return n

    # -- chaos: failure injection + recovery tactics ---------------------------
    @staticmethod
    def _bump(table: Dict[str, Dict[str, int]], name: str,
              req: Request) -> None:
        cls = req.priority or DEFAULT_PRIORITY
        per = table.setdefault(name, {})
        per[cls] = per.get(cls, 0) + 1

    def _shed_now(self, req: Request, t: float) -> bool:
        """Graceful degradation: while any chaos window is active, shed
        batch-rung work at the front door (zero energy, recorded shed) so
        the surviving capacity serves the interactive classes."""
        return (self.retry is not None and self.retry.degrade
                and self.chaos is not None and self.chaos.degraded(t)
                and priority_level(req.priority) >= PRIORITY_LEVELS["batch"])

    def _placeable(self, name: str, req: Request, t: float) -> bool:
        """Does any zone this endpoint may serve ``req`` from have power?"""
        if self.chaos is None:
            return True
        spec = self.specs[name]
        zones = list(spec.zones) if spec.zones else [""]
        return any(self._routable_zone(z, req, t) for z in zones)

    def _admit(self, name: str, req: Request) -> bool:
        """Front door for arrivals, deferral releases and retry re-entries:
        apply degradation shedding, then either place the request or burn a
        retry attempt (origin region dark and failover off, or every
        allowed region down).  Returns True iff the request was routed."""
        t = req.arrival_s
        if self._shed_now(req, t):
            self._bump(self._shed, name, req)
            if self.telemetry is not None:
                self.telemetry.instant("shed", t, {
                    "rid": req.rid, "endpoint": name,
                    "class": req.priority or DEFAULT_PRIORITY})
            return False
        if not self._placeable(name, req, t):
            self._retry_or_drop(name, req, t)
            return False
        self.route(name, req)
        return True

    def _retry_or_drop(self, name: str, req: Request, t_fail: float) -> None:
        """Recovery tactic for one failed request: re-enter after bounded
        exponential backoff while the RetrySpec allows, else record the
        drop (the client saw an error — availability pays for it)."""
        if self.retry is not None and self.retry.allows(req.retries):
            attempt = req.retries + 1
            ready = max(t_fail, req.arrival_s) + self.retry.backoff(attempt)
            leg = dataclasses.replace(req, retries=attempt, arrival_s=ready)
            heapq.heappush(self._retry_q, (ready, req.rid, name, leg))
            self._retry_minted[name] = self._retry_minted.get(name, 0) + 1
            if self.telemetry is not None:
                self.telemetry.instant("retry", t_fail, {
                    "rid": req.rid, "endpoint": name,
                    "attempt": attempt, "ready_s": ready})
        else:
            self._bump(self._drops, name, req)
            if self.telemetry is not None:
                self.telemetry.instant("drop", t_fail, {
                    "rid": req.rid, "endpoint": name,
                    "attempts": req.retries})

    def _release_retries(self, before_s: float) -> int:
        """Re-admit every retry/re-route leg due before ``before_s``."""
        n = 0
        while self._retry_q and self._retry_q[0][0] < before_s:
            _, _, name, leg = heapq.heappop(self._retry_q)
            self._admit(name, leg)
            n += 1
        return n

    def _apply_chaos(self, t_end: float) -> None:
        """Apply every scripted event due before this window.

        Crash/outage victims are *drained to* the event instant first (the
        clock-causality contract: chaos never writes ``core.clock``), so
        work that retired before the failure survives and the dispatch
        crossing it becomes the in-flight casualty."""
        if self.chaos is None:
            return
        for ev in self.chaos.pop_due(t_end):
            if ev.kind == "brownout":
                # static data: each core got its cap windows at spawn; the
                # loop only logs the window for the audit trail
                self.chaos_log.append({
                    "t": ev.t_s, "kind": "brownout",
                    "target": ev.target or "*",
                    "duration_s": ev.duration_s,
                    "power_cap_frac": ev.power_cap_frac})
                continue
            if ev.kind == "crash":
                victims = self._crash_targets(ev)
            else:                      # outage: the whole region at once
                victims = [r for r in self.replicas
                           if r.stopped_s is None and r.zone == ev.target]
                self.chaos_log.append({
                    "t": ev.t_s, "kind": "outage", "target": ev.target,
                    "duration_s": ev.duration_s,
                    "replicas": len(victims)})
            for rep in victims:
                self._crash(rep, ev.t_s)

    def _crash_targets(self, ev) -> List[Replica]:
        if ev.target:
            return [r for r in self.replicas
                    if r.name == ev.target and r.stopped_s is None]
        name = self.chaos.pick_crash_target(
            [r.name for r in self.replicas if r.serving(ev.t_s)])
        return [r for r in self.replicas if r.name == name]

    def _crash(self, rep: Replica, t_c: float) -> None:
        """Kill one replica at ``t_c``: deliveries before the instant
        survive, the in-flight dispatch's joules/grams move to the ``lost``
        bucket (billed, never delivered), and every casualty — in-flight or
        still queued — goes through the retry tactic.  Queued work that had
        not even arrived by ``t_c`` is re-routed free of a retry charge."""
        core = rep.core
        core.drain_until(t_c)
        lost = [r for r in core.responses if r.done_s > t_c]
        lost_j = 0.0
        if lost:
            lost_j = core.meter.mark_lost([r.rid for r in lost], t_s=t_c)
            core.responses[:] = [r for r in core.responses
                                 if r.done_s <= t_c]
            core.total_tokens -= sum(len(r.tokens) for r in lost)
        queued = core.pending.drain_all()
        rep.draining = False
        rep.stopped_s = max(core.clock, t_c, rep.ready_s)
        if self.telemetry is not None:
            # the crash_loss instant (per-rid joules moved to ``lost``) was
            # already emitted by the meter hook inside mark_lost above
            self.telemetry.instant("crash", t_c, {
                "target": rep.name, "endpoint": rep.endpoint,
                "lost": len(lost), "lost_j": lost_j,
                "requeued": len(queued)}, sink=core.tracer)
        for resp in lost:
            ent = self._req_by_rid.get(resp.rid)
            if ent is not None:
                self._retry_or_drop(ent[0], ent[1], t_c)
        for req in queued:
            if req.arrival_s > t_c:
                # routed ahead of its arrival: nothing was sent yet, so it
                # re-routes at its own arrival instant, no attempt burned
                heapq.heappush(self._retry_q,
                               (req.arrival_s, req.rid, rep.endpoint, req))
            else:
                self._retry_or_drop(rep.endpoint, req, t_c)
        self.chaos_log.append({
            "t": t_c, "kind": "crash", "target": rep.name,
            "endpoint": rep.endpoint, "lost_rids": len(lost),
            "lost_j": lost_j, "requeued": len(queued)})

    # -- the shared-timeline run ----------------------------------------------
    def _defers(self, req: Request) -> bool:
        return self.shifter is not None and req.deadline_s is not None

    def _next_prewarm_s(self, after_s: float, window_s: float) -> Optional[float]:
        """Earliest instant a calendar wants a pre-warm decision after
        ``after_s``: a breakpoint's rate must be provisioned one cold-start
        (+ one window) ahead, so idle-gap skipping must not jump past it."""
        wake = None
        for spec in self.specs.values():
            if spec.calendar is None:
                continue
            lead = self.cold_start_s(spec) + window_s
            for tp, rate in spec.calendar.points:
                if rate > 0 and tp - lead > after_s:
                    wake = tp - lead if wake is None else min(wake, tp - lead)
                    break
        return wake

    def _more_work(self, i: int, n_events: int) -> bool:
        """Does the window loop still owe anything — an unrouted arrival, a
        due handoff or retry, a planned deferral release, or an unapplied
        chaos event?"""
        return (i < n_events or bool(self._handoff) or bool(self._retry_q)
                or (self.shifter is not None and self.shifter.pending)
                or (self.chaos is not None
                    and self.chaos.next_due_t() != float("inf")))

    def run(self, workloads: Dict[str, List[Request]]) -> FleetResult:
        """Serve ``{endpoint: workload}`` on one virtual timeline."""
        for name in workloads:
            if name not in self.specs:
                raise KeyError(f"unknown endpoint {name!r}")
        events: List[Tuple[float, str, Request]] = []
        for name, wl in workloads.items():
            events.extend((r.arrival_s, name, r) for r in wl)
        rids = [e[2].rid for e in events]
        if len(rids) != len(set(rids)):
            raise ValueError(
                "request ids must be unique across all workloads sharing a "
                "fleet timeline (use synth_workload's rid0= offset)")
        events.sort(key=lambda e: (e[0], e[1], e[2].rid))

        if self.autoscaler is not None:
            window_s = self.autoscaler.window_s
        elif self.shifter is not None:
            window_s = self.shifter.spec.window_s   # release cadence
        else:
            window_s = float("inf")
        if self.chaos is not None and self.chaos.events \
                and not math.isfinite(window_s):
            # chaos application and retry release run between windows, so
            # an injected run needs a finite cadence even with no
            # autoscaler; 1s matches the default autoscaler window
            window_s = 1.0
        if self.chaos is not None:
            # availability denominators: every original arrival, by class
            for name, wl in workloads.items():
                for req in wl:
                    self._bump(self._submitted, name, req)
        self.replica_timeline.append((0.0, self._serving_counts()))
        i = 0
        t_end = window_s
        while self._more_work(i, len(events)):
            self._apply_chaos(t_end)
            window_arrivals: Dict[str, int] = {}
            while i < len(events) and events[i][0] < t_end:
                _, name, req = events[i]
                if self._defers(req):
                    # batch-class: plan a low-carbon release instead of
                    # serving on arrival (deadline pressure caps the hold)
                    self.shifter.defer(name, req, self.service_time_s(name))
                elif self._admit(name, req):
                    window_arrivals[name] = window_arrivals.get(name, 0) + 1
                i += 1
            if self.shifter is not None:
                for name, req in self.shifter.release_due(t_end):
                    if self._admit(name, req):
                        window_arrivals[name] = \
                            window_arrivals.get(name, 0) + 1
            self._release_retries(t_end)
            self._release_handoffs(t_end)
            self._drain_window(t_end)
            # completed prefills mint decode-pool arrivals for next window
            self._collect_handoffs()
            more = self._more_work(i, len(events))
            self._observe_and_scale(t_end, window_arrivals, window_s,
                                    more_events=more)
            if not more:
                break
            # the next busy instant: an arrival, a planned release, a due
            # KV handoff, a retry re-entry, a scripted chaos event, or a
            # calendar pre-warm — never skip past any
            pending = []
            if i < len(events):
                pending.append(events[i][0])
            if self.shifter is not None and self.shifter.pending:
                pending.append(self.shifter.next_release_s())
            if self._handoff:
                pending.append(self._handoff[0][0])
            if self._retry_q:
                pending.append(self._retry_q[0][0])
            if self.chaos is not None \
                    and self.chaos.next_due_t() != float("inf"):
                # every event < t_end was already applied above
                pending.append(max(self.chaos.next_due_t(), t_end))
            prewarm = self._next_prewarm_s(t_end, window_s)
            if prewarm is not None and prewarm < min(pending):
                pending.append(max(prewarm, t_end))
            next_end = (math.floor(min(pending) / window_s) + 1) * window_s
            if next_end > t_end + window_s and self.autoscaler is not None:
                # idle gap: run just enough empty windows for scale-down
                # hysteresis to trigger (reclaiming replicas early in the
                # gap), then jump straight to the next busy window
                gap = int(round((next_end - t_end) / window_s)) - 1
                for k in range(min(self.autoscaler.down_windows, gap)):
                    t_empty = t_end + (k + 1) * window_s
                    self._drain_window(t_empty)
                    self._observe_and_scale(t_empty, {}, window_s,
                                            more_events=True)
            t_end = max(next_end, t_end + window_s)
        # drain everything still in flight to completion; disaggregated
        # prefills keep minting decode-pool arrivals, so iterate until the
        # handoff queue runs dry
        while True:
            for rep in self.replicas:
                if rep.stopped_s is None:
                    rep.core.drain_until()
            self._collect_handoffs()
            if not self._handoff:
                break
            self._release_handoffs(float("inf"))
        for rep in self.replicas:
            if rep.stopped_s is None and rep.draining:
                self._stop(rep)
        return self._finalize()

    def _drain_window(self, t_end: float) -> None:
        for rep in self.replicas:
            if rep.stopped_s is not None or rep.ready_s >= t_end:
                continue
            # hold back by the policy's admission lookahead so open batch
            # windows wait for next round's arrivals — but never by more
            # than one autoscaler window, or a policy with a huge timeout
            # would freeze draining and feed the autoscaler phantom backlog
            lookahead = getattr(rep.core.policy, "admission_lookahead_s", 0.0)
            if self.autoscaler is not None:
                lookahead = min(lookahead, self.autoscaler.window_s)
            rep.core.drain_until(max(t_end - lookahead, 0.0))
            if rep.draining and rep.backlog == 0:
                self._stop(rep)

    def _stop(self, rep: Replica) -> None:
        """Deprovision a drained replica: it was up (and billed) until the
        later of the scale-down decision and its last piece of work; after
        that it accrues no idle energy — the payoff of scaling down."""
        rep.stopped_s = max(rep.core.clock, rep.drain_mark_s, rep.ready_s)

    def _serving_counts(self) -> Dict[str, int]:
        counts = {name: 0 for name in self.specs}
        for r in self.replicas:
            if r.stopped_s is None and not r.draining:
                counts[r.endpoint] += 1
        return counts

    def _sample_gauges(self, t_end: float) -> None:
        """Metrics timelines: sample pool/backlog/carbon gauges at
        every window boundary — the same cadence the autoscaler observes —
        onto the trace's counter tracks.  Pure read-only observation."""
        if self.telemetry is None or self.telemetry.metrics is None:
            return
        reg = self.telemetry.metrics
        for name in self.specs:
            live = [r for r in self.endpoint_replicas(name)
                    if r.stopped_s is None and not r.draining]
            reg.sample(f"{name}/pool", t_end, len(live))
            reg.sample(f"{name}/backlog", t_end,
                       sum(r.backlog for r in live))
            for r in live:
                reg.sample("backlog", t_end, r.backlog, sink=r.core.tracer)
        for zone in sorted(self.carbon_zones):
            reg.sample(f"zone/{zone}/gco2_per_kwh", t_end,
                       self.zone_intensity(zone, t_end))
        if not self.carbon_zones:
            reg.sample("grid/gco2_per_kwh", t_end,
                       self.carbon.intensity(t_end))

    def _observe_and_scale(self, t_end: float, window_arrivals: Dict[str, int],
                           window_s: float, more_events: bool) -> None:
        self._sample_gauges(t_end)
        if self.monitor is not None:
            # pure observation: the monitor consumes the telemetry stream
            # up to this boundary and seals/scores its elapsed windows
            # (under REPRO_SANITIZE=1 the tick is proven read-only — R6)
            self.monitor.observe(t_end)
        if self.autoscaler is None:
            return
        # carbon-biased scale-down: compare the default grid's intensity at
        # this boundary against its trailing mean (both live on the shared
        # virtual clock, so "now vs. the recent past" is well defined)
        intensity = self.carbon.intensity(t_end)
        self._intensity_hist.append(intensity)
        mean_intensity = (sum(self._intensity_hist)
                          / len(self._intensity_hist))
        for name, spec in self.specs.items():
            pool = [r for r in self.endpoint_replicas(name)
                    if r.stopped_s is None]
            active_s = sum(r.core.meter.active_s for r in
                           self.endpoint_replicas(name))
            n_resp = sum(len(r.core.responses) for r in
                         self.endpoint_replicas(name))
            self._svc_obs[name] = (active_s, n_resp)
            live = [r for r in pool if not r.draining]
            if not more_events:
                continue                   # tail: just drain what exists
            if spec.disagg is not None:
                continue                   # disaggregated pools are fixed
            forecast = 0.0
            if spec.calendar is not None:
                # pre-warm: provision for the predicted peak across the
                # cold-start horizon, so a calendar ramp finds replicas
                # already warm instead of paying the cold start mid-crowd
                horizon = t_end + self.cold_start_s(spec) + window_s
                forecast = spec.calendar.peak_rate(t_end, horizon)
            desired = self.autoscaler.desired(
                window_arrivals.get(name, 0), window_s,
                self.service_time_s(name), spec.min_replicas,
                spec.max_replicas, forecast_rate_per_s=forecast)
            if spec.carbon_bias > 0 and mean_intensity > 0 \
                    and intensity > mean_intensity:
                # the grid is dirtier than it has recently been: accept a
                # higher utilization target for now and shrink harder — the
                # joules this window defers land in cleaner air
                over = intensity / mean_intensity - 1.0
                desired = max(spec.min_replicas,
                              math.ceil(desired
                                        / (1.0 + spec.carbon_bias * over)))
            if desired > len(live):
                self._down_streak[name] = 0
                need = desired - len(live)
                # un-drain still-provisioned replicas first: they are warm
                # and billing anyway, so reviving them skips the cold start
                for rep in sorted((r for r in pool if r.draining),
                                  key=lambda r: (-r.backlog, r.name)):
                    if need == 0:
                        break
                    rep.draining = False
                    need -= 1
                for _ in range(need):
                    self._spawn(spec, created_s=t_end,
                                ready_s=t_end + self.cold_start_s(spec))
                self.scale_events.append(
                    {"t": t_end, "endpoint": name, "from": len(live),
                     "to": desired, "kind": "up"})
            elif desired < len(live):
                # hysteresis: only shrink after down_windows low windows in
                # a row, so one noisy window doesn't thrash the pool
                streak = self._down_streak.get(name, 0) + 1
                self._down_streak[name] = streak
                if streak < self.autoscaler.down_windows:
                    continue
                self._down_streak[name] = 0
                # drain the emptiest replicas first; keep min_replicas live
                by_load = sorted(live, key=lambda r: (r.backlog, r.name))
                n_down = min(len(live) - desired,
                             len(live) - spec.min_replicas)
                for rep in by_load[:n_down]:
                    rep.draining = True
                    rep.drain_mark_s = t_end
                    if rep.backlog == 0:
                        self._stop(rep)
                if n_down:
                    self.scale_events.append(
                        {"t": t_end, "endpoint": name, "from": len(live),
                         "to": len(live) - n_down, "kind": "down"})
            else:
                self._down_streak[name] = 0
        self.replica_timeline.append((round(t_end, 6),
                                      self._serving_counts()))

    # -- metrics ---------------------------------------------------------------
    def _bill_response_transit(self) -> None:
        """Cross-region response leg: generated tokens cross the link back
        to the request's origin region before the client sees them — the
        transit shifts the client-observed TTFT/completion instants and is
        billed as xfer at the *serving* region's link power."""
        for rep in self.replicas:
            if not rep.zone:
                continue
            out, changed = [], False
            for resp in rep.core.responses:
                ent = self._req_by_rid.get(resp.rid)
                origin = ent[1].origin if ent is not None else ""
                xfer_s = self.regions.transit_s(rep.zone, origin,
                                                8 * int(len(resp.tokens)))
                if xfer_s <= 0.0:
                    out.append(resp)
                    continue
                rep.core.meter.record_xfer(
                    xfer_s, self.regions.link_power_w(rep.zone),
                    t_s=resp.done_s)
                out.append(dataclasses.replace(
                    resp, first_token_s=resp.first_token_s + xfer_s,
                    done_s=resp.done_s + xfer_s))
                changed = True
                self.transit_events.append({
                    "rid": resp.rid, "endpoint": rep.endpoint,
                    "leg": "response", "from": rep.zone, "to": origin,
                    "xfer_s": xfer_s})
                if self.telemetry is not None:
                    self.telemetry.instant(
                        "transit", resp.done_s,
                        {"rid": resp.rid, "leg": "response",
                         "from": rep.zone, "to": origin, "xfer_s": xfer_s},
                        sink=rep.core.tracer)
            if changed:
                rep.core.responses[:] = out

    def _finalize(self) -> FleetResult:
        if self.regions is not None:
            self._bill_response_transit()
        if self.telemetry is not None and self.shifter is not None:
            # deferral holds become async spans on the fleet track: the
            # [deferral hold] segment between arrival and admission
            for ev in self.shifter.events:
                self.telemetry.hold(ev["rid"], ev["arrival_s"],
                                    ev["release_s"], {
                    "endpoint": ev["endpoint"],
                    "held_s": ev["held_s"],
                    "gco2_per_kwh_at_arrival": ev["intensity_at_arrival"],
                    "gco2_per_kwh_at_release": ev["intensity_at_release"]})
        # the shared timeline ends when the last provisioned replica goes
        # quiet; every still-provisioned replica pays idle draw up to there
        live_ends = [r.core.clock for r in self.replicas
                     if r.stopped_s is None]
        fleet_end = max(live_ends, default=0.0)
        for rep in self.replicas:
            if rep.stopped_s is None:
                rep.stopped_s = fleet_end
            uptime = rep.stopped_s - rep.created_s
            meter = rep.core.meter
            # the unaccounted residual is the provisioned tail after the
            # replica's last piece of work — bill its grams there.  Preempt
            # seconds occupied the replica (pause/resume work), so they
            # count against uptime; xfer seconds do not (the link streams
            # in parallel with the replica's own timeline); lost seconds
            # were active seconds before their reclassification, so they
            # too count against uptime
            meter.record_idle(uptime - meter.active_s - meter.idle_s
                              - meter.preempt_s - meter.lost_s,
                              t_s=rep.core.clock)

        endpoints: Dict[str, ServingMetrics] = {}
        fleet_meter = new_meter()
        all_resp, all_wall, all_tokens = [], 0.0, 0
        for name in self.specs:
            reps = self.endpoint_replicas(name)
            meter = new_meter()
            responses, wall, tokens = [], 0.0, 0
            finished = [(rep, rep.core.finish()) for rep in reps]
            for rep, m in finished:
                wall += m.wall_compute_s
                tokens += m.total_tokens
                meter.merge(m.meter, source=rep.name)
                fleet_meter.merge(m.meter, source=rep.name)
            if self.specs[name].disagg is not None:
                responses = self._stitch_disagg(finished)
            else:
                responses = [r for _, m in finished for r in m.responses]
            responses.sort(key=lambda r: r.rid)
            stats = self._stats(reps, endpoint=name)
            self._availability_stats(stats, [name], responses)
            endpoints[name] = ServingMetrics(
                responses, wall, meter.total_j, tokens, meter=meter,
                fleet=stats)
            all_resp.extend(responses)
            all_wall += wall
            all_tokens += tokens
        all_resp.sort(key=lambda r: r.rid)
        fleet_stats = self._stats(self.replicas)
        self._availability_stats(fleet_stats, list(self.specs), all_resp)
        fleet = ServingMetrics(all_resp, all_wall, fleet_meter.total_j,
                               all_tokens, meter=fleet_meter,
                               fleet=fleet_stats)
        return FleetResult(endpoints=endpoints, fleet=fleet)

    @staticmethod
    def _stitch_disagg(finished: List[Tuple[Replica, ServingMetrics]]
                       ) -> List[Response]:
        """Rejoin each request's prefill and decode legs into one response:
        arrival/start/TTFT come from the prefill leg (that is where the
        first token was produced), completion and the remaining tokens from
        the decode leg.  A request whose prefill produced its only token
        has no decode leg and passes through unchanged."""
        pre: Dict[int, Response] = {}
        dec: Dict[int, Response] = {}
        for rep, m in finished:
            side = pre if rep.role == "prefill" else dec
            for r in m.responses:
                side[r.rid] = r
        out = []
        for rid, p in pre.items():
            q = dec.get(rid)
            if q is None:
                out.append(p)
                continue
            toks = np.concatenate([p.tokens, q.tokens]) if len(q.tokens) \
                else p.tokens
            out.append(Response(
                rid=rid, tokens=toks, arrival_s=p.arrival_s,
                start_s=p.start_s, first_token_s=p.first_token_s,
                done_s=q.done_s, deadline_s=p.deadline_s,
                priority=p.priority))
        return out

    def _stats(self, reps: List[Replica],
               endpoint: Optional[str] = None) -> dict:
        """Provisioning stats; ``endpoint=None`` means fleet-wide."""
        if endpoint is None:
            timeline = [(t, sum(counts.values()))
                        for t, counts in self.replica_timeline]
            events = list(self.scale_events)
        else:
            timeline = [(t, counts.get(endpoint, 0))
                        for t, counts in self.replica_timeline]
            events = [e for e in self.scale_events
                      if e["endpoint"] == endpoint]
        stats = {
            "replicas_created": len(reps),
            "peak_replicas": max((n for _, n in timeline), default=len(reps)),
            "cold_starts": sum(1 for r in reps if r.cold_start),
            "replica_seconds": sum(
                r.uptime_end_s() - r.created_s for r in reps),
            "replica_timeline": timeline,
            "scale_events": events,
            "offered": {r.name: r.offered for r in reps},
        }
        if any(r.zone for r in reps):
            stats["zones"] = {r.name: r.zone for r in reps}
        if self.shifter is not None:
            stats["deferral"] = self.shifter.summary(endpoint)
        handoffs = [e for e in self.handoff_events
                    if endpoint is None or e["endpoint"] == endpoint]
        if handoffs:
            stats["handoffs"] = {
                "count": len(handoffs),
                "kv_bytes": sum(e["kv_bytes"] for e in handoffs),
                "xfer_s": sum(e["xfer_s"] for e in handoffs),
            }
        transits = [e for e in self.transit_events
                    if endpoint is None or e["endpoint"] == endpoint]
        if transits:
            stats["transit"] = {
                "count": len(transits),
                "xfer_s": sum(e["xfer_s"] for e in transits),
            }
        if self.chaos_log and endpoint is None:
            stats["chaos_events"] = list(self.chaos_log)
        return stats

    def _availability_stats(self, stats: dict, names: List[str],
                            responses: List[Response]) -> None:
        """Per-class availability for a chaos-injected run: delivered
        responses over submitted arrivals, with the recorded drops (retry
        budget exhausted) and sheds (degraded-mode batch work) that explain
        the gap.  Healthy runs (no ChaosRuntime) report nothing — their
        stats stay byte-identical to the pre-chaos fleet."""
        if self.chaos is None:
            return
        sub: Dict[str, int] = {}
        drops: Dict[str, int] = {}
        shed: Dict[str, int] = {}
        for n in names:
            for c, k in self._submitted.get(n, {}).items():
                sub[c] = sub.get(c, 0) + k
            for c, k in self._drops.get(n, {}).items():
                drops[c] = drops.get(c, 0) + k
            for c, k in self._shed.get(n, {}).items():
                shed[c] = shed.get(c, 0) + k
        if not sub:
            return
        delivered: Dict[str, int] = {}
        for r in responses:
            c = r.priority or DEFAULT_PRIORITY
            delivered[c] = delivered.get(c, 0) + 1
        stats["submitted_by_class"] = dict(sorted(sub.items()))
        stats["delivered_by_class"] = dict(sorted(delivered.items()))
        stats["drops_by_class"] = dict(sorted(drops.items()))
        stats["shed_by_class"] = dict(sorted(shed.items()))
        stats["availability_by_class"] = {
            c: delivered.get(c, 0) / max(k, 1)
            for c, k in sorted(sub.items())}
        stats["availability"] = (sum(delivered.values())
                                 / max(sum(sub.values()), 1))
        stats["retries"] = sum(self._retry_minted.get(n, 0) for n in names)
