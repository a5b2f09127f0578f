"""The port's replica fleet against the JAX package's.

The same inputs go through both packages and every observable is compared
with ``==``: on deterministic fake engines (or a warm StepTimeCache behind a
ReplayEngine) no model runs, so each fleet run -- its summary, per-endpoint
metrics, the merged and per-replica meters (joules and grams, every
bucket), scale events, the replica timeline, cold starts, handoffs,
transits, the chaos log and every response's times and tokens -- must be
bit-identical to the reference's:

  * all six routers, on an autoscaled two-endpoint dynamic_batch fleet and
    on a fixed two-replica continuous_batch fleet;
  * prefill/decode disaggregation over a DisaggSpec link, and
    ``kv_cache_bytes`` for every config;
  * a preemptive priority ladder on a fleet endpoint;
  * carbon and workload: deferral on a diurnal signal (and the shifter's
    plan), a TrafficCalendar pre-warm (and ``calendar_points``),
    ``carbon_bias``;
  * regions with transit under follow_sun and carbon_aware;
  * chaos: crash, outage and brownout with RetrySpec failover and degrade,
    plain and under ``REPRO_SANITIZE=1``;
  * execution in f32: a two-replica continuous_batch fleet on
    minitron-4b-smoke whose every dispatch executes gives the reference's
    greedy tokens.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest

import repro.carbon as j_carbon
import repro.configs as j_configs
import repro.core.engines as j_engines
import repro.serving.admission as j_admission
import repro.serving.chaos as j_chaos
import repro.serving.fleet as j_fleet
import repro.serving.regions as j_regions
import repro.serving.request as j_request
import repro.serving.scheduler as j_sched
import repro.serving.stepcache as j_step
import repro.workload as j_workload
from repro.models import transformer as JT
import repro_torch.carbon as t_carbon
import repro_torch.configs as t_configs
import repro_torch.core.engines as t_engines
import repro_torch.serving.admission as t_admission
import repro_torch.serving.chaos as t_chaos
import repro_torch.serving.fleet as t_fleet
import repro_torch.serving.regions as t_regions
import repro_torch.serving.request as t_request
import repro_torch.serving.scheduler as t_sched
import repro_torch.serving.stepcache as t_step
import repro_torch.workload as t_workload
from repro_torch.models import transformer as T

ARCH = "minitron-4b-smoke"
PK = {
    name: types.SimpleNamespace(
        carbon=carbon, configs=configs, engines=engines, admission=admission,
        chaos=chaos, fleet=fleet, regions=regions, request=request, sched=sched,
        step=step, workload=workload)
    for name, (carbon, configs, engines, admission, chaos, fleet, regions, request,
               sched, step, workload) in {
        "ref": (j_carbon, j_configs, j_engines, j_admission, j_chaos, j_fleet, j_regions,
                j_request, j_sched, j_step, j_workload),
        "port": (t_carbon, t_configs, t_engines, t_admission, t_chaos, t_fleet, t_regions,
                 t_request, t_sched, t_step, t_workload),
    }.items()
}


class FakeEngine:
    """Deterministic timings, no model; returns its package's
    GenerationResult."""

    def __init__(self, pk, prefill_s=0.01, step_s=0.005):
        self.pk = pk
        self.prefill_s = prefill_s
        self.step_s = step_s
        self.cfg = pk.configs.get_arch(ARCH)

    def generate(self, tokens, max_new):
        B = tokens.shape[0]
        toks = (np.arange(B * max_new, dtype=np.int32).reshape(B, max_new)
                + int(np.asarray(tokens).sum()) % 97)
        return self.pk.engines.GenerationResult(
            tokens=toks, prefill_s=self.prefill_s * (1 + 0.25 * B),
            decode_s=self.step_s * (1 + 0.1 * B) * (max_new - 1), n_steps=max_new)


def _warm_cache(pk):
    """Synthetic step times for the continuous-batch and routing estimates."""
    cache = pk.step.StepTimeCache()
    for bucket in (8, 16):
        cache.put(("prefill1", bucket), (0.0041 + 0.0002 * bucket,))
        for b in range(1, 5):
            cache.put(("generate", b, bucket, 5), (0.004 + 0.0013 * b, (0.010 + 0.0021 * b) * 5))
    cache.put(("decode", 4), (0.0031,))
    return cache


def _zones(pk):
    D = pk.carbon.DiurnalSignal
    return {"a": D(amplitude_g_per_kwh=300.0, period_s=4.0),
            "b": D(amplitude_g_per_kwh=300.0, period_s=4.0, phase_s=2.0)}


def _dynamic(pk, max_batch=8, timeout_ms=20.0):
    return lambda: pk.sched.make_policy("dynamic_batch", max_batch=max_batch,
                                        timeout_ms=timeout_ms)


# -- what is compared ---------------------------------------------------------------


def _meter(m):
    d = dataclasses.asdict(m)
    d.pop("carbon")
    return d


def _responses(m):
    return [(r.rid, r.arrival_s, r.start_s, r.first_token_s, r.done_s, r.deadline_s,
             r.priority, np.asarray(r.tokens).tolist()) for r in m.responses]


def _metrics(m):
    return (m.summary(), m.fleet, m.wall_compute_s, m.energy_j, m.total_tokens,
            _meter(m.meter), _responses(m))


def observe(fleet, res) -> dict:
    return {
        "fleet": _metrics(res.fleet),
        "endpoints": {name: _metrics(m) for name, m in res.endpoints.items()},
        "replicas": [(r.name, r.endpoint, r.zone, r.role, r.created_s, r.ready_s,
                      r.stopped_s, r.offered, r.cold_start, _meter(r.core.meter))
                     for r in fleet.replicas],
        "scale_events": fleet.scale_events,
        "replica_timeline": fleet.replica_timeline,
        "cold_starts": fleet.cold_starts,
        "handoff_events": fleet.handoff_events,
        "transit_events": fleet.transit_events,
        "chaos_log": fleet.chaos_log,
    }


def both(scenario, *args, **kw):
    """Run ``scenario(pk, ...)`` -> (fleet, result) in both packages; returns
    (port's observables, reference's, port's fleet, port's result)."""
    out = {}
    for name, pk in PK.items():
        fleet, res = scenario(pk, *args, **kw)
        out[name] = (observe(fleet, res), fleet, res)
    return out["port"][0], out["ref"][0], out["port"][1], out["port"][2]


# -- routers ------------------------------------------------------------------------


def _two_endpoints(pk):
    gen = pk.workload
    chat = gen.poisson(160, 8, 5, 1000, rate_per_s=140.0, seed=1, slo_ms=60.0)
    bulk = gen.bursty(120, 16, 5, 1000, rate_per_s=40.0, burst_n=40, burst_every_s=0.6,
                      burst_rate_per_s=500.0, seed=2, rid0=10_000)
    return {"chat": chat, "bulk": bulk}


def _router_fleet(pk, router, setup):
    if setup == "dynamic_autoscaled":
        fleet = pk.fleet.ReplicaFleet(
            router=router, autoscaler=pk.fleet.Autoscaler(window_s=0.5, cold_start_s=0.2),
            carbon_zones=_zones(pk))
        for name, zones, slo in (("chat", ("a", "b"), 0.05), ("bulk", ("b",), None)):
            fleet.add_endpoint(pk.fleet.EndpointSpec(
                name=name, engine=FakeEngine(pk), policy_factory=_dynamic(pk),
                min_replicas=1, max_replicas=4, initial_replicas=2, ttft_slo_s=slo,
                zones=zones))
        return fleet, fleet.run(_two_endpoints(pk))
    fleet = pk.fleet.ReplicaFleet(router=router, carbon_zones=_zones(pk))
    fleet.add_endpoint(pk.fleet.EndpointSpec(
        name="chat", engine=pk.step.ReplayEngine(pk.configs.get_arch(ARCH)),
        policy_factory=lambda: pk.sched.make_policy("continuous_batch", max_batch=4,
                                                    max_seq=64),
        min_replicas=2, max_replicas=2, initial_replicas=2, warm_cache=_warm_cache(pk),
        zones=("a", "b"), ttft_slo_s=0.02))
    wl = pk.workload.poisson(90, 8, 5, 1000, rate_per_s=400.0, seed=3)
    return fleet, fleet.run({"chat": wl})


@pytest.mark.parametrize("setup", ["dynamic_autoscaled", "continuous_fixed"])
@pytest.mark.parametrize("router", sorted(j_fleet.ROUTERS))
def test_routers_replay_bit_identical(router, setup):
    assert sorted(t_fleet.ROUTERS) == sorted(j_fleet.ROUTERS)
    got, want, fleet, res = both(_router_fleet, router, setup)
    assert got == want
    served = sum(len(w) for w in (_two_endpoints(PK["port"]).values()
                                  if setup == "dynamic_autoscaled" else [range(90)]))
    assert len(res.fleet.responses) == served
    if setup == "continuous_fixed":
        assert len(fleet.replicas) == 2 and not fleet.scale_events
    else:
        assert fleet.scale_events


# -- disaggregation -----------------------------------------------------------------


def _disagg_fleet(pk, router="least_loaded"):
    runtime = pk.admission.DisaggRuntime.from_spec(
        pk.admission.DisaggSpec(enabled=True, prefill_replicas=2, decode_replicas=2,
                                link_gbps=10.0, link_latency_ms=0.2, link_power_w=15.0),
        pk.configs.get_arch(ARCH),
        prefill_policy_factory=lambda: pk.sched.PrefillPhasePolicy(8, 5.0),
        decode_policy_factory=lambda: pk.sched.DecodePhasePolicy(8, 5.0))
    fleet = pk.fleet.ReplicaFleet(router=router)
    fleet.add_endpoint(pk.fleet.EndpointSpec(
        name="llm", engine=FakeEngine(pk), policy_factory=_dynamic(pk, timeout_ms=5.0),
        disagg=runtime))
    wl = pk.workload.poisson(80, 12, 6, 1000, rate_per_s=200.0, seed=3)
    return fleet, fleet.run({"llm": wl})


@pytest.mark.parametrize("router", ["least_loaded", "greenest"])
def test_disaggregation_replay_bit_identical(router):
    got, want, fleet, res = both(_disagg_fleet, router)
    assert got == want
    assert len(fleet.handoff_events) == 80 and res.fleet.meter.xfer_j > 0
    assert {r.role for r in fleet.replicas} == {"prefill", "decode"}


@pytest.mark.parametrize("arch", sorted(t_configs.ARCHS) + [ARCH])
def test_kv_cache_bytes_match(arch):
    for seq, dtype_bytes in ((1, 2), (512, 2), (1024, 4)):
        assert t_admission.kv_cache_bytes(t_configs.get_arch(arch), seq, dtype_bytes) == \
            j_admission.kv_cache_bytes(j_configs.get_arch(arch), seq, dtype_bytes)


# -- admission: a preemptive ladder on a fleet endpoint ------------------------------


def _preempt_fleet(pk):
    fleet = pk.fleet.ReplicaFleet(router="least_loaded",
                                  autoscaler=pk.fleet.Autoscaler(window_s=0.25))
    fleet.add_endpoint(pk.fleet.EndpointSpec(
        name="llm", engine=FakeEngine(pk, prefill_s=0.02, step_s=0.01),
        policy_factory=_dynamic(pk, 4, 10.0), min_replicas=1, max_replicas=2,
        initial_replicas=1,
        admission=pk.admission.AdmissionControl(preempt=True, max_preemptions=2)))
    wl = pk.workload.bursty(120, 8, 12, 1000, rate_per_s=60.0, burst_n=30,
                            burst_every_s=0.5, burst_rate_per_s=600.0, seed=5)
    for i, r in enumerate(wl):
        r.priority = "interactive" if i % 13 == 6 else ("batch", "standard")[i % 2]
    return fleet, fleet.run({"llm": wl})


def test_preemptive_admission_replay_bit_identical():
    got, want, _, res = both(_preempt_fleet)
    assert got == want
    assert res.fleet.meter.preempt_j > 0


# -- carbon and workload --------------------------------------------------------------


def _diurnal(pk):
    return pk.carbon.DiurnalSignal(amplitude_g_per_kwh=350.0, period_s=8.0)


def _deferral_fleet(pk):
    fleet = pk.fleet.ReplicaFleet(
        router="carbon_aware", autoscaler=pk.fleet.Autoscaler(window_s=0.5, cold_start_s=0.2),
        carbon=_diurnal(pk), deferral=pk.carbon.DeferralSpec(enabled=True, margin_s=1.0))
    fleet.add_endpoint(pk.fleet.EndpointSpec(
        name="batch", engine=FakeEngine(pk), policy_factory=_dynamic(pk),
        min_replicas=0, max_replicas=6, initial_replicas=2))
    wl = pk.workload.bursty(240, 8, 4, 100, rate_per_s=20, burst_n=80, burst_every_s=8.0,
                            burst_rate_per_s=600.0, phase_s=1.5, seed=7, deadline_s=10.0)
    return fleet, fleet.run({"batch": wl})


def test_deferral_replay_bit_identical():
    got, want, fleet, res = both(_deferral_fleet)
    assert got == want
    assert fleet.shifter.events and res.endpoints["batch"].deadline_compliance == 1.0
    plans = {}
    for name, pk in PK.items():
        shifter = pk.carbon.TemporalShifter(_diurnal(pk), pk.carbon.DeferralSpec(enabled=True))
        wl = pk.workload.poisson(40, 8, 4, 100, rate_per_s=5.0, seed=4, deadline_s=12.0)
        plans[name] = [shifter.plan_release_s(r, 0.05) for r in wl]
    assert plans["port"] == plans["ref"]


def _calendar_fleet(pk, calendar: bool):
    ramp_t = 4.0
    Req = pk.request.Request
    wl = [Req(rid=i, prompt=np.zeros((8,), np.int32), max_new_tokens=4,
              arrival_s=0.0 if i < 4 else ramp_t + 0.002 * (i - 4)) for i in range(304)]
    cal = pk.workload.TrafficCalendar(points=((0.0, 8.0), (ramp_t, 300.0)))
    fleet = pk.fleet.ReplicaFleet(router="least_loaded",
                                  autoscaler=pk.fleet.Autoscaler(window_s=0.5, cold_start_s=0.5))
    fleet.add_endpoint(pk.fleet.EndpointSpec(
        name="ep", engine=FakeEngine(pk), policy_factory=_dynamic(pk, timeout_ms=10.0),
        min_replicas=1, max_replicas=6, initial_replicas=1, service_time_hint_s=0.02,
        calendar=cal if calendar else None))
    return fleet, fleet.run({"ep": wl})


@pytest.mark.parametrize("calendar", [True, False])
def test_calendar_prewarm_replay_bit_identical(calendar):
    got, want, fleet, _ = both(_calendar_fleet, calendar)
    assert got == want
    ups = [e["t"] for e in fleet.scale_events if e["kind"] == "up"]
    assert (min(ups) < 4.0) == calendar
    points = {name: pk.workload.calendar_points(
        pk.workload.poisson(100, 8, 4, 100, rate_per_s=50, seed=5), window_s=1.0)
        for name, pk in PK.items()}
    assert points["port"] == points["ref"]


def _bias_fleet(pk, bias):
    fleet = pk.fleet.ReplicaFleet(
        router="greenest", autoscaler=pk.fleet.Autoscaler(window_s=0.25, cold_start_s=0.1),
        carbon=pk.carbon.DiurnalSignal(amplitude_g_per_kwh=300.0, period_s=2.0))
    fleet.add_endpoint(pk.fleet.EndpointSpec(
        name="chat", engine=FakeEngine(pk), policy_factory=_dynamic(pk, timeout_ms=10.0),
        min_replicas=1, max_replicas=6, initial_replicas=4, carbon_bias=bias))
    return fleet, fleet.run({"chat": pk.workload.poisson(400, 8, 4, 1000, rate_per_s=150.0,
                                                         seed=9)})


@pytest.mark.parametrize("bias", [0.0, 3.0])
def test_carbon_bias_replay_bit_identical(bias):
    got, want, _, res = both(_bias_fleet, bias)
    assert got == want and len(res.fleet.responses) == 400


# -- regions and chaos ----------------------------------------------------------------


def _regions(pk, latency_ms=5.0):
    C = pk.carbon.CarbonSpec
    return {name: pk.regions.RegionSpec(
        carbon=C(kind="diurnal", g_per_kwh=300.0, amplitude_g_per_kwh=200.0, period_s=60.0,
                 phase_s=phase), latency_ms=latency_ms)
        for name, phase in (("eu", 0.0), ("us", 30.0))}


def _geo_workload(pk, n, rate, seed, rid0=0, priority=None):
    rng = np.random.RandomState(seed)
    t, out = 0.0, []
    for k in range(n):
        t += rng.exponential(1.0 / rate)
        out.append(pk.request.Request(
            rid=rid0 + k, prompt=rng.randint(0, 100, size=16).astype(np.int32),
            max_new_tokens=6, arrival_s=t, priority=priority, origin=("eu", "us")[k % 2]))
    return out


CHAOS = ({"kind": "crash", "t_s": 2.0},
         {"kind": "outage", "t_s": 4.0, "target": "eu", "duration_s": 3.0},
         {"kind": "brownout", "t_s": 8.0, "target": "us", "duration_s": 2.0,
          "power_cap_frac": 0.5})


def _geo_fleet(pk, router, chaos: bool, retry=None):
    kw = {}
    if chaos:
        kw["chaos"] = pk.chaos.ChaosRuntime.from_spec(pk.chaos.ChaosSpec(
            events=tuple(pk.chaos.ChaosEvent(**e) for e in CHAOS), seed=7))
        kw["retry"] = pk.chaos.RetryRuntime.from_spec(pk.chaos.RetrySpec(**retry))
    fleet = pk.fleet.ReplicaFleet(
        router=router, autoscaler=pk.fleet.Autoscaler(window_s=0.5),
        regions=pk.regions.RegionTopology.from_specs(_regions(pk)), **kw)
    fleet.add_endpoint(pk.fleet.EndpointSpec(
        name="chat", engine=FakeEngine(pk), policy_factory=_dynamic(pk, 4, 10.0),
        min_replicas=2, max_replicas=4, initial_replicas=4, zones=("eu", "us")))
    wl = (_geo_workload(pk, 300, 80.0, seed=5)
          + _geo_workload(pk, 80, 20.0, seed=6, rid0=10_000, priority="batch"))
    return fleet, fleet.run({"chat": wl})


@pytest.mark.parametrize("router", ["follow_sun", "carbon_aware"])
def test_regions_with_transit_replay_bit_identical(router):
    got, want, fleet, _ = both(_geo_fleet, router, False)
    assert got == want
    legs = {e["leg"] for e in fleet.transit_events}
    assert legs == {"request", "response"}


@pytest.mark.parametrize("retry", [
    dict(max_retries=3),
    dict(max_retries=1, failover=False),
    dict(max_retries=3, failover=True, degrade=True),
], ids=["retry", "pinned", "failover_degrade"])
def test_chaos_replay_bit_identical(retry):
    got, want, fleet, res = both(_geo_fleet, "least_loaded", True, retry)
    assert got == want
    kinds = {e["kind"] for e in fleet.chaos_log}
    assert kinds == {"crash", "outage", "brownout"}
    assert res.fleet.meter.lost_j > 0
    stats = res.fleet.fleet
    for c, n in stats["submitted_by_class"].items():
        assert n == (stats["delivered_by_class"].get(c, 0) + stats["drops_by_class"].get(c, 0)
                     + stats["shed_by_class"].get(c, 0))


def test_chaos_under_the_sanitizer_is_bit_identical(monkeypatch):
    retry = dict(max_retries=3, failover=True, degrade=True)
    plain = both(_geo_fleet, "greenest", True, retry)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    got, want, fleet, _ = both(_geo_fleet, "greenest", True, retry)
    assert type(fleet.replicas[0].core.meter).__name__ == "SanitizedEnergyMeter"
    assert got == want == plain[0]


# -- execution in f32 -------------------------------------------------------------------


def test_continuous_fleet_tokens_match_reference_f32():
    """Every dispatch executes (no step cache): two continuous-batching
    replicas of one engine give the reference's greedy tokens."""
    jcfg = j_configs.get_arch(ARCH)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_numpy(jax.tree.map(np.asarray, jp), t_configs.get_arch(ARCH),
                                 device="cpu")
    engines = {"ref": j_engines.CompiledEngine(jcfg, jp, max_seq=64),
               "port": t_engines.CompiledEngine(t_configs.get_arch(ARCH), params, 64,
                                                device="cpu")}
    tokens = {}
    for name, pk in PK.items():
        fleet = pk.fleet.ReplicaFleet(router="least_loaded")
        fleet.add_endpoint(pk.fleet.EndpointSpec(
            name="chat", engine=engines[name],
            policy_factory=lambda: pk.sched.make_policy("continuous_batch", max_batch=2,
                                                        max_seq=64),
            min_replicas=2, max_replicas=2, initial_replicas=2, use_step_cache=False))
        wl = pk.workload.poisson(8, 8, 4, jcfg.vocab_size, rate_per_s=300.0, seed=3)
        res = fleet.run({"chat": wl})
        assert {r.offered for r in fleet.replicas} != {0}
        tokens[name] = {r.rid: np.asarray(r.tokens).tolist() for r in res.fleet.responses}
    assert len(tokens["port"]) == 8 and tokens["port"] == tokens["ref"]
