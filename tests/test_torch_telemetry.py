"""The port's telemetry and monitor against the JAX package's.

Traced fleet runs go through both packages on deterministic fake engines
and every observable is compared with ``==``:

  * the trace: ``to_perfetto`` documents (``json.dumps(..., sort_keys=True)``)
    are equal, and ``validate_trace`` returns ``[]`` for both;
  * the observers: ``phase_breakdown`` and the MetricsRegistry's samples;
  * the monitor: sealed windows, BurnEngine alerts, IncidentDetector
    incidents, budgets remaining and ``render_dashboard``'s HTML, plain and
    under ``REPRO_SANITIZE=1``;
  * pure observers: in the port a traced and monitored run's metrics equal
    an untraced run's.
"""

import dataclasses
import json
import types

import numpy as np
import pytest

import repro.carbon as j_carbon
import repro.core.engines as j_engines
import repro.serving.admission as j_admission
import repro.serving.chaos as j_chaos
import repro.serving.fleet as j_fleet
import repro.serving.monitor as j_monitor
import repro.serving.regions as j_regions
import repro.serving.request as j_request
import repro.serving.scheduler as j_sched
import repro.serving.telemetry as j_telemetry
import repro.workload as j_workload
import repro_torch.carbon as t_carbon
import repro_torch.core.engines as t_engines
import repro_torch.serving.admission as t_admission
import repro_torch.serving.chaos as t_chaos
import repro_torch.serving.fleet as t_fleet
import repro_torch.serving.monitor as t_monitor
import repro_torch.serving.regions as t_regions
import repro_torch.serving.request as t_request
import repro_torch.serving.scheduler as t_sched
import repro_torch.serving.telemetry as t_telemetry
import repro_torch.workload as t_workload

PK = {
    "ref": types.SimpleNamespace(
        carbon=j_carbon, engines=j_engines, admission=j_admission, chaos=j_chaos,
        fleet=j_fleet, monitor=j_monitor, regions=j_regions, request=j_request,
        sched=j_sched, telemetry=j_telemetry, workload=j_workload),
    "port": types.SimpleNamespace(
        carbon=t_carbon, engines=t_engines, admission=t_admission, chaos=t_chaos,
        fleet=t_fleet, monitor=t_monitor, regions=t_regions, request=t_request,
        sched=t_sched, telemetry=t_telemetry, workload=t_workload),
}


class FakeEngine:
    """Deterministic timings, no model; returns its package's
    GenerationResult."""

    def __init__(self, pk, prefill_s=0.01, step_s=0.005):
        self.pk = pk
        self.prefill_s = prefill_s
        self.step_s = step_s
        self.cfg = types.SimpleNamespace(vocab_size=1000, num_layers=4,
                                         num_kv_heads=2, head_dim=16)

    def generate(self, tokens, max_new):
        B = tokens.shape[0]
        return self.pk.engines.GenerationResult(
            tokens=np.ones((B, max_new), np.int32), prefill_s=self.prefill_s * (1 + 0.2 * B),
            decode_s=self.step_s * (1 + 0.1 * B) * (max_new - 1), n_steps=max_new)


def _dynamic(pk, max_batch=8, timeout_ms=10.0):
    return lambda: pk.sched.make_policy("dynamic_batch", max_batch=max_batch,
                                        timeout_ms=timeout_ms)


def _crowd(pk, n=160):
    gen = pk.workload
    chat = gen.poisson(n // 2, 8, 4, 1000, rate_per_s=300.0, seed=7, priority="interactive",
                       slo_ms=100.0)
    bulk = gen.bursty(n // 2, 8, 6, 1000, rate_per_s=60.0, burst_n=20, burst_every_s=0.5,
                      burst_rate_per_s=800.0, seed=8, rid0=10_000, priority="batch")
    return {"chat": chat, "bulk": bulk}


def _fleet(pk, scenario, telemetry=None, monitor=None):
    """One of three traced scenarios; returns (fleet, result)."""
    kw = dict(telemetry=telemetry, monitor=monitor)
    ep = dict(min_replicas=2, max_replicas=3, initial_replicas=2)
    if scenario == "chaos":
        kw["chaos"] = pk.chaos.ChaosRuntime.from_spec(pk.chaos.ChaosSpec(events=(
            pk.chaos.ChaosEvent(kind="crash", t_s=0.26, target="chat/r0"),
            pk.chaos.ChaosEvent(kind="crash", t_s=0.5),
            pk.chaos.ChaosEvent(kind="brownout", t_s=0.3, duration_s=0.3,
                                power_cap_frac=0.5)), seed=11))
        kw["retry"] = pk.chaos.RetryRuntime.from_spec(
            pk.chaos.RetrySpec(max_retries=3, backoff_s=0.02, degrade=True))
        fleet = pk.fleet.ReplicaFleet(
            router="least_loaded",
            autoscaler=pk.fleet.Autoscaler(window_s=0.25, cold_start_s=0.05), **kw)
        for name in ("chat", "bulk"):
            fleet.add_endpoint(pk.fleet.EndpointSpec(
                name=name, engine=FakeEngine(pk), policy_factory=_dynamic(pk), **ep))
        return fleet, fleet.run(_crowd(pk))
    if scenario == "disagg_preempt":
        runtime = pk.admission.DisaggRuntime.from_spec(
            pk.admission.DisaggSpec(enabled=True, prefill_replicas=1, decode_replicas=2,
                                    link_gbps=5.0, link_latency_ms=0.5),
            FakeEngine(pk).cfg,
            prefill_policy_factory=lambda: pk.sched.PrefillPhasePolicy(8, 5.0),
            decode_policy_factory=lambda: pk.sched.DecodePhasePolicy(8, 5.0))
        fleet = pk.fleet.ReplicaFleet(
            router="greenest", autoscaler=pk.fleet.Autoscaler(window_s=0.25), **kw)
        fleet.add_endpoint(pk.fleet.EndpointSpec(
            name="chat", engine=FakeEngine(pk), policy_factory=_dynamic(pk), disagg=runtime))
        fleet.add_endpoint(pk.fleet.EndpointSpec(
            name="bulk", engine=FakeEngine(pk, 0.02, 0.01), policy_factory=_dynamic(pk, 4),
            admission=pk.admission.AdmissionControl(preempt=True, max_preemptions=2), **ep))
        wl = _crowd(pk)
        for i, r in enumerate(wl["bulk"]):
            r.max_new_tokens = 12
            r.priority = "interactive" if i % 13 == 6 else "batch"
        return fleet, fleet.run(wl)
    # deferral holds on a diurnal grid, regions with transit
    regions = {name: pk.regions.RegionSpec(
        carbon=pk.carbon.CarbonSpec(kind="diurnal", g_per_kwh=300.0,
                                    amplitude_g_per_kwh=200.0, period_s=4.0, phase_s=ph),
        latency_ms=5.0) for name, ph in (("eu", 0.0), ("us", 2.0))}
    fleet = pk.fleet.ReplicaFleet(
        router="follow_sun", autoscaler=pk.fleet.Autoscaler(window_s=0.25, cold_start_s=0.1),
        carbon=pk.carbon.DiurnalSignal(amplitude_g_per_kwh=350.0, period_s=4.0),
        deferral=pk.carbon.DeferralSpec(enabled=True, margin_s=0.5),
        regions=pk.regions.RegionTopology.from_specs(regions), **kw)
    fleet.add_endpoint(pk.fleet.EndpointSpec(
        name="chat", engine=FakeEngine(pk), policy_factory=_dynamic(pk), zones=("eu", "us"),
        **ep))
    wl = _crowd(pk)
    for i, r in enumerate(wl["chat"]):
        r.origin = ("eu", "us")[i % 2]
    late = pk.workload.poisson(40, 8, 4, 1000, rate_per_s=20.0, seed=9, rid0=20_000,
                               deadline_s=3.0, priority="batch")
    return fleet, fleet.run({"chat": wl["chat"] + late})


SCENARIOS = ("chaos", "disagg_preempt", "deferral_regions")


def _traced(pk, scenario):
    rec = pk.telemetry.TraceRecorder()
    fleet, res = _fleet(pk, scenario, telemetry=rec)
    rec.attach_request_energy(res.fleet.meter.per_request_j, res.fleet.meter.per_request_g)
    return fleet, res, rec


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_perfetto_trace_and_observers_equal(scenario):
    out = {}
    for name, pk in PK.items():
        fleet, res, rec = _traced(pk, scenario)
        doc = pk.telemetry.to_perfetto(rec)
        assert pk.telemetry.validate_trace(doc) == []
        xfer = {}
        for ev in fleet.handoff_events + fleet.transit_events:
            xfer[ev["rid"]] = xfer.get(ev["rid"], 0.0) + ev["xfer_s"]
        out[name] = {
            "doc": json.dumps(doc, sort_keys=True),
            "phases": pk.telemetry.phase_breakdown(res.fleet.responses, rec.preempt_by_rid,
                                                   xfer),
            "samples": [ev for ev in rec.events if ev[0] == "ctr"],
            "buckets": rec.bucket_totals(),
            "dropped": rec.dropped,
        }
    assert out["port"] == out["ref"]
    assert out["port"]["samples"] and len(out["port"]["doc"]) > 10_000


BUDGETS = (
    dict(name="crashes", kind="crashes", budget=1.0, horizon_s=60.0, fast_window_s=0.5,
         slow_window_s=1.0, page_burn=50.0, warn_burn=10.0),
    dict(name="loss", kind="loss", budget=0.5, horizon_s=10.0, fast_window_s=0.5,
         slow_window_s=1.0, page_burn=5.0, warn_burn=1.0),
    dict(name="slo-int", kind="slo", slo_class="interactive", objective=0.9,
         fast_window_s=0.5, slow_window_s=1.0, page_burn=8.0, warn_burn=2.0),
    dict(name="joules", kind="joules", budget=40.0, horizon_s=2.0, fast_window_s=0.25,
         slow_window_s=0.5, page_burn=4.0, warn_burn=1.5),
    dict(name="grams", kind="grams", endpoint="chat", budget=0.002, horizon_s=2.0,
         fast_window_s=0.25, slow_window_s=0.5, page_burn=4.0, warn_burn=1.5),
    dict(name="power", kind="power", budget=65.0, objective=0.95, fast_window_s=0.25,
         slow_window_s=0.5, page_burn=4.0, warn_burn=1.5),
)
SLO_TARGETS = {("chat", "interactive"): (100.0, 0.0), ("bulk", "batch"): (0.0, 5.0)}


def _monitored(pk, scenario):
    rec = pk.telemetry.TraceRecorder()
    mon = pk.monitor.MonitorRuntime(
        pk.monitor.MonitorSpec(enabled=True, window_s=0.1, incident_gap_s=0.3,
                               budgets=tuple(pk.monitor.BudgetSpec(**b) for b in BUDGETS)),
        rec, SLO_TARGETS)
    fleet, res = _fleet(pk, scenario, telemetry=rec, monitor=mon)
    mon.finalize()
    return fleet, res, rec, mon


@pytest.mark.parametrize("sanitize", [False, True], ids=["plain", "sanitized"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_monitor_output_and_dashboard_equal(scenario, sanitize, monkeypatch):
    if sanitize:
        monkeypatch.setenv("REPRO_SANITIZE", "1")
    out = {}
    for name, pk in PK.items():
        fleet, res, rec, mon = _monitored(pk, scenario)
        phases = pk.telemetry.phase_breakdown(res.fleet.responses, rec.preempt_by_rid, {})
        html = pk.monitor.render_dashboard(mon, title="fleet", phase_breakdown=phases,
                                           meta={"scenario": scenario})
        out[name] = (mon.windows, mon.alerts, mon.incidents, mon.budget_remaining(), html)
    assert out["port"] == out["ref"]
    windows, alerts, incidents, _, html = out["port"]
    assert windows and html.startswith("<!DOCTYPE html>")
    if scenario == "chaos":
        assert alerts and incidents and res.fleet.meter.lost_j > 0


def _observables(fleet, res):
    meter = dataclasses.asdict(res.fleet.meter)
    meter.pop("carbon")
    return (res.fleet.summary(), res.fleet.fleet, meter,
            {n: m.summary() for n, m in res.endpoints.items()},
            [(r.rid, r.arrival_s, r.start_s, r.first_token_s, r.done_s)
             for r in res.fleet.responses],
            fleet.scale_events, fleet.chaos_log, fleet.handoff_events, fleet.transit_events)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_trace_and_monitor_are_pure_observers(scenario):
    pk = PK["port"]
    bare = _observables(*_fleet(pk, scenario))
    fleet, res, rec, mon = _monitored(pk, scenario)
    assert _observables(fleet, res) == bare
    assert rec.events and mon.windows
