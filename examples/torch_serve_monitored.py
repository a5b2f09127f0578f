"""A monitored failure day on the PyTorch port: the green-SRE layer end to
end.

The counterpart of ``examples/serve_monitored.py``, with its own copies of
what that script reads from ``benchmarks/bench_chaos.py`` (the failure day
``EVENTS``, ``REGIONS``, ``TACTICS`` and ``chaos_spec_for``) and
``benchmarks/bench_monitor.py`` (``BUDGETS``, ``spec_for`` and
``workload``, at ``MONITOR_N`` requests, 3000 by default).  One declarative
:class:`MonitorSpec` on the chaos-grid spec turns the scripted failure day —
a replica crash, an 8-virtual-second region outage, two more crashes, a
brownout power cap — into an *operated* run:

  * golden + green signals sealed every 250 virtual ms;
  * four declared budgets scored by multi-window burn rates — ``crashes``,
    ``loss``, ``power``, ``slo``;
  * page/warn alerts merged into incident records with per-bucket energy
    attribution;
  * the whole story rendered to one self-contained stdlib HTML dashboard,
    ``examples_out/BENCH_dashboard.html`` unless ``--out`` moves it.

Monitoring is a pure observer: the monitored run's joules, grams and
latencies are bit-identical to an unmonitored one, which this script
verifies by running the same spec both ways before writing the dashboard.
Step times are calibrated once on the device (the GPU unless ``--device
cpu``) from random weights drawn from ``--seed``.

    PYTHONPATH=src python examples/torch_serve_monitored.py --out ops.html
    PYTHONPATH=src python examples/torch_serve_monitored.py --device cpu
"""

import argparse
import dataclasses
import os

from repro_torch.carbon.signal import CarbonSpec
from repro_torch.configs import get_arch
from repro_torch.devices import resolve_device
from repro_torch.energy.hw import HOST_CPU_POWER_W
from repro_torch.models import init_params
from repro_torch.serving.api import (
    AutoscaleSpec,
    EndpointSpec,
    PrioritySpec,
    ServingSession,
    ServingSpec,
    SLOClass,
    with_override,
)
from repro_torch.serving.chaos import ChaosEvent, ChaosSpec, RetrySpec
from repro_torch.serving.monitor import BudgetSpec, MonitorSpec, write_dashboard
from repro_torch.serving.regions import RegionSpec
from repro_torch.serving.stepcache import ReplayEngine, StepTimeCache
from repro_torch.workload.generators import WorkloadSpec

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples_out")

# -- the chaos grid's failure day -----------------------------------------------

ARCH = "minitron-4b-smoke"
PROMPT_LEN = 16
MAX_NEW = 6

# the failure day every tactic faces (virtual seconds)
OUTAGE_T, OUTAGE_DUR = 4.0, 8.0
EVENTS = (
    ChaosEvent(kind="crash", t_s=2.0),                 # seeded replica pick
    ChaosEvent(kind="outage", t_s=OUTAGE_T, target="east",
               duration_s=OUTAGE_DUR),
    ChaosEvent(kind="crash", t_s=5.0),
    ChaosEvent(kind="crash", t_s=9.0),
    ChaosEvent(kind="brownout", t_s=14.0, target="west", duration_s=4.0,
               power_cap_frac=0.6),
)

# offset diurnal signals (period 40 s): west sits in its solar valley
# across the outage window [4, 12]; east climbs to its dirty peak right as
# the outage lifts
REGIONS = {
    "east": RegionSpec(carbon=CarbonSpec(kind="diurnal", g_per_kwh=300.0,
                                         amplitude_g_per_kwh=280.0,
                                         period_s=40.0, phase_s=4.0),
                       latency_ms=2.0, gbps=10.0, link_power_w=2.0),
    "west": RegionSpec(carbon=CarbonSpec(kind="diurnal", g_per_kwh=300.0,
                                         amplitude_g_per_kwh=280.0,
                                         period_s=40.0, phase_s=18.0),
                       latency_ms=2.0, gbps=10.0, link_power_w=2.0),
}

TACTICS = {
    "failover_degrade": RetrySpec(max_retries=3, backoff_s=0.05,
                                  backoff_mult=2.0, failover=True,
                                  degrade=True),
    "failover_only": RetrySpec(max_retries=3, backoff_s=0.05,
                               backoff_mult=2.0, failover=True,
                               degrade=False),
    "naive_retry": RetrySpec(max_retries=64, backoff_s=0.05,
                             backoff_mult=2.0, failover=False,
                             degrade=False),
    "no_retry": RetrySpec(max_retries=0, failover=True, degrade=False),
}


def chaos_spec_for(tactic: str, router: str) -> ServingSpec:
    return ServingSpec(
        endpoints=(EndpointSpec(
            name="llm", arch=ARCH, model="m", format="rsm",
            policy="dynamic_batch", max_batch=8, batch_timeout_ms=10.0,
            max_seq=64,
            autoscale=AutoscaleSpec(min_replicas=2, max_replicas=6,
                                    replicas_hint=4, window_s=0.5,
                                    cold_start_s=0.1),
            zones=("east", "west"),
        ),),
        router=router,
        priority=PrioritySpec(enabled=True, preempt=False),
        regions=REGIONS,
        chaos=(ChaosSpec() if tactic == "healthy"
               else ChaosSpec(events=EVENTS, seed=11)),
        retry=TACTICS.get(tactic, RetrySpec()),
    )


# -- the monitor grid's spec and traffic ------------------------------------------

N = int(os.environ.get("MONITOR_N", 3000))
SPAN_S = 20.0
RATE = N / SPAN_S

# the declared promises; thresholds tuned so one scripted event pages
# within ~2 windows while a healthy day never leaves burn 0
BUDGETS = (
    BudgetSpec(name="crashes", kind="crashes", budget=1.0, horizon_s=60.0,
               fast_window_s=0.5, slow_window_s=1.0,
               page_burn=50.0, warn_burn=10.0),
    BudgetSpec(name="loss", kind="loss", budget=1.0, horizon_s=20.0,
               fast_window_s=0.5, slow_window_s=1.0,
               page_burn=5.0, warn_burn=1.0),
    BudgetSpec(name="power", kind="power", budget=HOST_CPU_POWER_W,
               objective=0.95, fast_window_s=0.5, slow_window_s=1.0,
               page_burn=8.0, warn_burn=2.0),
    BudgetSpec(name="slo-interactive", kind="slo", slo_class="interactive",
               objective=0.95, fast_window_s=0.5, slow_window_s=2.0,
               page_burn=10.0, warn_burn=2.0),
)


def spec_for(tactic: str, router: str) -> ServingSpec:
    """The chaos-grid spec, pinned to two replicas and monitored, with a
    declared interactive SLO class."""
    spec = chaos_spec_for(tactic, router)
    ep = dataclasses.replace(
        spec.endpoints[0],
        autoscale=AutoscaleSpec(min_replicas=2, max_replicas=2,
                                replicas_hint=2, window_s=0.5,
                                cold_start_s=0.1),
        slo_classes={"interactive": SLOClass(slo_ms=150.0,
                                             priority="interactive")})
    spec = dataclasses.replace(spec, endpoints=(ep,))
    spec = with_override(spec, "telemetry.enabled", True)
    return with_override(spec, "monitor", MonitorSpec(
        enabled=True, window_s=0.25, budgets=BUDGETS))


def workload(vocab: int):
    """The chaos grid's traffic shape at N requests."""
    n_chat, n_std = int(N * 0.4), int(N * 0.3)
    n_bulk = N - n_chat - n_std
    chat = WorkloadSpec(kind="poisson", n=n_chat, rate_per_s=RATE * 0.4,
                        prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW,
                        seed=71, slo_ms=150.0, priority="interactive",
                        origins=("east", "west"))
    std = WorkloadSpec(kind="poisson", n=n_std, rate_per_s=RATE * 0.3,
                       prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW,
                       seed=72, rid0=1_000_000, origins=("west", "east"))
    bulk = WorkloadSpec(kind="bursty", n=n_bulk, rate_per_s=RATE * 0.2,
                        prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW,
                        seed=73, rid0=2_000_000, priority="batch",
                        burst_n=max(n_bulk // 6, 1), burst_every_s=5.0,
                        burst_rate_per_s=RATE * 3.0,
                        origins=("east", "west"))
    return (chat.build(vocab) + std.build(vocab) + bulk.build(vocab))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "BENCH_dashboard.html"),
                    help="where to write the HTML ops dashboard")
    ap.add_argument("--tactic", default="failover_degrade",
                    choices=("failover_degrade", "healthy"))
    ap.add_argument("--device", default=None,
                    help="the device to calibrate on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)

    cfg = get_arch(ARCH)
    params = init_params(cfg, ns.seed, device=device)

    # calibrate ONCE, replay everywhere: both runs below must see the
    # identical step-time table or the R6 (observer purity) receipt would be
    # comparing two different simulations
    warm = ServingSession(device=device)
    warm.deploy(chaos_spec_for("healthy", "least_loaded").validate(),
                params={"m": params})
    warm.calibrate("llm", batch_sizes=range(1, 9),
                   prompt_len=PROMPT_LEN, max_new=MAX_NEW)
    cache = warm._warm_cache("llm").to_payload()

    def run(spec):
        spec = spec.validate()
        session = ServingSession(device=device)
        session.deploy(spec, engines={
            ep.name: ReplayEngine(get_arch(ep.arch))
            for ep in spec.endpoints})
        for ep in spec.endpoints:
            session.warm(ep.name, StepTimeCache.from_payload(cache))
        session.submit("llm", workload(cfg.vocab_size))
        return session.run()

    monitored = spec_for(ns.tactic, "least_loaded")
    report = run(monitored)
    # the same spec without the observers lands on the identical joule/gram
    # totals (monitoring never steers the sim)
    bare = run(dataclasses.replace(
        monitored, telemetry=type(monitored.telemetry)(enabled=False),
        monitor=type(monitored.monitor)()))
    ep, ep0 = report.endpoints["llm"], bare.endpoints["llm"]
    pure = (ep.j_measured == ep0.j_measured
            and ep.gco2_total == ep0.gco2_total)

    pages = sum(1 for a in report.alerts if a["severity"] == "page")
    print(f"tactic={ns.tactic}  requests={ep.n_requests}  "
          f"J={ep.j_measured:.2f} (lost {ep.j_lost:.2f})  "
          f"gCO2={ep.gco2_total:.4f}  observer_pure={pure}")
    print(f"monitor: {len(report.monitor.windows)} windows, "
          f"{pages} page / {len(report.alerts) - pages} warn alerts, "
          f"{len(report.incidents)} incidents")
    for inc in report.incidents:
        print(f"  incident [{inc['start']:6.2f}s -> {inc['end']:6.2f}s] "
              f"{inc['severity']:<5} budgets={','.join(inc['budgets'])} "
              f"lost_j={inc['lost_j']:.3f}")
    for name, rem in sorted(report.budget_remaining.items()):
        print(f"  budget {name:<16} kind={rem['kind']:<7} "
              f"spent={rem['spent']:10.4f}  "
              f"remaining={rem['remaining_frac'] * 100:6.1f}%")

    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    write_dashboard(ns.out, report.monitor,
                    title=f"green serving ops — {ns.tactic}",
                    phase_breakdown=ep.phase_breakdown,
                    meta={"tactic": ns.tactic,
                          "n": str(ep.n_requests),
                          "observer_pure": str(pure)})
    print(f"dashboard -> {ns.out}")

    status = 0
    if ns.tactic == "failover_degrade" and not report.incidents:
        print("expected the scripted failures to raise incidents")
        status = 1
    elif not pure:
        print("R6 violated: monitored and bare runs diverged")
        status = 1
    return {"status": status, "tactic": ns.tactic, "n_requests": ep.n_requests,
            "j_measured": ep.j_measured, "j_lost": ep.j_lost,
            "gco2_total": ep.gco2_total, "observer_pure": pure,
            "windows": len(report.monitor.windows), "pages": pages,
            "warns": len(report.alerts) - pages, "incidents": list(report.incidents),
            "budget_remaining": dict(report.budget_remaining), "out": ns.out}


if __name__ == "__main__":
    raise SystemExit(main()["status"])
