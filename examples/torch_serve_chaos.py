"""Failure injection and degraded-mode serving — one spec, four weathers, on
the PyTorch port.

The counterpart of ``examples/serve_chaos.py``: two regions on offset
diurnal carbon signals, one endpoint spread across them, and a seeded
:class:`repro_torch.serving.chaos.ChaosSpec` script that makes the
infrastructure misbehave four ways from the same declarative
:class:`repro_torch.serving.api.ServingSpec`:

  1. ``healthy``  — no events (the reference; availability reads ``-``
     because a chaos-less run reports none);
  2. ``crash``    — a seeded replica crash mid-batch: the in-flight
     dispatch's joules land in the meter's ``lost`` bucket and the
     casualties re-enter through bounded retry-with-backoff;
  3. ``outage``   — region ``east`` goes dark for 3 virtual seconds:
     east-origin traffic fails over to ``west`` (billed as ``xfer`` on the
     inter-region link) while batch-class arrivals are shed at the front
     door (graceful degradation);
  4. ``brownout`` — a power cap on ``west``: steps stretch (energy per
     step is conserved) and batch arrivals are shed while the cap is
     active, so the interactive class still rides through untouched.

Step times are calibrated on the device (the GPU unless ``--device cpu``)
from random weights drawn from ``--seed``.

    PYTHONPATH=src python examples/torch_serve_chaos.py
    PYTHONPATH=src python examples/torch_serve_chaos.py --device cpu
"""

import argparse

from repro_torch.carbon.signal import CarbonSpec
from repro_torch.configs import get_arch
from repro_torch.devices import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.api import (
    AutoscaleSpec,
    EndpointSpec,
    PrioritySpec,
    ServingSession,
    ServingSpec,
)
from repro_torch.serving.chaos import ChaosEvent, ChaosSpec, RetrySpec
from repro_torch.serving.regions import RegionSpec
from repro_torch.workload.generators import WorkloadSpec

ARCH = "minitron-4b-smoke"
PROMPT_LEN, MAX_NEW = 16, 6
BULK_MAX_NEW = 64                      # long decodes: crashes catch batches

REGIONS = {
    "east": RegionSpec(carbon=CarbonSpec(kind="diurnal", g_per_kwh=300.0,
                                         amplitude_g_per_kwh=250.0,
                                         period_s=40.0, phase_s=0.0),
                       latency_ms=2.0, gbps=10.0, link_power_w=2.0),
    "west": RegionSpec(carbon=CarbonSpec(kind="diurnal", g_per_kwh=300.0,
                                         amplitude_g_per_kwh=250.0,
                                         period_s=40.0, phase_s=20.0),
                       latency_ms=2.0, gbps=10.0, link_power_w=2.0),
}

SCRIPTS = {
    "healthy": (),
    # the crashes land just after the 1.8 s flash crowd below, while the
    # pool is still chewing through the bulk backlog mid-batch
    "crash": (ChaosEvent(kind="crash", t_s=2.05),
              ChaosEvent(kind="crash", t_s=2.1),
              ChaosEvent(kind="crash", t_s=2.2)),
    "outage": (ChaosEvent(kind="outage", t_s=3.0, target="east",
                          duration_s=3.0),),
    "brownout": (ChaosEvent(kind="brownout", t_s=2.0, target="west",
                            duration_s=4.0, power_cap_frac=0.5),),
}


def spec_for(mode: str) -> ServingSpec:
    return ServingSpec(
        endpoints=(EndpointSpec(
            name="llm", arch=ARCH, model="m",
            policy="dynamic_batch", max_batch=8, batch_timeout_ms=10.0,
            max_seq=64,
            autoscale=AutoscaleSpec(min_replicas=2, max_replicas=4,
                                    replicas_hint=4, window_s=0.5,
                                    cold_start_s=0.1),
            zones=("east", "west"),
        ),),
        router="follow_sun",
        priority=PrioritySpec(enabled=True, preempt=False),
        regions=REGIONS,
        chaos=ChaosSpec(events=SCRIPTS[mode], seed=11),
        # the full green-tactics stack: bounded backoff, cross-region
        # failover, batch-first degradation while a window is active
        retry=RetrySpec(max_retries=3, backoff_s=0.05, backoff_mult=2.0,
                        failover=True, degrade=True),
    )


def workload(vocab: int):
    chat = WorkloadSpec(kind="poisson", n=400, rate_per_s=50.0,
                        prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW,
                        seed=21, slo_ms=150.0, priority="interactive",
                        origins=("east", "west"))
    # long-decode bulk with flash crowds at 1.8 s / 4.3 s: the first keeps
    # the pool mid-batch when the crash barrage hits (the ``lost`` bucket's
    # show-and-tell), the second lands inside the outage window so the
    # degradation tactic has batch work to shed
    bulk = WorkloadSpec(kind="bursty", n=200, rate_per_s=25.0,
                        prompt_len=PROMPT_LEN, max_new_tokens=BULK_MAX_NEW,
                        seed=22, rid0=100_000, priority="batch",
                        burst_n=60, burst_every_s=2.5, phase_s=1.8,
                        burst_rate_per_s=400.0,
                        origins=("east", "west"))
    return chat.build(vocab) + bulk.build(vocab)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the device to calibrate on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)
    cfg = get_arch(ARCH)
    params = init_params(cfg, ns.seed, device=device)
    session = ServingSession(device=device)

    fmt = "-"
    out = {}
    print(f"{'mode':<9} {'avail':>6} {'chat avail':>10} {'shed':>5} "
          f"{'J lost':>7} {'J xfer':>7} {'gCO2':>7} {'chat p95 TTFT':>14}")
    for mode in ("healthy", "crash", "outage", "brownout"):
        spec = spec_for(mode).validate()
        session.deploy(spec, params={"m": params})
        session.calibrate("llm", batch_sizes=range(1, 9),
                          prompt_len=PROMPT_LEN, max_new=MAX_NEW)
        session.calibrate("llm", batch_sizes=range(1, 9),
                          prompt_len=PROMPT_LEN, max_new=BULK_MAX_NEW)
        session.submit("llm", workload(cfg.vocab_size))
        ep = session.run().endpoints["llm"]
        avail = fmt if ep.availability is None \
            else f"{ep.availability:.3f}"
        chat_avail = fmt if not ep.availability_by_class \
            else f"{ep.availability_by_class.get('interactive', 0.0):.3f}"
        shed = sum(ep.shed_by_class.values())
        print(f"{mode:<9} {avail:>6} {chat_avail:>10} {shed:>5} "
              f"{ep.j_lost:>7.2f} {ep.j_xfer:>7.2f} "
              f"{ep.gco2_total:>7.4f} "
              f"{ep.ttft_p95_by_class.get('interactive', 0.0) * 1e3:>12.1f}ms")
        out[mode] = {"availability": ep.availability,
                     "availability_by_class": dict(ep.availability_by_class),
                     "shed": shed, "j_lost": ep.j_lost, "j_xfer": ep.j_xfer,
                     "gco2_total": ep.gco2_total,
                     "chat_p95_ttft_s": ep.ttft_p95_by_class.get("interactive", 0.0)}
    return out


if __name__ == "__main__":
    main()
