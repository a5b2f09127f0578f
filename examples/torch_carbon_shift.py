"""Temporal demand shifting in one page, on the PyTorch port: move grams,
keep the p95.

The counterpart of ``examples/carbon_shift.py``.  Two endpoints on one
shared timeline:

  * ``chat`` — interactive Poisson traffic; its p95 is the contract that
    must NOT move;
  * ``batch`` — flash crowds that land exactly on the diurnal carbon
    signal's dirty peaks, carrying a completion deadline instead of a TTFT
    budget (the deferrable batch class).

Four spec variants (all pure data: ``sweep`` over ``deferral.enabled x
router``) are served from one memoized session, and the table prints the
trade: deferral + carbon-aware routing cuts total gCO2 roughly in half at
full deadline compliance, while the chat endpoint's p95 stays where it was.
Step times are calibrated on the device (the GPU unless ``--device cpu``)
from random weights drawn from ``--seed``.

Run:  PYTHONPATH=src python examples/torch_carbon_shift.py
      PYTHONPATH=src python examples/torch_carbon_shift.py --device cpu
"""

import argparse
import sys

from repro_torch.carbon.shift import DeferralSpec
from repro_torch.carbon.signal import CarbonSpec
from repro_torch.configs import get_arch
from repro_torch.devices import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.api import (
    AutoscaleSpec,
    EndpointSpec,
    ServingSession,
    ServingSpec,
    sweep,
)
from repro_torch.workload.generators import WorkloadSpec

ARCH = "minitron-4b-smoke"
PERIOD_S = 20.0          # one compressed grid "day"
PROMPT_LEN, MAX_NEW = 16, 6

SPEC = ServingSpec(
    endpoints=(
        EndpointSpec(
            name="chat", arch=ARCH, model="m", max_seq=64,
            policy="dynamic_batch", max_batch=8, batch_timeout_ms=10.0,
            ttft_slo_ms=100.0,
            autoscale=AutoscaleSpec(replicas_hint=2, window_s=0.25,
                                    cold_start_s=0.05),
            workload=WorkloadSpec(kind="poisson", n=2000,
                                  prompt_len=PROMPT_LEN,
                                  max_new_tokens=MAX_NEW,
                                  rate_per_s=100.0, seed=61),
        ),
        EndpointSpec(
            name="batch", arch=ARCH, model="m", max_seq=64,
            policy="dynamic_batch", max_batch=8, batch_timeout_ms=10.0,
            zones=("solar", "coal"),
            autoscale=AutoscaleSpec(min_replicas=0, max_replicas=6,
                                    replicas_hint=2, window_s=0.25,
                                    cold_start_s=0.05),
            # flash crowds on the dirty peak, 25 s completion deadline
            workload=WorkloadSpec(kind="bursty", n=2000,
                                  prompt_len=PROMPT_LEN,
                                  max_new_tokens=MAX_NEW,
                                  rate_per_s=20.0, burst_n=600,
                                  burst_every_s=PERIOD_S,
                                  burst_rate_per_s=600.0,
                                  phase_s=PERIOD_S / 4,
                                  deadline_s=25.0,
                                  rid0=1_000_000, seed=62),
        ),
    ),
    router="round_robin",
    carbon=CarbonSpec(kind="diurnal", g_per_kwh=450.0,
                      amplitude_g_per_kwh=400.0, period_s=PERIOD_S),
    carbon_zones={
        "solar": CarbonSpec(kind="diurnal", g_per_kwh=300.0,
                            amplitude_g_per_kwh=280.0, period_s=PERIOD_S,
                            phase_s=PERIOD_S / 2),
        "coal": CarbonSpec(kind="constant", g_per_kwh=820.0),
    },
    deferral=DeferralSpec(enabled=False, margin_s=1.0),
)

GRID = {
    "deferral.enabled": [False, True],
    "router": ["round_robin", "carbon_aware"],
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="the device to calibrate on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)
    cfg = get_arch(ARCH)
    params = init_params(cfg, ns.seed, device=device)
    session = ServingSession(device=device)

    rows = []
    print(f"{'deferral':>8} {'router':>13} {'gCO2':>8} {'g/tok':>10} "
          f"{'J/tok':>8} {'chat p95 ms':>12} {'ddl ok':>7}")
    base_g = None
    for assignment, spec in sweep(SPEC, GRID):
        session.deploy(spec, params={"m": params})
        for name in ("chat", "batch"):
            session.calibrate(name, batch_sizes=range(1, 9),
                              prompt_len=PROMPT_LEN, max_new=MAX_NEW)
        report = session.run_declared()
        f = report.fleet
        ddl = report.endpoints["batch"].deadline_compliance
        if base_g is None:
            base_g = f.gco2_total
        print(f"{str(assignment['deferral.enabled']):>8} "
              f"{assignment['router']:>13} "
              f"{f.gco2_total:8.3f} {f.gco2_per_token:10.2e} "
              f"{f.j_per_token:8.4f} "
              f"{report.endpoints['chat'].latency_p95_s * 1e3:12.1f} "
              f"{ddl:7.3f}")
        rows.append({"deferral": assignment["deferral.enabled"],
                     "router": assignment["router"], "gco2_total": f.gco2_total,
                     "gco2_per_token": f.gco2_per_token, "j_per_token": f.j_per_token,
                     "chat_p95_latency_s": report.endpoints["chat"].latency_p95_s,
                     "deadline_compliance": ddl})
    print(f"# gCO2 vs serve-immediately round-robin: "
          f"{f.gco2_total / base_g - 1:+.1%} "
          f"(deferral + carbon-aware routing; deadlines all met)",
          file=sys.stderr)
    held = report.result.fleet.fleet.get("deferral", {})
    print(f"# deferral: {held.get('released', 0)} requests held "
          f"{held.get('mean_held_s', 0.0):.1f}s on average, moved "
          f"{held.get('mean_intensity_drop_g_per_kwh', 0.0):.0f} g/kWh "
          "down the carbon curve", file=sys.stderr)
    return {"rows": rows, "gco2_change": f.gco2_total / base_g - 1,
            "deferral": dict(held)}


if __name__ == "__main__":
    main()
