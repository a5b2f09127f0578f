"""Two endpoints, one declarative spec, on the PyTorch port: fleet routing +
autoscaling.

The counterpart of ``examples/serve_fleet.py``.  Everything about the
deployment — formats, scheduling policy, router, autoscaling, SLO classes —
is ONE :class:`repro_torch.serving.api.ServingSpec` value (printed as JSON
below; round-trippable).  The session deploys it, calibrates step times once
on the device, serves both endpoints' workloads on one shared virtual
timeline, and the typed report decomposes the SI4 abstraction cost per
replica: active vs idle joules, cold starts, and the replica count over
virtual time.  Compare round-robin dispatch against route-to-greenest by
overriding a single field.  The weights are random, drawn from ``--seed``;
it runs on the GPU unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_serve_fleet.py
      PYTHONPATH=src python examples/torch_serve_fleet.py --device cpu
"""

import argparse

from repro_torch.configs import get_arch
from repro_torch.devices import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.api import (
    AutoscaleSpec,
    EndpointSpec,
    ServingSession,
    ServingSpec,
    SLOClass,
    with_override,
)
from repro_torch.serving.request import synth_workload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b-smoke")
    ap.add_argument("--n", type=int, default=400, help="requests per endpoint")
    ap.add_argument("--device", default=None,
                    help="the device to calibrate on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)
    cfg = get_arch(ns.arch)
    params = init_params(cfg, ns.seed, device=device)

    autoscale = AutoscaleSpec(min_replicas=1, max_replicas=4,
                              window_s=0.25, cold_start_s=0.05)
    spec = ServingSpec(
        endpoints=(
            EndpointSpec(name="chat", arch=ns.arch, model="m",
                         policy="dynamic_batch", max_batch=8, max_seq=64,
                         autoscale=autoscale,
                         slo_classes={"interactive": SLOClass(slo_ms=150.0)}),
            EndpointSpec(name="bulk", arch=ns.arch, model="m",
                         policy="dynamic_batch", max_batch=8, max_seq=64,
                         autoscale=autoscale),
        ),
        router="round_robin",
    ).validate()
    print(spec.to_json(indent=1))

    session = ServingSession(device=device)
    session.deploy(spec, params={"m": params})
    for name in ("chat", "bulk"):
        session.calibrate(name, batch_sizes=range(1, 9), prompt_len=16,
                          max_new=6)

    def workloads():
        return {
            "chat": synth_workload(ns.n, 16, 6, cfg.vocab_size,
                                   rate_per_s=100, seed=31),
            "bulk": synth_workload(ns.n, 16, 6, cfg.vocab_size,
                                   rate_per_s=60, seed=32, rid0=10**6),
        }

    out = {"spec": spec.to_json(), "routers": {}}
    for router in ("round_robin", "greenest"):
        session.deploy(with_override(spec, "router", router),
                       params={"m": params})     # engines + caches memoized
        report = session.serve(workloads())
        f = report.fleet
        print(f"\n== router={router} ==")
        print(f"  requests={f.n_requests}  J/token={f.j_per_token:.5f}  "
              f"p95={f.latency_p95_s:.4f}s")
        print(f"  active J={f.j_active:.1f}  idle J={f.j_idle:.1f}  "
              f"replica-seconds={f.replica_seconds:.1f}  "
              f"cold starts={f.cold_starts}")
        print(f"  replicas over time: {f.replica_timeline}")
        for src, j in f.j_by_replica.items():
            print(f"    {src}: {j:.2f} J")
        out["routers"][router] = {
            "n_requests": f.n_requests, "j_per_token": f.j_per_token,
            "p95_latency_s": f.latency_p95_s, "j_active": f.j_active,
            "j_idle": f.j_idle, "replica_seconds": f.replica_seconds,
            "cold_starts": f.cold_starts, "replica_timeline": f.replica_timeline,
            "j_by_replica": dict(f.j_by_replica)}
    return out


if __name__ == "__main__":
    main()
