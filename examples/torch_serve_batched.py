"""End-to-end serving driver on the PyTorch port: SI3 DL-server with
continuous batching under a Poisson workload, wire-level (TD4 codec) in and
out, per-request latencies.

The counterpart of ``examples/serve_batched.py``.  The weights are random,
drawn from ``--seed``; it serves on the GPU unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py --requests 12 --rate 20
      PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""

import argparse

from repro_torch.configs import get_arch
from repro_torch.core.add import (
    Deployment,
    Protocol,
    RequestProcessing,
    ServingInfrastructure,
)
from repro_torch.devices import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.request import synth_workload
from repro_torch.serving.server import ModelPackage, ServingServer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b-smoke")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="the device to serve on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)

    cfg = get_arch(ns.arch)
    params = init_params(cfg, ns.seed, device=device)
    dep = Deployment(
        arch=ns.arch, si=ServingInfrastructure.SI3_DL_SERVER,
        request_processing=RequestProcessing.CONTINUOUS_BATCH,
        protocol=Protocol.GRPC_BINARY, max_batch=ns.slots, max_seq=128,
    )
    srv = ServingServer(dep, device)
    endpoint = srv.register(
        ModelPackage(name="lm", arch=ns.arch, params=params, max_seq=128)
    )
    print(f"serving {cfg.name} at {endpoint} — {dep.describe()}")
    srv.warmup("lm", ns.slots, 16)

    wl = synth_workload(ns.requests, 14, ns.max_new, cfg.vocab_size,
                        rate_per_s=ns.rate, seed=9)
    wire = [
        (r.arrival_s, srv.codec.encode_request(r.rid, r.prompt,
                                               r.max_new_tokens))
        for r in wl
    ]
    out, metrics, stats = srv.handle_wire("lm", wire)

    rows = []
    print(f"\n{'rid':>4} {'arrive':>8} {'ttft':>8} {'latency':>8}  tokens")
    for r in sorted(metrics.responses, key=lambda r: r.rid):
        print(f"{r.rid:>4} {r.arrival_s:>8.3f} {r.ttft_s:>8.3f} "
              f"{r.latency_s:>8.3f}  {r.tokens.tolist()}")
        rows.append({"rid": r.rid, "arrival_s": r.arrival_s, "ttft_s": r.ttft_s,
                     "latency_s": r.latency_s})
    s = metrics.summary()
    print(f"\nthroughput {s['throughput_tok_s']} tok/s | "
          f"p95 {s['p95_latency_s']}s | "
          f"energy/request {s['energy_per_request_j']} J (host-proxy)")
    print(f"wire: {stats.request_bytes} B in, {stats.response_bytes} B out "
          f"({srv.codec.name})")
    return {"arch": cfg.name, "endpoint": endpoint, "deployment": dep.describe(),
            "requests": rows, "summary": s,
            "tokens": {r.rid: r.tokens.tolist() for r in metrics.responses},
            "wire": {"request_bytes": stats.request_bytes,
                     "response_bytes": stats.response_bytes,
                     "responses": len(out), "codec": srv.codec.name}}


if __name__ == "__main__":
    main()
