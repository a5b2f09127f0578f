"""Sweep the paper's design decisions as pure data, on the PyTorch port.

The counterpart of ``examples/sweep_decisions.py``, with its own copy of the
grid that script reads from ``benchmarks/bench_decisions.py`` (``BASE``,
``GRID``, the workloads and ``run``).  A design-decision study is a grid
over a :class:`repro_torch.serving.api.ServingSpec`: here ``model format x
router`` (2x2), expanded with :func:`repro_torch.serving.api.sweep` from
``{field_path: [values]}`` overrides, every cell validated before anything
runs.  Engines and calibrations are memoized inside one
:class:`~repro_torch.serving.api.ServingSession`, so the whole grid costs two
calibrations (the ``rsm_int8`` bulk endpoint's runs the int8 matmul kernel)
and four virtual-time replays.  The rows (fleet J/token, p95, and
per-endpoint J/token attribution) are merged into ``--out`` under
``decision_grid``; by default that is ``examples_out/BENCH_serving.json``,
outside the tracked tree.  The weights are random, drawn from ``--seed``; it
runs on the GPU unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_sweep_decisions.py
      PYTHONPATH=src python examples/torch_sweep_decisions.py --device cpu --out /tmp/b.json
"""

import argparse
import json
import os
import sys
import time

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
from repro_torch.workload.generators import poisson

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples_out")

ARCH = "minitron-4b-smoke"
PROMPT_LEN = 16
MAX_NEW = 6
N_CHAT, RATE_CHAT = 1500, 100     # latency-sensitive endpoint (fp32 always)
N_BULK, RATE_BULK = 1000, 60      # throughput endpoint (format swept)

BASE = ServingSpec(
    endpoints=(
        EndpointSpec(
            name="chat", arch=ARCH, model="m", format="rsm",
            policy="dynamic_batch", max_batch=8, batch_timeout_ms=10.0,
            max_seq=64, ttft_slo_ms=100.0,
            autoscale=AutoscaleSpec(min_replicas=1, max_replicas=4,
                                    replicas_hint=2, window_s=0.25,
                                    cold_start_s=0.05),
        ),
        EndpointSpec(
            name="bulk", arch=ARCH, model="m", format="rsm",
            policy="dynamic_batch", max_batch=8, batch_timeout_ms=10.0,
            max_seq=64, ttft_slo_ms=100.0,
            autoscale=AutoscaleSpec(min_replicas=1, max_replicas=4,
                                    replicas_hint=2, window_s=0.25,
                                    cold_start_s=0.05),
        ),
    ),
    router="round_robin",
)

GRID = {
    "endpoints.bulk.format": ["rsm", "rsm_int8"],
    "router": ["round_robin", "greenest"],
}


def emit(name: str, us_per_call: float, derived: str = ""):
    print(f"{name},{us_per_call:.1f},{derived}")


def _workloads(vocab):
    return {
        "chat": poisson(N_CHAT, PROMPT_LEN, MAX_NEW, vocab,
                        rate_per_s=RATE_CHAT, seed=41),
        "bulk": poisson(N_BULK, PROMPT_LEN, MAX_NEW, vocab,
                        rate_per_s=RATE_BULK, seed=42, rid0=1_000_000),
    }


def run(device, seed: int = 0):
    cfg = get_arch(ARCH)
    params = init_params(cfg, seed, device=device)
    session = ServingSession(device=device)

    rows = []
    for assignment, spec in sweep(BASE, GRID):
        session.deploy(spec, params={"m": params})
        t0 = time.perf_counter()
        for name in ("chat", "bulk"):
            # per-engine memoized: already-measured shapes are skipped, so
            # repeated formats across cells cost nothing here
            session.calibrate(name, batch_sizes=range(1, 9),
                              prompt_len=PROMPT_LEN, max_new=MAX_NEW)
        cal_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        report = session.serve(_workloads(cfg.vocab_size))
        sim_s = time.perf_counter() - t0
        f = report.fleet
        row = {
            "bulk_format": assignment["endpoints.bulk.format"],
            "router": assignment["router"],
            "n_requests": f.n_requests,
            "j_per_token": f.j_per_token,
            "j_per_request": f.j_per_request,
            "j_active": f.j_active,
            "j_idle": f.j_idle,
            "p95_latency_s": f.latency_p95_s,
            "mean_ttft_s": f.mean_ttft_s,
            "replica_seconds": f.replica_seconds,
            "cold_starts": f.cold_starts,
            # each endpoint (= each format) priced from its own replicas'
            # meters
            "per_endpoint_j_per_token": {
                name: rep.j_per_token
                for name, rep in report.endpoints.items()
            },
            "sim_host_s": sim_s,
        }
        rows.append(row)
        emit(
            f"decisions_{row['bulk_format']}_{row['router']}",
            f.latency_p95_s * 1e6,
            f"J_tok={f.j_per_token:.6f};"
            f"bulk_J_tok={row['per_endpoint_j_per_token']['bulk']:.6f};"
            f"chat_J_tok={row['per_endpoint_j_per_token']['chat']:.6f};"
            f"cal_s={cal_s:.2f};sim_host_s={sim_s:.3f}",
        )
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "BENCH_serving.json"),
                    help="JSON file to merge the decision_grid into")
    ap.add_argument("--device", default=None,
                    help="the device to serve on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)

    print("name,us_per_call,derived")
    rows = run(device, ns.seed)

    doc = {}
    if os.path.exists(ns.out):
        with open(ns.out) as f:
            doc = json.load(f)
    doc["decision_grid"] = rows
    doc.setdefault("generated_by", "examples/torch_sweep_decisions.py")
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    print(f"# wrote decision_grid ({len(rows)} cells) to {ns.out}",
          file=sys.stderr)

    best = min(rows, key=lambda r: r["j_per_token"])
    print(f"# greenest cell: bulk_format={best['bulk_format']} "
          f"router={best['router']} -> {best['j_per_token']:.6f} J/token "
          f"(p95 {best['p95_latency_s']:.4f}s)", file=sys.stderr)
    return {"rows": rows, "out": ns.out,
            "greenest": {k: best[k] for k in ("bulk_format", "router", "j_per_token",
                                              "p95_latency_s")}}


if __name__ == "__main__":
    main()
