"""Green ADD comparison on the PyTorch port: sweep the paper's transversal
decisions and rank deployments by energy per token — the green-aware
decision aid the paper calls for ("may aid ML researchers and practitioners
in making green-aware architecture design decisions when serving their
models").

The counterpart of ``examples/green_comparison.py``.  As there, one native
``CompiledEngine`` serves every cell: the format column (``rsm`` /
``rsm_int8``) labels the deployment and its report, it does not change the
weights served.  The weights are random, drawn from ``--seed``; it runs on
the GPU unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_green_comparison.py
      PYTHONPATH=src python examples/torch_green_comparison.py --device cpu
"""

import argparse
import itertools

from repro_torch.configs import get_arch
from repro_torch.core.add import (
    Containerization,
    Deployment,
    ModelFormat,
    Protocol,
    RequestProcessing,
    ServingInfrastructure,
)
from repro_torch.core.engines import CompiledEngine
from repro_torch.core.quality import Quality
from repro_torch.devices import resolve_device
from repro_torch.energy.report import build_green_report
from repro_torch.models import init_params
from repro_torch.serving.container import overhead
from repro_torch.serving.request import synth_workload
from repro_torch.serving.scheduler import make_scheduler


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b-smoke")
    ap.add_argument("--device", default=None,
                    help="the device to serve on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)
    cfg = get_arch(ns.arch)
    params = init_params(cfg, ns.seed, device=device)
    engine = CompiledEngine(cfg, params, max_seq=64, device=device)
    for b in (1, 4):
        engine.warmup(b, 16)

    rows = []
    tokens = {}
    grid = itertools.product(
        [RequestProcessing.REALTIME, RequestProcessing.DYNAMIC_BATCH,
         RequestProcessing.CONTINUOUS_BATCH],
        [Containerization.NONE, Containerization.DOCKER,
         Containerization.WASM],
        [ModelFormat.RSM, ModelFormat.RSM_INT8],
    )
    for rp, cont, fmt in grid:
        dep = Deployment(
            arch=ns.arch, si=ServingInfrastructure.SI3_DL_SERVER,
            containerization=cont, model_format=fmt, request_processing=rp,
            protocol=Protocol.GRPC_BINARY,
            max_batch=1 if rp == RequestProcessing.REALTIME else 4,
            max_seq=64,
        )
        if dep.validate():
            continue
        sched = make_scheduler(rp.value, engine, max_batch=dep.max_batch,
                               timeout_ms=10, max_seq=64)
        wl = synth_workload(8, 12, 4, cfg.vocab_size, rate_per_s=200, seed=5)
        m = sched.run(wl)
        rep = build_green_report(dep, m)
        e = rep.get(Quality.ENERGY_EFFICIENCY).value
        p95 = m.latency_percentile(95) * overhead(cont).latency_overhead
        rows.append((e, p95, dep))
        tokens[dep.describe()] = {r.rid: r.tokens.tolist() for r in m.responses}

    rows.sort()
    print(f"{'J/token':>10}  {'p95_s':>8}  deployment")
    for e, p95, dep in rows:
        print(f"{e:>10.4f}  {p95:>8.4f}  {dep.describe()}")
    print("\ngreenest deployment:")
    print("  " + rows[0][2].describe())
    return {"arch": cfg.name,
            "rows": [{"j_per_token": e, "p95_s": p95, "deployment": dep.describe()}
                     for e, p95, dep in rows],
            "greenest": rows[0][2].describe(), "tokens": tokens}


if __name__ == "__main__":
    main()
