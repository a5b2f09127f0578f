"""Quickstart on the PyTorch port: serve a model through every Serving
Infrastructure option.

The counterpart of ``examples/quickstart.py``.  The paper's principal
design decision, executed:
  SI1 no-runtime-engine -> SI2 runtime engine -> SI3 DL server -> SI4 cloud,
same model, same workload, with the GreenReport for each.  The weights are
random, drawn from ``--seed``; everything runs on the GPU unless
``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--arch yi-9b-smoke]
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import tempfile

from repro_torch.configs import get_arch
from repro_torch.core.add import (
    Deployment,
    ModelFormat,
    RequestProcessing,
    ServingInfrastructure,
)
from repro_torch.core.engines import CompiledEngine, EagerEngine
from repro_torch.devices import resolve_device
from repro_torch.energy.report import build_green_report
from repro_torch.models import init_params
from repro_torch.serving.cloud import CloudService
from repro_torch.serving.request import synth_workload
from repro_torch.serving.scheduler import RealTimeScheduler
from repro_torch.serving.server import ModelPackage, ServingServer


def _served(m, report) -> dict:
    return {"summary": m.summary(), "report": report.table(),
            "tokens": {r.rid: r.tokens.tolist() for r in m.responses}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b-smoke")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="the device to serve on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)

    cfg = get_arch(ns.arch)
    print(f"== arch {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"({cfg.family}), ~{cfg.param_count()/1e6:.1f}M params")
    params = init_params(cfg, ns.seed, device=device)
    wl = lambda: synth_workload(ns.requests, 12, 4, cfg.vocab_size,  # noqa
                                rate_per_s=100, seed=1)
    out = {"arch": cfg.name}

    # ---- SI1: no runtime engine (eager framework + hand-built API) ----------
    dep1 = Deployment(arch=ns.arch, si=ServingInfrastructure.SI1_NO_RUNTIME,
                      model_format=ModelFormat.NATIVE,
                      request_processing=RequestProcessing.REALTIME,
                      max_batch=1, max_seq=64)
    m1 = RealTimeScheduler(EagerEngine(cfg, params, 64, device)).run(wl())
    print("\n[SI1 no-runtime]      ", m1.summary())
    rep = build_green_report(dep1, m1)
    print(rep.table())
    out["si1"] = _served(m1, rep)

    # ---- SI2: runtime engine (CUDA graphs of the decode step) ----------------
    dep2 = Deployment(arch=ns.arch, si=ServingInfrastructure.SI2_RUNTIME_ENGINE,
                      request_processing=RequestProcessing.REALTIME,
                      max_batch=1, max_seq=64)
    eng = CompiledEngine(cfg, params, 64, device)
    build = eng.warmup(1, 16)
    m2 = RealTimeScheduler(eng).run(wl())
    del eng                   # its graphs' buffers go before the next engine
    print(f"\n[SI2 runtime-engine]   engine build {build:.2f}s;", m2.summary())
    rep = build_green_report(dep2, m2)
    print(rep.table())
    out["si2"] = dict(_served(m2, rep), build_s=build)

    # ---- SI3: DL-serving software (packaged, batched, no hand API) ----------
    dep3 = Deployment(arch=ns.arch, si=ServingInfrastructure.SI3_DL_SERVER,
                      request_processing=RequestProcessing.CONTINUOUS_BATCH,
                      max_batch=4, max_seq=64)
    srv = ServingServer(dep3, device)
    endpoint = srv.register(ModelPackage(name="m", arch=ns.arch,
                                         params=params, max_seq=64))
    srv.warmup("m", 4, 16)
    m3 = srv.handle("m", wl())
    del srv
    print(f"\n[SI3 dl-server]        endpoint {endpoint};", m3.summary())
    rep = build_green_report(dep3, m3)
    print(rep.table())
    out["si3"] = dict(_served(m3, rep), endpoint=endpoint)

    # ---- SI4: end-to-end cloud service ----------------------------------------
    with tempfile.TemporaryDirectory() as td:
        cloud = CloudService(td, device)
        cloud.upload_model("m", 1, params, ModelFormat.RSM)
        dep4 = Deployment(arch=ns.arch,
                          si=ServingInfrastructure.SI4_CLOUD_SERVICE,
                          request_processing=RequestProcessing.DYNAMIC_BATCH,
                          max_batch=4, max_seq=64, max_replicas=3)
        url = cloud.deploy("m", 1, dep4, template_params=params)
        m4 = cloud.predict("m", wl(), service_time_hint_s=0.05)
        replicas = cloud.endpoints["m"]["replicas"]
        print(f"\n[SI4 cloud]            {url} "
              f"(replicas={replicas});", m4.summary())
        rep = build_green_report(dep4, m4)
        print(rep.table())
        out["si4"] = dict(_served(m4, rep), url=url, replicas=replicas)
        del cloud
    return out


if __name__ == "__main__":
    main()
