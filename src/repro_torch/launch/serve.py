"""Serving launcher: stand up a deployment (any SI x TD combo) and drive it
with a synthetic workload -- a thin adapter over the declarative
:class:`repro_torch.serving.api.ServingSpec` /
:class:`~repro_torch.serving.api.ServingSession` API: the CLI flags are
translated into one spec (printed as JSON, round-trippable), deployed on the
GPU (or on the CPU with ``--device cpu``), and served; the report decomposes
energy per design decision (including the simulated TD1 container overhead).
The weights are random, drawn from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \\
      --si si3_dl_server --processing continuous_batch --requests 10
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_arch
from repro_torch.core.add import (
    Containerization,
    Deployment,
    ModelFormat,
    Protocol,
    RequestProcessing,
    ServingInfrastructure,
)
from repro_torch.devices import resolve_device
from repro_torch.energy.report import build_green_report
from repro_torch.models import init_params
from repro_torch.serving.api import ServingSession, ServingSpec, endpoint_from_deployment
from repro_torch.serving.codecs import make_codec
from repro_torch.serving.container import generate_artifact
from repro_torch.serving.request import Request, synth_workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--si", default="si3_dl_server",
                    choices=[e.value for e in ServingInfrastructure])
    ap.add_argument("--processing", default="dynamic_batch",
                    choices=[e.value for e in RequestProcessing])
    ap.add_argument("--container", default="none",
                    choices=[e.value for e in Containerization])
    ap.add_argument("--format", default="rsm",
                    choices=[e.value for e in ModelFormat])
    ap.add_argument("--protocol", default="grpc_binary",
                    choices=[e.value for e in Protocol])
    ap.add_argument("--router", default="round_robin")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--emit-artifact", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the device to serve on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)

    arch = ns.arch + ("-smoke" if ns.smoke and not ns.arch.endswith("-smoke")
                      else "")
    cfg = get_arch(arch)
    dep = Deployment(
        arch=arch,
        si=ServingInfrastructure(ns.si),
        containerization=Containerization(ns.container),
        model_format=ModelFormat(ns.format),
        request_processing=RequestProcessing(ns.processing),
        protocol=Protocol(ns.protocol),
        max_batch=1 if ns.processing == "realtime" else ns.max_batch,
        max_seq=ns.max_seq,
        router=ns.router,
    ).require_valid()
    print(dep.describe())
    if ns.emit_artifact:
        print(generate_artifact(dep))

    # ONE declarative spec: every CLI flag lands in a named, serializable
    # field — what you see printed here is exactly what runs (and exactly
    # what ServingSpec.from_json would reconstruct).  step_cache=False: the
    # launcher demos real model execution per request, never token replay.
    ep_spec = dataclasses.replace(
        endpoint_from_deployment(
            "m", dep, autoscale_enabled=(
                dep.si == ServingInfrastructure.SI4_CLOUD_SERVICE)),
        step_cache=False)
    spec = ServingSpec(endpoints=(ep_spec,), router=ns.router).validate()
    print(spec.to_json(indent=1))

    params = init_params(cfg, ns.seed, device=device)
    session = ServingSession(device=device)
    session.deploy(spec, params={"m": params})
    session.engine("m").warmup(dep.max_batch, 16)
    wl = synth_workload(ns.requests, 14, 6, cfg.vocab_size,
                        rate_per_s=ns.rate, seed=0)
    # TD4 wire round-trip: requests travel through the chosen protocol's
    # codec before admission, responses after — so --protocol is exercised,
    # not just recorded in the spec
    codec = make_codec(dep.protocol.value)
    wire_in = [(r.arrival_s,
                codec.encode_request(r.rid, r.prompt, r.max_new_tokens))
               for r in wl]
    decoded = []
    for arrival, data in wire_in:
        rid, tokens, max_new = codec.decode_request(data)
        decoded.append(Request(rid=rid, prompt=tokens, max_new_tokens=max_new,
                               arrival_s=arrival))
    session.submit("m", decoded)
    report = session.run()
    ep = report.endpoints["m"]
    wire_out = [codec.encode_response(r.rid, r.tokens)
                for r in ep.metrics.responses]
    print(ep.metrics.summary())
    print(f"wire bytes: in={sum(len(d) for _, d in wire_in)} "
          f"out={sum(len(d) for d in wire_out)} ({dep.protocol.value})")
    print(f"decisions: {ep.decisions}")
    print(f"energy: measured={ep.j_measured:.3f}J "
          f"(active {ep.j_active:.3f} + idle {ep.j_idle:.3f}) "
          f"+ container overhead {ep.j_container_overhead:.3f}J (simulated) "
          f"= billed {ep.j_billed:.3f}J "
          f"-> {ep.j_per_token:.6f} J/token")
    print(build_green_report(dep, ep.metrics).table())


if __name__ == "__main__":
    main()
