"""Interactive-preempts-batch, and prefill/decode disaggregation — one spec,
on the PyTorch port.

The counterpart of ``examples/serve_disagg.py``: two SLO classes on one
endpoint (``interactive`` chat with a TTFT budget, ``batch`` bulk with
none), served three ways from the same declarative
:class:`repro_torch.serving.api.ServingSpec`:

  1. a unified pool with a FIFO queue (the control);
  2. the same pool with the priority ladder + in-replica preemption — an
     interactive prefill pauses an in-flight batch decode, the pause/resume
     billed to the meter's ``preempt`` bucket;
  3. disaggregated prefill/decode pools with the KV handoff billed to
     ``xfer``.

Step times are calibrated on the device (the GPU unless ``--device cpu``)
from random weights drawn from ``--seed``.

    PYTHONPATH=src python examples/torch_serve_disagg.py
    PYTHONPATH=src python examples/torch_serve_disagg.py --device cpu
"""

import argparse
import dataclasses

from repro_torch.configs import get_arch
from repro_torch.devices import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.admission import DisaggSpec, PrioritySpec
from repro_torch.serving.api import (
    AutoscaleSpec,
    EndpointSpec,
    ServingSession,
    ServingSpec,
    SLOClass,
)
from repro_torch.workload.generators import bursty, poisson

ARCH = "minitron-4b-smoke"
PROMPT_LEN, MAX_NEW = 16, 6


def base_spec() -> ServingSpec:
    return ServingSpec(
        endpoints=(EndpointSpec(
            name="llm", arch=ARCH, model="m",
            policy="dynamic_batch", max_batch=8, batch_timeout_ms=10.0,
            max_seq=64,
            autoscale=AutoscaleSpec(enabled=False, replicas_hint=4),
            slo_classes={
                "chat": SLOClass(slo_ms=100.0, priority="interactive"),
                "bulk": SLOClass(priority="batch"),
            },
        ),),
        priority=PrioritySpec(enabled=True, preempt=False),
    )


def variant(name: str) -> ServingSpec:
    spec = base_spec()
    if name == "preempt":
        return dataclasses.replace(
            spec, priority=PrioritySpec(enabled=True, preempt=True,
                                        pause_ms=2.0, resume_ms=2.0))
    if name == "disagg":
        ep = dataclasses.replace(
            spec.endpoints[0],
            disagg=DisaggSpec(enabled=True, prefill_replicas=2,
                              decode_replicas=2, link_gbps=100.0,
                              link_latency_ms=0.05, link_power_w=8.0,
                              kv_bytes_per_token=2 * 32 * 8 * 128 * 2))
        return dataclasses.replace(spec, endpoints=(ep,))
    return spec


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

    chat = poisson(800, PROMPT_LEN, MAX_NEW, cfg.vocab_size,
                   rate_per_s=40.0, seed=21)
    bulk = bursty(800, PROMPT_LEN, MAX_NEW, cfg.vocab_size,
                  rate_per_s=25.0, burst_n=120, burst_every_s=4.0,
                  burst_rate_per_s=500.0, seed=22, rid0=100_000)

    out = {}
    print(f"{'mode':<10} {'chat p95 TTFT':>14} {'bulk p95 done':>14} "
          f"{'J/token':>9} {'J preempt':>10} {'J xfer':>8}")
    for mode in ("unified", "preempt", "disagg"):
        spec = variant(mode).validate()
        session.deploy(spec, params={"m": params})
        session.calibrate("llm", batch_sizes=range(1, 9),
                          prompt_len=PROMPT_LEN, max_new=MAX_NEW)
        session.submit("llm", chat, slo_class="chat")
        session.submit("llm", bulk, slo_class="bulk")
        ep = session.run().endpoints["llm"]
        bulk_p95 = ep.metrics.latency_percentile(95, priority="batch")
        print(f"{mode:<10} "
              f"{ep.ttft_p95_by_class['interactive'] * 1e3:>12.1f}ms "
              f"{bulk_p95 * 1e3:>12.1f}ms "
              f"{ep.j_per_token:>9.4f} {ep.j_preempt:>10.2f} "
              f"{ep.j_xfer:>8.2f}")
        out[mode] = {"chat_p95_ttft_s": ep.ttft_p95_by_class["interactive"],
                     "bulk_p95_latency_s": bulk_p95, "j_per_token": ep.j_per_token,
                     "j_preempt": ep.j_preempt, "j_xfer": ep.j_xfer}
    return out


if __name__ == "__main__":
    main()
