"""A traced chaos run on the PyTorch port: the observability subsystem end
to end.

The counterpart of ``examples/serve_traced.py``.  One flip of
``ServingSpec.telemetry.enabled`` turns the chaos demo of
``examples/torch_serve_chaos.py`` into a fully traced run — same spec, same
seeded crash barrage, bit-identical joules/grams/latencies (tracing is a
pure observer) — and exports a Chrome/Perfetto ``trace_event`` JSON where
the failure story is *visible*: per-replica billing spans, the crash,
``crash_loss``, ``retry`` and ``failover`` instants, every request an async
span with its queue_wait / prefill / decode phases, and counter tracks of
pool sizes, backlogs and per-zone carbon intensity.  The trace goes to
``examples_out/BENCH_trace.json`` unless ``--out`` moves it.  Step times are
calibrated on the device (the GPU unless ``--device cpu``) from random
weights drawn from ``--seed``.

    PYTHONPATH=src python examples/torch_serve_traced.py --out trace.json
    # -> https://ui.perfetto.dev  (Open trace file)
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_serve_chaos import ARCH, BULK_MAX_NEW, MAX_NEW, PROMPT_LEN  # noqa: E402
from torch_serve_chaos import spec_for, workload  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.devices import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving.api import ServingSession, TelemetrySpec  # noqa: E402
from repro_torch.serving.telemetry import validate_trace, write_trace  # noqa: E402
from repro_torch.serving.telemetry.export import to_perfetto  # noqa: E402

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples_out")
PHASES = ("queue_wait", "prefill", "xfer", "decode", "preempted")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "BENCH_trace.json"),
                    help="where to write the Perfetto trace JSON")
    ap.add_argument("--mode", default="crash",
                    choices=("healthy", "crash", "outage", "brownout"))
    ap.add_argument("--device", default=None,
                    help="the device to calibrate on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)

    cfg = get_arch(ARCH)
    params = init_params(cfg, ns.seed, device=device)
    session = ServingSession(device=device)

    spec = dataclasses.replace(
        spec_for(ns.mode),
        telemetry=TelemetrySpec(enabled=True)).validate()
    session.deploy(spec, params={"m": params})
    session.calibrate("llm", batch_sizes=range(1, 9),
                      prompt_len=PROMPT_LEN, max_new=MAX_NEW)
    session.calibrate("llm", batch_sizes=range(1, 9),
                      prompt_len=PROMPT_LEN, max_new=BULK_MAX_NEW)
    session.submit("llm", workload(cfg.vocab_size))
    report = session.run()
    ep = report.endpoints["llm"]

    rec = report.telemetry
    doc = to_perfetto(rec)
    errors = validate_trace(doc)
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    write_trace(ns.out, rec)

    print(f"mode={ns.mode}  requests={ep.n_requests}  "
          f"J={ep.j_measured:.2f} (lost {ep.j_lost:.2f})  "
          f"gCO2={ep.gco2_total:.4f}")
    print(f"trace: {len(doc['traceEvents'])} events, "
          f"{len(rec.sinks)} replica tracks, "
          f"{len(rec.requests)} request spans, "
          f"dropped={rec.dropped} -> {ns.out}")
    crash = [e for e in rec.events if e[0] == "inst"
             and e[3] in ("crash", "crash_loss", "retry", "failover")]
    markers = sorted({e[3] for e in crash})
    print("chaos markers: " + ", ".join(markers) if crash else "chaos markers: none")

    print(f"\n{'class':<12} {'phase':<11} {'n':>6} {'mean':>9} "
          f"{'p50':>9} {'p95':>9}")
    for cls, phases in sorted(ep.phase_breakdown.items()):
        for ph in PHASES:
            row = phases[ph]
            print(f"{cls:<12} {ph:<11} {row['n']:>6} "
                  f"{row['mean_s'] * 1e3:>8.2f}m {row['p50_s'] * 1e3:>8.2f}m "
                  f"{row['p95_s'] * 1e3:>8.2f}m")

    out = {"status": 0, "mode": ns.mode, "n_requests": ep.n_requests,
           "j_measured": ep.j_measured, "j_lost": ep.j_lost,
           "gco2_total": ep.gco2_total, "events": len(doc["traceEvents"]),
           "replica_tracks": len(rec.sinks), "request_spans": len(rec.requests),
           "dropped": rec.dropped, "chaos_markers": markers,
           "phase_breakdown": ep.phase_breakdown, "schema_errors": list(errors),
           "out": ns.out}
    if errors:
        print(f"\ntrace schema errors ({len(errors)}):")
        for e in errors[:10]:
            print(f"  {e}")
        out["status"] = 1
        return out
    print("\ntrace schema: OK")
    return out


if __name__ == "__main__":
    raise SystemExit(main()["status"])
