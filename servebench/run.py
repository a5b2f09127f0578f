"""Run one cell of the serving benchmark once and print its result line.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout; its configuration and traffic mix are found by name
(``servebench/configs/<config>.json``, ``servebench/traffic/<mix>.json``),
the configuration's reference and work counts by its kind
(``servebench/kinds.py``), and each metric by its reader
(``servebench/metrics/<metric>.py``).  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from the same kind of run whose
last seconds are also profiled.  The last line of standard output is one
JSON object; the numbers compared to decide ``correct`` are the last lines
of standard error.  Exit 0 only with a result; no card, too few cards, a
missing program, or the JAX package loaded in this process give no result
and another code.

Besides, for the bench's own measurements: ``--sweep r1,r2,...`` serves
one window at each arrival rate on one set-up and prints what the knee
search reads, with no result; ``--control`` puts the control precision's
tokens in the program's place on the same sample, so that ``correct`` is
the control's verdict (the program's own numbers stay in the diagnostics).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "servebench")
# run as a script, this folder is first on the path: its modules are
# imported as ``servebench.*`` only, never by their bare names
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACED_S = 4.0         # the profiled tail of a traced run, at most a quarter of it


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` with its configuration, mix and metric lists; a
    configuration whose kind has not its two files stops here."""
    from servebench import kinds

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    try:
        kinds.paths(config, root)
    except LookupError as e:
        raise SystemExit(f"workload {name!r}: {e}") from None
    with open(os.path.join(root, "servebench", "traffic", f"{cell['traffic']}.json")) as f:
        mix = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", cells)]

    return {"cell": cell, "config": config, "mix": mix,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def reader(metric: str, root: str = ROOT):
    from servebench.kinds import load_file

    path = os.path.join(root, "servebench", "metrics", f"{metric}.py")
    return load_file(path, f"servebench_metric_{metric}").read


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sweep(run, args, energy, sync) -> int:
    """One window a rate of ``--sweep`` on the same set-up: what the knee
    search reads, one JSON line each on standard error.  Prints no result."""
    from servebench import readings

    for rate in (float(r) for r in args.sweep.split(",")):
        run.mix = dict(run.mix, rate_per_s=rate)
        seg = run.window(args.seconds, energy, sync)[0]
        steps = [s for s in seg.steps if s["kind"] == "decode"]
        print(json.dumps({
            "rate_per_s": rate, "tokens_per_s": seg.tokens / seg.wall_s,
            "ttft_p95_ms": readings.p95_ms(readings.ttft_s(seg)),
            "tpot_p95_ms": readings.p95_ms(readings.tpot_s(seg)),
            "arrived": len(seg.arrivals), "done": len(seg.done),
            "pending_at_close": run.pending_at_close,
            "timeline_s": seg.virt1 - seg.virt0, "wall_s": seg.wall_s,
            "busy_s": sum(s["dt"] for s in seg.steps),
            "slots_busy": (100.0 * sum(len(s["live_ctx"]) for s in steps)
                           / max(len(steps) * run.slots, 1))}), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated arrival rates: one window each, no result")
    args = ap.parse_args(argv)

    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    spec = load_cell(args.workload)
    cell, config, mix = spec["cell"], spec["config"], spec["mix"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("repro_torch") is None:
        print("the program under test, repro_torch (src/repro_torch), is not in this checkout",
              file=sys.stderr)
        return 4
    from servebench import card as card_mod
    from servebench import check, readings
    from servebench.serve import Cell
    from servebench.devtrace import Tracer

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    peaks = card_mod.peaks(name)
    energy = card_mod.CardEnergy(0)
    run = Cell(config, mix, args.seed, device, trace=bool(args.trace))
    run.setup()
    sync = torch.cuda.synchronize
    if args.sweep:
        return sweep(run, args, energy, sync)
    tracer = Tracer(run.counts.KERNELS) if args.trace else None
    if tracer is not None:
        tracer.warm_up()
    traced_s = min(TRACED_S, args.seconds / 4) if args.trace else 0.0
    segments = run.window(args.seconds, energy, sync, tracer, traced_s)
    run.setup_s = run.window_open - T_START
    memory_peak = torch.cuda.max_memory_allocated(0)
    run.main = segments[0]
    run.traced = segments[1] if args.trace else None
    run.device_trace = tracer.summary(run.traced.wall_s) if args.trace else None
    run.peaks = peaks

    metrics = {}
    for m in spec["per_layer" if args.trace else "end_to_end"]:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the reference, once the program's state is freed
    run.free()
    torch.cuda.empty_cache()
    picked = check.sample(run.finished, args.seed)
    limits = config["check"]
    if picked:
        numbers = check.gaps(config, run.weights, picked, run.prompts, device)
        if args.control:
            numbers = dict(check.control_gaps(config, run.weights, picked, run.prompts, device),
                           program=numbers)
        correct, shown = check.verdict(numbers, limits)
    else:
        numbers, correct = {"requests": 0}, False
        shown = {k: {"value": None, "limit": v} for k, v in limits.items()}

    bad = loaded_forbidden()
    if bad:
        print(f"the JAX package or JAX is loaded in this process: {bad}", file=sys.stderr)
        return 3
    power_limit = energy.power_limit_w()
    energy.close()
    diag = {"card": name, "power_limit_w": power_limit,
            "graphs": [run.graphs_after_warm_up, run.graphs_in_window],
            "window_s": run.main.wall_s + (run.traced.wall_s if run.traced else 0.0),
            "steps": len(run.main.steps), "finished": len(run.finished),
            "offered": len(run.offered), "pending_at_close": run.pending_at_close,
            "tails_ms": {"ttft_p95": readings.p95_ms(readings.ttft_s(run.main)),
                         "tpot_p95": readings.p95_ms(readings.tpot_s(run.main))},
            "check": numbers}
    if run.device_trace:
        diag["device_events"] = run.device_trace["device_events"]
        diag["kernel_s"] = run.device_trace["kernel_s"]
    print(json.dumps(diag), file=sys.stderr)
    attempted = len(run.offered) - run.core_responses0
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu", "kind": name, "count": cell["chips"],
                         "memory_peak_bytes": memory_peak}}
    if args.trace:
        t = run.device_trace
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["check"] = shown
    for key, v in shown.items():
        print(f"{key} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
