"""Multi-pod dry-run: prove the distribution config is coherent.

The counterpart of the JAX package's ``launch/dryrun.py``.  For every
(architecture x input shape) this traces the real step function once on the
production mesh (single-pod 16x16 and multi-pod 2x16x16, fake ranks of the
``fake`` process-group backend), with every argument a DTensor of fake local
shards laid out by ``distributed/meshes.py``; it records one rank's memory,
operations and collective traffic (``distributed/stats.py``) and writes one
JSON per combo under ``dryrun_out/`` (ignored by git).  No device memory is
allocated and no kernel is launched: the kernel wrappers' fake branches
(``kernels/fake.py``) stand in for the kernels.

``fits_80gb`` holds the peak a device against one H100's 80 GB
(``energy/hw.py:H100_SXM``); the JAX package held it against a TPU's 16 GB.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCHS, SHAPES, applicable, get_arch, get_shape
from repro_torch.distributed import meshes as M
from repro_torch.distributed import rules
from repro_torch.distributed.ctx import sharding_hints
from repro_torch.distributed.stats import (
    StepTrace,
    collective_stats,
    cost_stats,
    memory_stats,
)
from repro_torch.energy.hw import H100_SXM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import cache_struct, step_and_specs

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "dryrun_out")


def shardings_for(kind, cfg, args, mesh):
    """The placements of the step's arguments (a tree per argument)."""
    if kind == "train":
        o_spec = {
            "m": M.param_shardings(args[1]["m"], mesh),
            "v": M.param_shardings(args[1]["v"], mesh),
            "step": (Replicate(),) * mesh.ndim,
        }
        return (M.param_shardings(args[0], mesh), o_spec,
                M.batch_shardings(args[2], mesh))
    if kind == "prefill":
        return (M.param_shardings(args[0], mesh, mode="serve"),
                M.batch_shardings(args[1], mesh))
    # decode: serve-mode (TP-only) weights pay off when the batch spreads
    # work over the data axis; at B=1 (long_500k) the 2-D layout measured
    # better in the JAX package — keep it there
    B = args[2].shape[0]
    dp_n = M.axis_size(mesh, M.dp_axes(mesh))
    p_mode = "serve" if B >= dp_n else "train"
    return (M.param_shardings(args[0], mesh, mode=p_mode),
            M.cache_shardings(args[1], mesh, cfg),
            M.batch_shardings({"tokens": args[2]}, mesh)["tokens"])


def distribute(tree, placements, mesh):
    """Each fake tensor of ``tree`` as a DTensor of its local shard under
    ``placements`` (every dim it shards divides evenly)."""
    if isinstance(tree, dict):
        return {k: distribute(v, placements[k], mesh) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    shape = list(tree.shape)
    for m, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] //= mesh.size(m)
    with tree.fake_mode:
        local = torch.empty(shape, dtype=tree.dtype, device=tree.device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=tree.shape, stride=tree.stride())


def trace_step(cfg, shape, mesh, trace: Optional[StepTrace] = None):
    """Trace one step of (cfg, shape) on ``mesh`` into ``trace`` (a fresh
    ``StepTrace`` by default): (the trace, kind, seconds)."""
    rules.register()
    mode = FakeTensorMode()
    device = mesh.device_type
    dp = M.axis_size(mesh, M.dp_axes(mesh))
    step, structs, kind = step_and_specs(cfg, shape, dp=dp, mode=mode, device=device)
    args = tuple(distribute(a, s, mesh) for a, s in
                 zip(structs, shardings_for(kind, cfg, structs, mesh)))
    if kind == "prefill":
        # the step makes its cache: sharded as decode reads it, so that each
        # rank holds its shard (GSPMD shards the JAX package's fresh cache)
        cache = cache_struct(cfg, shape.global_batch, shape.seq_len, mode, device)
        cache_pl = M.cache_shardings(cache, mesh, cfg)
        inner = step

        def step(params, batch):
            return inner(params, batch, distribute(cache, cache_pl, mesh))
    del structs
    donate = {"train": (0, 1), "decode": (1,), "prefill": ()}[kind]
    roles = ("residual", "moe") if kind == "train" else ()
    trace = StepTrace() if trace is None else trace
    trace.hold_arguments(args, donate)
    t0 = time.perf_counter()
    grad = contextlib.nullcontext() if kind == "train" else torch.no_grad()
    # implicit_replication: a tensor the model makes itself (an arange, a
    # zeros of the global shape) is the same on every rank, so Replicate
    gspmd = rules.GspmdLike()
    with mode, rules.unseen_meta(trace), sharding_hints(mesh, roles=roles), trace, \
            gspmd, grad, implicit_replication():
        out = step(*args)
        trace.hold_outputs(out)
    trace.fallbacks = gspmd.fallbacks
    return trace, kind, time.perf_counter() - t0


def run_one(arch_name: str, shape_name: str, multi_pod: bool,
            out_dir: str = OUT_DIR) -> dict:
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
           "status": "skipped"}
    if not applicable(cfg, shape):
        rec["note"] = "skipped per DESIGN.md arch-applicability"
        return rec
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    trace, kind, t_trace = trace_step(cfg, shape, mesh)
    mem = memory_stats(trace)
    rec.update(
        status="ok", kind=kind, chips=mesh.size(),
        trace_s=round(t_trace, 2),
        memory=mem, cost=cost_stats(trace), collectives=collective_stats(trace),
        kernels=trace.kernels, fallbacks=trace.fallbacks,
        fits_80gb=mem["peak_bytes_per_device"] < H100_SXM.hbm_bytes,
    )
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch_name}_{shape_name}_{mesh_name}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ns = ap.parse_args(argv)

    archs = sorted(ARCHS) if (ns.all or ns.arch is None) else [ns.arch]
    shapes = sorted(SHAPES) if (ns.all or ns.shape is None) else [ns.shape]
    mesh_opts = {"single": [False], "multi": [True], "both": [False, True]}[ns.mesh]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in mesh_opts:
                tag = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                try:
                    rec = run_one(arch, shape, mp, ns.out)
                except Exception as e:  # noqa: BLE001 — report every combo, fail at the end
                    failures += 1
                    print(f"FAIL {tag}: {e}")
                    traceback.print_exc()
                    continue
                if rec["status"] == "skipped":
                    print(f"SKIP {tag}: {rec.get('note', '')}")
                    continue
                mem_gb = rec["memory"]["peak_bytes_per_device"] / 1024**3
                print(
                    f"OK   {tag}: kind={rec['kind']} "
                    f"mem/dev={mem_gb:.2f}GiB fits={rec['fits_80gb']} "
                    f"flops={rec['cost']['flops']:.3e} "
                    f"coll={rec['collectives']['total_bytes']:.3e}B "
                    f"trace={rec['trace_s']}s", flush=True)
    mesh_lib.release()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
