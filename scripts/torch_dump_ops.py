"""Per-operation byte totals of one dry-run step on the PyTorch port — the
profile for dry-run hill-climbing.

The counterpart of ``scripts/dump_ops.py``, which reads XLA's compiled
program.  Here the step of (arch x shape), cut to ``--layers`` layers, is
traced as ``launch/dryrun.py`` traces it: on DTensors of fake shards over
the production mesh's fake ranks (``--mesh single``: 16x16, ``multi``:
2x16x16), so nothing is allocated and nothing launched.  A
``distributed/stats.py:StepTrace`` counts one rank's work; this script's
subclass also totals, per operation, the bytes of the results it makes on
the local shards (views, empties and the step's inputs make none; a kernel's
fake branch reports its outputs; a collective is named by its kind).

Prints the flops and bytes a device, the total result bytes, and the top
``--top`` operations by result bytes with their counts.

    PYTHONPATH=src python scripts/torch_dump_ops.py --arch minitron-4b --shape decode_32k
    PYTHONPATH=src python scripts/torch_dump_ops.py --arch rwkv6-3b --shape train_4k --device cpu
"""

from __future__ import annotations

import argparse
import collections
import dataclasses

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.devices import resolve_device
from repro_torch.distributed import stats
from repro_torch.distributed.stats import StepTrace, cost_stats
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import trace_step


class OpTrace(StepTrace):
    """A ``StepTrace`` that also totals each operation's result bytes."""

    def __init__(self):
        super().__init__()
        self.sizes = collections.Counter()
        self.counts = collections.Counter()

    def count_kernel(self, name, flops, nbytes, out_bytes=0):
        super().count_kernel(name, flops, nbytes, out_bytes)
        self.sizes[name] += out_bytes
        self.counts[name] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or self.paused \
                or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        name = func._overloadpacket.__name__
        if func.namespace in stats._NAMESPACES:
            name = stats._KIND.get(name)
            if name is None:
                return out
        elif func.is_view or name in stats._NO_BYTES:
            return out
        self.sizes[name] += stats._nbytes(stats._tensors(out))
        self.counts[name] += 1
        return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--device", default=None,
                    help="the GPU unless 'cpu' (the trace launches nothing on either)")
    ns = ap.parse_args(argv)
    resolve_device(ns.device)

    cfg = get_arch(ns.arch)
    changes = dict(num_layers=ns.layers, unroll_layers=True)
    if cfg.family == "audio":
        changes["encoder_layers"] = ns.layers
    cfg = dataclasses.replace(cfg, **changes)
    shape = get_shape(ns.shape)
    mesh = mesh_lib.make_production_mesh(multi_pod=ns.mesh == "multi")
    try:
        trace, kind, _ = trace_step(cfg, shape, mesh, OpTrace())
    finally:
        mesh_lib.release()
    ca = cost_stats(trace)
    print(f"flops/dev {ca['flops']:.4e}  bytes/dev {ca['bytes_accessed']:.4e}")

    total = sum(trace.sizes.values())
    print(f"top-level result bytes total {total/2**30:.2f} GiB/dev")
    top = trace.sizes.most_common(ns.top)
    for op, b in top:
        print(f"  {op:<26}{b/2**30:9.3f} GiB  n={trace.counts[op]}")
    return {"arch": ns.arch, "shape": ns.shape, "mesh": ns.mesh, "layers": ns.layers,
            "kind": kind, "flops": ca["flops"], "bytes_accessed": ca["bytes_accessed"],
            "result_bytes": total,
            "top": [{"op": op, "bytes": b, "count": trace.counts[op]} for op, b in top]}


if __name__ == "__main__":
    main()
