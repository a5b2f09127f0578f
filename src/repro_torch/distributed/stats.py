"""Roofline inputs of one traced step: collectives, operations, bytes, memory.

The counterpart of the JAX package's ``distributed/xla_stats.py``.  There
is no XLA here: the dry-run runs the step once on fake local shards under a
``StepTrace``, a dispatch mode that sees every operation one rank runs on
its shards (a DTensor operation is let through first, so the mode sees the
local operations and the collectives it turns into).  The three functions
keep the JAX package's names and record keys and read the trace:

  * ``collective_stats``: per kind, the OPERAND bytes of the collectives
    one rank issues, and their count, under the JAX package's convention
    (an all-gather's operand is its result / g, a reduce-scatter's its
    result x g, an all-reduce's its result): each functional collective's
    input, which is that operand;
  * ``cost_stats``: ``flops``, two per multiply-add of every product on the
    local shards (torch's flop formulas, and the kernels' own counts from
    ``kernels/fake.py``), so per device; ``bytes_accessed``, the bytes each
    operation reads and writes on its local shards (views move none).
    This is not XLA's number: XLA counts its fused program, this counts
    every eager operation's operands and results;
  * ``memory_stats``: argument, output, alias and temp bytes and
    ``peak_bytes_per_device`` = arguments + outputs + temps - aliases, the
    JAX package's formula.  Arguments are the local shards of the step's
    inputs, aliases the donated arguments an output is (train: params and
    optimizer state, decode: the cache), temps the peak, over the step, of
    the live bytes that are neither arguments nor outputs, tracked per
    storage with weakref finalizers.
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_KIND = {"all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced":
         "all-gather", "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all", "isend": "collective-permute"}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional")
_NO_BYTES = ("empty", "empty_strided", "new_empty", "new_empty_strided", "detach",
             "lift_fresh", "alias", "wait_tensor")


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class StepTrace(TorchDispatchMode):
    """Counts one rank's work while a step runs on fake local shards."""

    def __init__(self):
        super().__init__()
        self.collectives = {k: 0.0 for k in _COLLECTIVES}
        self.collective_count = 0
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._ids = WeakIdKeyDictionary()   # storage -> its number
        self._size: Dict[int, int] = {}     # number -> bytes
        self._events: list = []             # (number, +bytes at alloc / -bytes at free)
        self.arguments: set = set()
        self.donated: set = set()
        self.outputs: set = set()
        self.paused = 0     # > 0: ops pass uncounted (``rules.unseen_meta``)

    # -- storages -----------------------------------------------------------
    def _track(self, t) -> int:
        st = t.untyped_storage()
        i = self._ids.get(st)
        if i is None:
            i = len(self._size)
            self._ids[st] = i
            self._size[i] = st.nbytes()
            self._events.append((i, st.nbytes()))
            weakref.finalize(st, self._events.append, (i, -st.nbytes()))
        return i

    def hold_arguments(self, args, donate: Iterable[int] = ()) -> None:
        """The step's inputs (their local shards), resident before it runs;
        ``donate``: the indices of the arguments the step may write over."""
        for n, arg in enumerate(args):
            ids = {self._track(_local(t)) for t in _tensors(arg)}
            self.arguments |= ids
            if n in tuple(donate):
                self.donated |= ids

    def hold_outputs(self, out) -> None:
        self.outputs = {self._track(_local(t)) for t in _tensors(out)}

    # -- counting -------------------------------------------------------------
    def count_kernel(self, name: str, flops: float, nbytes: int, out_bytes: int = 0) -> None:
        """A kernel wrapper's fake branch reports its call here (``out_bytes``:
        its results' share of ``nbytes``)."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes_accessed += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # let DTensor run; its local ops come back here
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        ins = _tensors((args, kwargs))
        if func.namespace in _NAMESPACES:
            kind = _KIND.get(name)
            if kind is not None:
                self.collectives[kind] += _nbytes(ins)
                self.collective_count += 1
            return out
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_BYTES:
            self.bytes_accessed += _nbytes(ins) + _nbytes(outs)
        return out

    # -- memory ---------------------------------------------------------------
    def temp_peak(self) -> int:
        skip = self.arguments | self.outputs
        live = peak = 0
        for i, n in self._events:
            if i not in skip:
                live += n
                peak = max(peak, live)
        return peak


def collective_stats(trace: StepTrace) -> Dict[str, float]:
    """Per-kind and total OPERAND bytes of one rank's collectives; multiply
    by the device count for global traffic."""
    out = dict(trace.collectives)
    out["count"] = trace.collective_count
    out["total_bytes"] = sum(out[k] for k in _COLLECTIVES)
    return out


def cost_stats(trace: StepTrace) -> Dict[str, float]:
    """flops / bytes of one rank's step (see the module docstring)."""
    return {"flops": trace.flops, "bytes_accessed": trace.bytes_accessed,
            "raw_keys": []}


def memory_stats(trace: StepTrace) -> Dict[str, float]:
    size = trace._size
    out = {
        "generated_code_size_in_bytes": 0.0,
        "argument_size_in_bytes": float(sum(size[i] for i in trace.arguments)),
        "output_size_in_bytes": float(sum(size[i] for i in trace.outputs)),
        "alias_size_in_bytes": float(sum(size[i] for i in trace.outputs & trace.donated)),
        "temp_size_in_bytes": float(trace.temp_peak()),
    }
    # peak per-device bytes: args + outputs + temps - aliased
    out["peak_bytes_per_device"] = (
        out["argument_size_in_bytes"] + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
    return out
