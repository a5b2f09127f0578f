"""The device trace of a run's traced window, read with ``torch.profiler``.

``Tracer`` starts the profiler (host and device activity) between two slices
of the window and stops it at the window's end.  ``summary`` reduces the
trace to what the metric readers and the result's ``breakdown`` take:
- ``busy_s``: the union of the intervals in which a kernel, copy or memset
  ran on the device;
- ``kernel_s``: device seconds of the port's kernels by family, told apart by
  their names with the ``KERNELS`` patterns of the configuration's kind
  (``servebench/counts/<kind>.py``), which the ``Tracer`` is given;
- ``device_ops``: the ten operations by name that took the most device time;
- ``idle_gaps``: the ten longest spans with nothing on the device, each named
  by the innermost host span of the harness open across its middle
  (``prefill_one``, ``decode_batch``, ``insert``, ``scheduler``), or
  ``harness`` outside them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HOST_SPANS = ("prefill_one", "decode_batch", "insert", "scheduler")


def family(name: str, kernels):
    """The key of the first (key, pattern) of ``kernels`` whose pattern
    finds the device kernel's ``name``, or None."""
    for key, pattern in kernels:
        if pattern.search(name):
            return key
    return None


def short_name(name: str) -> str:
    name = name.removeprefix("void ")
    cut = min([i for i in (name.find("<"), name.find("(")) if i > 0] or [len(name)])
    return name[:cut].replace("(anonymous namespace)::", "")[:80]


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Tracer:
    """The profiler over a traced window; ``kernels``: the (family key,
    pattern) pairs that sort its kernel time."""

    def __init__(self, kernels):
        self.kernels = kernels

    def warm_up(self) -> None:
        """Start and stop the profiler once: its first start loads the
        tracing library, which must not fall inside the window."""
        self.start()
        self.stop()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def summary(self, window_s: float) -> Dict[str, object]:
        from torch.autograd import DeviceType

        device: List[Tuple[int, int, str]] = []
        spans: List[Tuple[int, int, str]] = []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation() or name in HOST_SPANS or end <= start:
                    continue
                device.append((start, end, name))
            elif name in HOST_SPANS:
                spans.append((start, end, name))
        busy = merge([(a, b) for a, b, _ in device])
        by_kernel: Dict[str, float] = {}
        kernel_s: Dict[str, float] = {}
        for a, b, name in device:
            s = (b - a) / 1e9
            key = short_name(name)
            by_kernel[key] = by_kernel.get(key, 0.0) + s
            fam = family(name, self.kernels)
            if fam is not None:
                kernel_s[fam] = kernel_s.get(fam, 0.0) + s
        gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                for i in range(len(busy) - 1)]
        gaps.sort(reverse=True)
        named = []
        for length, a, b in gaps[:10]:
            mid = (a + b) // 2
            inner = [(e - s, n) for s, e, n in spans if s <= mid <= e]
            named.append([min(inner)[1] if inner else "harness", length / 1e9])
        return {
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": window_s,
            "kernel_s": kernel_s,
            "device_ops": sorted(([k, v] for k, v in by_kernel.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": named,
            "device_events": len(device),
        }
