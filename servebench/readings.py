"""What the metric readers share: the quantities of a window's records.

A reader (``servebench/metrics/<metric>.py``) defines ``read(run)`` and
returns a number, or None where its window holds nothing to read.  ``run``
carries ``main`` (the window, or a traced run's unprofiled part of it),
``traced`` (a traced run's profiled tail, else None), ``device_trace``
(``servebench.devtrace`` summary of that tail, else None), ``setup_s``,
``peaks`` (the card's, ``servebench.card.PEAKS``), ``model`` (the
configuration's ``model`` object), ``counts`` (the work-count module of its
kind, ``servebench/counts/<kind>.py``), ``fmt``, ``slots`` and ``max_seq``.
"""

from __future__ import annotations

from typing import List, Optional

from servebench.stats import percentile


def ttft_s(seg) -> List[float]:
    """First token minus arrival of every request that arrived in the
    segment; one still without a first token counts up to the segment's end."""
    return [min(seg.first.get(rid, seg.virt1), seg.virt1) - a
            for rid, a in seg.arrivals.items()]


def tpot_s(seg) -> List[float]:
    """(done - first token) / (tokens - 1) of every request completed in it."""
    return [(r.done_s - r.first_token_s) / (len(r.tokens) - 1)
            for r in seg.done if len(r.tokens) > 1]


def p95_ms(values: List[float]) -> Optional[float]:
    return percentile(values, 95) * 1e3 if values else None


def mean_ms(seg, kind: str) -> Optional[float]:
    dts = [s["dt"] for s in seg.steps if s["kind"] == kind]
    return sum(dts) / len(dts) * 1e3 if dts else None


def roofline(run, family: str) -> Optional[float]:
    """Bound time over measured device time of one kernel family in the
    traced tail, in percent; None where the family never ran there."""
    t = run.device_trace
    if t is None or t["kernel_s"].get(family, 0.0) <= 0.0:
        return None
    peaks = run.peaks
    bound = 0.0
    for step in run.traced.steps:
        w = run.counts.kernel_work(run.model, run.fmt, step, run.max_seq).get(family)
        if w is not None:
            bound += max(w[0] / peaks["hbm_bytes_s"], w[1] / peaks["bf16_flops"])
    return 100.0 * bound / t["kernel_s"][family]
