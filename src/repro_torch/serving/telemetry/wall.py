"""Wall-clock spans of the serving core's executed work.

The virtual-clock recorder (``recorder.py``) says where a request's
simulated joules and milliseconds went; this log says where the host's real
time went while the engine ran.  ``SchedulerCore`` owns one
:class:`WallLog` (``core.wall_log``), made once and kept across runs, and
the continuous-batching policy opens a span at each boundary of its step
(``repro_torch.step``, ``repro_torch.admit``, ``repro_torch.drain``, ``repro_torch.prefill``,
``repro_torch.insert``, ``repro_torch.decode``, ``repro_torch.token_read``, ``repro_torch.retire``).

A span holds its name, its start and end in ``time.perf_counter_ns()``, the
sequence number of the span open around it (``parent``, -1 at the top), the
request it serves (``rid``, -1 for none), its tokens, the prompt bucket a
prefill was padded to, the instant a prefill's work was all enqueued
(``enqueued_ns``), whether a prefill replayed a captured graph (``graph``:
1, or 0 for an eager or capturing call) and the device time of a decode's
graph replay (``device_ns``); -1 where a field does not apply.  The log is
a ring of the last :data:`CAPACITY` spans; older ones are counted in
``dropped``.

Always on: a span costs two clock reads and a small object.  While a torch
profiler runs, each span also enters ``torch.profiler.record_function``
under its own name, so it lands on the profiler's timeline; with none
running, no profiler code is entered.  ``epoch_offset_ns`` converts a
span's stamps to the profiler's time base (the Unix epoch):
``span.start_ns + log.epoch_offset_ns``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 65536


class Span:
    """One timed interval; a context manager that closes itself."""

    __slots__ = ("seq", "name", "start_ns", "end_ns", "parent", "rid", "tokens",
                 "bucket", "enqueued_ns", "graph", "device_ns", "_log", "_rf")

    def __init__(self, log: "WallLog", seq: int, name: str, parent: int, rid: int):
        self.seq = seq
        self.name = name
        self.parent = parent
        self.rid = rid
        self.tokens = 0
        self.bucket = -1
        self.enqueued_ns = -1
        self.graph = -1
        self.device_ns = -1
        self.end_ns = -1
        self._log = log
        self._rf = None
        self.start_ns = time.perf_counter_ns()      # simlint: allow(wall-clock)
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(name)
            self._rf.__enter__()

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def enqueued(self) -> None:
        """Stamp the instant the span's device work was all enqueued."""
        self.enqueued_ns = time.perf_counter_ns()   # simlint: allow(wall-clock)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()        # simlint: allow(wall-clock)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self._log._open.pop()


class WallLog:
    """A bounded ring of :class:`Span` in the order they were opened."""

    def __init__(self):
        self.count = 0                   # spans opened, ever
        self._ring: deque = deque(maxlen=CAPACITY)
        self._open: List[Span] = []
        self.epoch_offset_ns = (time.time_ns()                  # simlint: allow(wall-clock)
                                - time.perf_counter_ns())       # simlint: allow(wall-clock)

    @property
    def dropped(self) -> int:
        return self.count - len(self._ring)

    def span(self, name: str, rid: int = -1) -> Span:
        """Open a span inside the innermost open one; use it in ``with``."""
        parent = self._open[-1].seq if self._open else -1
        sp = Span(self, self.count, name, parent, rid)
        self.count += 1
        self._ring.append(sp)
        self._open.append(sp)
        return sp

    def spans(self, t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> List[Span]:
        """The kept spans, oldest first; with bounds, those that start in
        ``[t0_ns, t1_ns]`` (``perf_counter_ns`` instants)."""
        if t0_ns is None:
            return list(self._ring)
        return [s for s in self._ring if t0_ns <= s.start_ns <= t1_ns]
