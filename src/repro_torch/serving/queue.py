"""Index-cursor admission queue: the event loop's hot data structure.

``SchedulerCore`` used to keep its arrival backlog as a plain sorted list and
pay O(n) per scheduling event three different ways: ``pop_next`` removed from
the middle with ``list.pop(i)``, the priority ladder re-scanned the arrival
prefix on every admission, and ``pending_within`` copied the whole unpopped
tail for every SLO-aware sizing step.  At ~10k requests per replica that was
tolerable; at the million-request frontier it dominates the run.

:class:`PendingQueue` keeps the same *semantics* bit-identically (same
tie-breaks, same ladder ordering, same FIFO-within-class order — property
tested against a reference copy of the old implementation in
``tests/test_queue_equivalence.py``) with amortized O(1)/O(log n) events:

  * one arrival-sorted array (``_arr``) with a parallel float array of
    arrival times (``_times``) for bisect;
  * a head cursor plus a lazy-deletion bitmap (``_popped``) instead of
    physical mid-list removal — a ladder pop flips one byte;
  * per-priority-rung index lists with their own head cursors, so the most
    urgent visible arrival is found by comparing at most one candidate per
    rung instead of scanning the arrival prefix.

Rung structures are built only when an admission ladder is configured: the
FIFO path never classifies priorities (matching the old core, which only
called :func:`priority_level` under a ladder — unknown priority names must
not raise on the FIFO path).

Ordering invariants the equivalence proof rests on:

  * ``_times[_head:]`` is non-decreasing.  In-order ``push`` appends;
    out-of-order ``push`` (fleet KV-handoff decode legs, deferral releases)
    bisects from ``_head`` — exactly where the old list insorted — and
    rebuilds the rung index lists from ``_head``, which costs no more than
    the old per-offer key-slice + ``list.insert``.
  * within a rung, index order == (arrival_s, insertion-seq) order, so the
    rung head is the rung's minimum arrival; equal-arrival ties are resolved
    by scanning the (contiguous) exact-tie run for the smallest rid — the
    old full-scan min over ``(level, arrival, rid)`` / ``(arrival, level,
    rid)`` keys decomposes into exactly this per-rung candidate comparison.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Iterable, List, Optional

from repro_torch.serving.admission.priority import PRIORITY_LEVELS, priority_level
from repro_torch.serving.request import Request

_N_LEVELS = max(PRIORITY_LEVELS.values()) + 1


class PendingQueue:
    """Arrival-sorted backlog with O(1) FIFO pops and O(#rungs) ladder pops."""

    __slots__ = ("_arr", "_times", "_popped", "_head", "_rungs", "_rheads",
                 "_use_rungs")

    def __init__(self, workload: Iterable[Request], *,
                 use_rungs: bool = False) -> None:
        # sorted() is stable: equal arrivals keep insertion order, matching
        # the old ``sorted(workload, key=arrival_s)`` list exactly
        arr = sorted(workload, key=lambda r: r.arrival_s)
        self._arr: List[Request] = arr
        self._times: List[float] = [r.arrival_s for r in arr]
        self._popped = bytearray(len(arr))
        self._head = 0
        self._use_rungs = use_rungs
        self._rungs: List[List[int]] = []
        self._rheads: List[int] = []
        if use_rungs:
            self._build_rungs()

    # -- rung index maintenance ----------------------------------------------
    def _build_rungs(self) -> None:
        rungs: List[List[int]] = [[] for _ in range(_N_LEVELS)]
        popped = self._popped
        for i in range(self._head, len(self._arr)):
            if not popped[i]:
                rungs[priority_level(self._arr[i].priority)].append(i)
        self._rungs = rungs
        self._rheads = [0] * _N_LEVELS

    def _rung_candidate(self, lv: int, limit: float, strict: bool):
        """``(arrival, rid, index)`` of rung ``lv``'s most urgent entry whose
        arrival is ``< limit`` (strict) / ``<= limit``, or None."""
        rung = self._rungs[lv]
        popped = self._popped
        n = len(rung)
        h = self._rheads[lv]
        while h < n and popped[rung[h]]:
            h += 1
        self._rheads[lv] = h
        if h >= n:
            return None
        i = rung[h]
        t0 = self._times[i]
        if (t0 >= limit) if strict else (t0 > limit):
            return None
        # exact-arrival ties within the rung resolve by smallest rid; the
        # tie run is contiguous from the head because the rung is in index
        # (hence arrival) order
        best_rid = self._arr[i].rid
        best_idx = i
        for j in range(h + 1, n):
            k = rung[j]
            if popped[k]:
                continue
            if self._times[k] != t0:
                break
            rid = self._arr[k].rid
            if rid < best_rid:
                best_rid, best_idx = rid, k
        return (t0, best_rid, best_idx)

    def _pop_at(self, idx: int) -> Request:
        self._popped[idx] = 1
        if idx == self._head:
            self._head = idx + 1
        return self._arr[idx]

    # -- FIFO face ------------------------------------------------------------
    def _advance_head(self) -> None:
        h, n = self._head, len(self._arr)
        popped = self._popped
        while h < n and popped[h]:
            h += 1
        self._head = h

    def __len__(self) -> int:
        self._advance_head()
        return len(self._arr) - self._head - \
            sum(self._popped[self._head:])

    def has_pending(self) -> bool:
        self._advance_head()
        return self._head < len(self._arr)

    def peek(self) -> Optional[Request]:
        self._advance_head()
        if self._head < len(self._arr):
            return self._arr[self._head]
        return None

    def pop(self) -> Request:
        self._advance_head()
        req = self._arr[self._head]      # IndexError when empty, like list
        self._popped[self._head] = 1
        self._head += 1
        return req

    def pending_within(self, t: float) -> List[Request]:
        """Unpopped arrivals with ``arrival_s <= t``, in queue order — a
        bisected slice, not a scan of the whole tail."""
        self._advance_head()
        h = self._head
        hi = bisect_right(self._times, t, h)
        if not self._use_rungs:
            return self._arr[h:hi]       # no mid-queue pops on the FIFO path
        arr, popped = self._arr, self._popped
        return [arr[i] for i in range(h, hi) if not popped[i]]

    # -- priority-ladder face --------------------------------------------------
    def peek_best(self, t: float) -> Optional[Request]:
        """The most urgent entry visible by ``t`` ((level, arrival, rid)
        order, visibility ``arrival_s <= t + 1e-12``), or None."""
        idx = self._best_visible_idx(t)
        return None if idx is None else self._arr[idx]

    def pop_best(self, t: float) -> Optional[Request]:
        idx = self._best_visible_idx(t)
        return None if idx is None else self._pop_at(idx)

    def _best_visible_idx(self, t: float) -> Optional[int]:
        limit = t + 1e-12
        best_key = None
        best_idx = None
        for lv in range(_N_LEVELS):
            c = self._rung_candidate(lv, limit, strict=False)
            if c is None:
                continue
            key = (lv, c[0], c[1])
            if best_key is None or key < best_key:
                best_key, best_idx = key, c[2]
        return best_idx

    def pop_preemptor(self, level: int, before_s: float) -> Optional[Request]:
        """Remove and return the earliest entry strictly more urgent than
        ``level`` arriving strictly before ``before_s`` ((arrival, level,
        rid) order), or None."""
        best_key = None
        best_idx = None
        for lv in range(min(level, _N_LEVELS)):
            c = self._rung_candidate(lv, before_s, strict=True)
            if c is None:
                continue
            key = (c[0], lv, c[1])
            if best_key is None or key < best_key:
                best_key, best_idx = key, c[2]
        if best_idx is None:
            return None
        return self._pop_at(best_idx)

    def drain_all(self) -> List[Request]:
        """Remove and return every unpopped entry, in queue order.

        The chaos layer's crash path: a dead replica's backlog is pulled out
        wholesale so the fleet can re-route or retry it elsewhere.  Leaves
        the queue empty (every index marked popped)."""
        self._advance_head()
        arr, popped = self._arr, self._popped
        out = [arr[i] for i in range(self._head, len(arr)) if not popped[i]]
        for i in range(self._head, len(arr)):
            popped[i] = 1
        self._head = len(arr)
        return out

    # -- arrivals --------------------------------------------------------------
    def push(self, req: Request) -> None:
        """Enqueue one arrival.  Routers offer in global arrival order, so
        this is an O(1) append; out-of-order offers (decode handoff legs,
        deferral releases) bisect-insert and rebuild the rung indices."""
        t = req.arrival_s
        if not self._times or t >= self._times[-1]:
            idx = len(self._arr)
            self._arr.append(req)
            self._times.append(t)
            self._popped.append(0)
            if self._use_rungs:
                self._rungs[priority_level(req.priority)].append(idx)
            return
        pos = bisect_right(self._times, t, self._head)
        self._arr.insert(pos, req)
        self._times.insert(pos, t)
        self._popped.insert(pos, 0)
        if self._use_rungs:
            self._build_rungs()
