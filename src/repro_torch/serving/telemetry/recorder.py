"""The trace recorder: lifecycle spans, energy-billing spans, gauges.

Everything here is an **observer**.  The recorder never touches the
simulation — it is notified with values the meter/core/fleet already
computed, stores compact tuples, and is read back at export time.  A traced
run is therefore bit-identical in joules, grams and latencies to an
untraced one (proven by ``tests/test_telemetry.py`` across the
policy x router x disagg x chaos grid).

Three event families share one capped stream (``TelemetrySpec.max_events``;
overflow is counted in :attr:`TraceRecorder.dropped`, never silent):

  * ``("span", pid, tid, kind, t0, dur, j, g, n_resident, tokens)`` — one
    per :class:`~repro_torch.energy.meter.EnergyMeter` billing event, observed via
    the meter's ``tracer`` hook with the *exact* joule/gram deltas it
    billed.  Per-replica bucket sums (:attr:`_ReplicaSink.bucket_j` /
    ``bucket_g``) accumulate alongside, which is what makes span/meter
    reconciliation hold by construction — and lets the ``REPRO_SANITIZE=1``
    sanitizer re-check it after every event;
  * ``("inst", pid, tid, name, t, args)`` — instant markers: preemption
    pause/resume, retry, failover, shed, crash-loss, region transit;
  * ``("ctr", pid, tid, series, t, value)`` — :class:`MetricsRegistry`
    gauge samples (pool sizes, backlogs, zone carbon intensity), deduped
    against the last value per series.

Request lifecycle records and deferral holds live outside the cap (they are
bounded by the workload size and feed the report's phase-breakdown table,
not just the trace).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# pid 0 is the fleet-level track (router/autoscaler instants, fleet gauges);
# endpoints get pid 1..N, their replicas tid 1..M within the endpoint
FLEET_PID = 0

# shared empty-args payload for instants recorded without arguments —
# treated as read-only by every consumer, so the hot record path never
# allocates a fresh dict per event
_NO_ARGS: dict = {}


class _ReplicaSink:
    """Meter observer bound to one replica's trace track.

    Installed as ``meter.tracer`` by the fleet at spawn time (and re-bound
    by ``SchedulerCore._reset`` whenever the core builds a fresh meter).
    One sink observes exactly one meter lifetime, so its bucket sums are
    directly comparable to that meter's buckets.
    """

    __slots__ = ("rec", "endpoint", "replica", "pid", "tid",
                 "bucket_j", "bucket_g", "_events", "_max", "_spans")

    def __init__(self, rec: "TraceRecorder", endpoint: str, replica: str,
                 pid: int, tid: int):
        self.rec = rec
        self.endpoint = endpoint
        self.replica = replica
        self.pid = pid
        self.tid = tid
        self.bucket_j: Dict[str, float] = {}
        self.bucket_g: Dict[str, float] = {}
        # hot-path caches: one billing event per meter segment flows through
        # on_energy, so the recorder's stream list, cap and span switch are
        # bound once here instead of re-read through two attribute hops per
        # event (they are immutable for the recorder's lifetime)
        self._events = rec.events
        self._max = rec.max_events
        self._spans = rec.spans

    def reset(self) -> None:
        """A fresh meter was attached: start its bucket ledger from zero."""
        self.bucket_j.clear()
        self.bucket_g.clear()

    def on_energy(self, kind: str, t_s: Optional[float], dur_s: float,
                  j: float, g: float, rids=(), tokens: int = 0) -> None:
        bj = self.bucket_j
        bj[kind] = bj.get(kind, 0.0) + j
        bg = self.bucket_g
        bg[kind] = bg.get(kind, 0.0) + g
        if self._spans:
            events = self._events
            if len(events) < self._max:
                # the tuple is only built when it will actually be stored:
                # past the cap (or with spans off) no payload is allocated
                events.append(("span", self.pid, self.tid, kind,
                               0.0 if t_s is None else t_s, dur_s, j, g,
                               len(rids), tokens))
            else:
                self.rec.dropped += 1

    def on_response(self, resp, preempted_s: float = 0.0) -> None:
        self.rec.on_response(self, resp, preempted_s)

    def instant(self, name: str, t_s: float,
                args: Optional[dict] = None) -> None:
        self.rec.instant(name, t_s, args, sink=self)

    def on_lost(self, t_s: Optional[float],
                victims: List[Tuple[int, float, float]]) -> None:
        """A crash reclassified the victims' attribution active -> lost."""
        mj = sum(j for _, j, _ in victims)
        mg = sum(g for _, _, g in victims)
        self.bucket_j["active"] = self.bucket_j.get("active", 0.0) - mj
        self.bucket_g["active"] = self.bucket_g.get("active", 0.0) - mg
        self.bucket_j["lost"] = self.bucket_j.get("lost", 0.0) + mj
        self.bucket_g["lost"] = self.bucket_g.get("lost", 0.0) + mg
        rec = self.rec
        if rec.spans:
            rec._push(("inst", self.pid, self.tid, "crash_loss",
                       0.0 if t_s is None else t_s,
                       {"rids": [rid for rid, _, _ in victims],
                        "j": mj, "g": mg}))


class MetricsRegistry:
    """Sampled gauges on the trace's counter tracks.

    ``sample()`` records ``(series, virtual_t, value)`` against a replica
    track (pass its sink) or the fleet track; consecutive identical values
    per series are deduped so window-cadence sampling of a flat gauge costs
    one event, not thousands.
    """

    def __init__(self, rec: "TraceRecorder"):
        self.rec = rec
        self._last: Dict[Tuple[int, int, str], float] = {}

    def sample(self, series: str, t_s: float, value: float,
               sink: Optional[_ReplicaSink] = None) -> None:
        pid, tid = (sink.pid, sink.tid) if sink is not None else (FLEET_PID, 0)
        key = (pid, tid, series)
        v = float(value)
        if self._last.get(key) == v:
            return
        self._last[key] = v
        self.rec._push(("ctr", pid, tid, series, t_s, v))


class TraceRecorder:
    """One recorder per traced run: the fleet writes, the exporter reads."""

    def __init__(self, spans: bool = True, metrics: bool = True,
                 max_events: int = 2_000_000):
        self.spans = spans
        self.max_events = max_events
        self.events: List[tuple] = []
        self.dropped = 0
        self.sinks: List[_ReplicaSink] = []
        # request lifecycle records (one per Response the cores emit, so a
        # disaggregated request contributes its prefill AND decode legs):
        # (pid, tid, rid, slo_class, arrival, start, first_token, done,
        #  preempted_s)
        self.requests: List[tuple] = []
        self.preempt_by_rid: Dict[int, float] = {}
        # deferral holds: (rid, arrival_s, release_s, args)
        self.holds: List[tuple] = []
        self.metrics: Optional[MetricsRegistry] = (
            MetricsRegistry(self) if metrics else None)
        self._pids: Dict[str, int] = {}
        self._tids: Dict[Tuple[str, str], int] = {}
        self._tid_count: Dict[str, int] = {}
        # exact per-request energy/carbon attribution, attached by the
        # session from the fleet meter after the run (the meter's shares
        # are resident-weighted; the recorder never re-derives them)
        self.request_j: Dict[int, float] = {}
        self.request_g: Dict[int, float] = {}

    # -- registration ---------------------------------------------------------
    def pid_for(self, endpoint: str) -> int:
        pid = self._pids.get(endpoint)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[endpoint] = pid
        return pid

    def sink_for(self, endpoint: str, replica: str) -> _ReplicaSink:
        """A fresh sink for a (re)spawned replica.

        Always a new sink (its bucket ledger must cover exactly one meter's
        lifetime); the display track (pid, tid) is reused when a replica
        name respawns after a crash, so its history lines up in Perfetto.
        """
        pid = self.pid_for(endpoint)
        key = (endpoint, replica)
        tid = self._tids.get(key)
        if tid is None:
            tid = self._tid_count.get(endpoint, 0) + 1
            self._tid_count[endpoint] = tid
            self._tids[key] = tid
        sink = _ReplicaSink(self, endpoint, replica, pid, tid)
        self.sinks.append(sink)
        return sink

    # -- recording ------------------------------------------------------------
    def _push(self, ev: tuple) -> None:
        if len(self.events) < self.max_events:
            self.events.append(ev)
        else:
            self.dropped += 1

    def instant(self, name: str, t_s: float, args: Optional[dict] = None,
                sink: Optional[_ReplicaSink] = None) -> None:
        if not self.spans:
            return
        pid, tid = (sink.pid, sink.tid) if sink is not None else (FLEET_PID, 0)
        self._push(("inst", pid, tid, name, t_s,
                    _NO_ARGS if args is None else args))

    def on_response(self, sink: _ReplicaSink, resp,
                    preempted_s: float = 0.0) -> None:
        if preempted_s > 0:
            self.preempt_by_rid[resp.rid] = \
                self.preempt_by_rid.get(resp.rid, 0.0) + preempted_s
        if self.spans:
            self.requests.append(
                (sink.pid, sink.tid, resp.rid,
                 resp.priority or "standard", resp.arrival_s, resp.start_s,
                 resp.first_token_s, resp.done_s, preempted_s))

    def hold(self, rid: int, arrival_s: float, release_s: float,
             args: Optional[dict] = None) -> None:
        if self.spans:
            self.holds.append((rid, arrival_s, release_s, args or {}))

    def attach_request_energy(self, per_j: Dict[int, float],
                              per_g: Dict[int, float]) -> None:
        self.request_j = per_j
        self.request_g = per_g

    # -- aggregation ----------------------------------------------------------
    def bucket_totals(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Span-attributed joules/grams summed over every replica sink —
        the left-hand side of the reconciliation invariant."""
        bj: Dict[str, float] = {}
        bg: Dict[str, float] = {}
        for s in self.sinks:
            for k, v in s.bucket_j.items():
                bj[k] = bj.get(k, 0.0) + v
            for k, v in s.bucket_g.items():
                bg[k] = bg.get(k, 0.0) + v
        return bj, bg

    def tracks(self) -> Dict[Tuple[str, str], Tuple[int, int]]:
        return {key: (self._pids[key[0]], tid)
                for key, tid in self._tids.items()}

    def endpoints_by_pid(self) -> Dict[int, str]:
        """Reverse of :meth:`pid_for` — how stream consumers (the monitor,
        the exporter) map a track back to its endpoint name."""
        return {pid: name for name, pid in self._pids.items()}
