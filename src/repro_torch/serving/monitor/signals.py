"""Windowed signal aggregation over the telemetry stream (read-only).

The :class:`SignalAggregator` is a streaming consumer of the
:class:`~repro_torch.serving.telemetry.recorder.TraceRecorder`: two integer
cursors (events, requests) advance at every fleet window boundary, each
record is binned into a fixed-width monitor window by its **completion
instant** (spans by ``t0 + dur`` — a billing segment exists only once it
closed; instants and gauges by their stamp; requests by delivery), and a
window is **sealed** once the fleet clock has passed its end.  Sealing
emits one JSON-safe dict carrying the golden signals (traffic, per-class
latency p50/p95 against the declared targets, drops/sheds, saturation
gauges) and the green signals (W, J/token, gCO2/token, per-bucket joules,
lost joules, per-zone carbon intensity).

Empty windows are sealed too — burn rates must decay through quiet
periods, so the window stream is gapless and uniform.

Late events (completion before the last sealed boundary — possible only
for segments billed across a fleet window, e.g. a long idle strip) are
folded into the earliest unsealed window and *counted* in
``late_events``, never silently dropped and never mutating sealed
history: the alert stream stays deterministic and append-only.

The aggregator never writes the recorder — under ``REPRO_SANITIZE=1`` the
runtime proves that every tick (invariant R6).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# instant names counted as top-line signals
_COUNTED = ("drop", "shed", "crash", "retry")


def _pct(sorted_vals: List[float], q: float) -> float:
    """Percentile by nearest-rank on an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class _Window:
    """One open aggregation window (sealed into a plain dict)."""

    __slots__ = ("idx", "j", "g", "tokens", "lost_j", "lost_g", "buckets_j",
                 "counts", "classes", "endpoints", "gauges", "late",
                 "active_s", "power_hist")

    def __init__(self, idx: int):
        self.idx = idx
        self.j = 0.0
        self.g = 0.0
        self.tokens = 0
        self.lost_j = 0.0
        self.lost_g = 0.0
        self.active_s = 0.0
        # billed active power (W, rounded) -> compute-seconds at that power;
        # a brownout's clamped dispatches land at cap_frac x rated exactly,
        # so ``power``-kind budgets read cap violations off this histogram
        self.power_hist: Dict[float, float] = {}
        self.buckets_j: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        # class -> [n, good, bad, ttft list]
        self.classes: Dict[str, list] = {}
        # endpoint -> {"n","good","bad","j","g","tokens","lost_j","drops",
        #              "sheds","classes": {cls: [n, good, bad]}}
        self.endpoints: Dict[str, dict] = {}
        self.gauges: Dict[str, float] = {}
        self.late = 0

    def _ep(self, name: str) -> dict:
        ep = self.endpoints.get(name)
        if ep is None:
            ep = {"n": 0, "good": 0, "bad": 0, "j": 0.0, "g": 0.0,
                  "tokens": 0, "lost_j": 0.0, "drops": 0, "sheds": 0,
                  "classes": {}}
            self.endpoints[name] = ep
        return ep


class SignalAggregator:
    """Cursor-driven window builder over one recorder's stream.

    ``slo_targets`` maps ``(endpoint, slo_class) -> (slo_ms, deadline_s)``
    (0 = no target of that flavor): a delivered request is *good* when it
    met its TTFT target (preferred) or its completion deadline; a request
    with no declared target is always good.  Classes/endpoints are scored
    fleet-wide AND per endpoint so budgets can scope either way.
    """

    def __init__(self, recorder, window_s: float,
                 slo_targets: Dict[Tuple[str, str], Tuple[float, float]]):
        self.rec = recorder
        self.window_s = window_s
        self.slo_targets = slo_targets
        self._ev_i = 0
        self._req_i = 0
        self._open: Dict[int, _Window] = {}
        self._floor = 0          # index of the earliest unsealed window
        self._max_idx = -1       # highest window index that saw data
        self.late_events = 0

    # -- streaming face -------------------------------------------------------
    def advance(self, t_now: float) -> List[dict]:
        """Consume new records, seal every window ending at or before
        ``t_now`` (gapless: quiet windows seal empty)."""
        self._consume()
        out = []
        while (self._floor + 1) * self.window_s <= t_now + 1e-9:
            out.append(self._seal(self._floor))
            self._floor += 1
        return out

    def flush(self) -> List[dict]:
        """End of run: consume the tail and seal every remaining window."""
        self._consume()
        out = []
        while self._floor <= self._max_idx:
            out.append(self._seal(self._floor))
            self._floor += 1
        return out

    # -- binning --------------------------------------------------------------
    def _win(self, t: float) -> _Window:
        idx = int(t / self.window_s)
        late = idx < self._floor     # landed before the sealed frontier
        if late:
            self.late_events += 1
            idx = self._floor
        if idx > self._max_idx:
            self._max_idx = idx
        w = self._open.get(idx)
        if w is None:
            w = _Window(idx)
            self._open[idx] = w
        if late:
            w.late += 1
        return w

    def _consume(self) -> None:
        events = self.rec.events
        names = self.rec.endpoints_by_pid()
        for i in range(self._ev_i, len(events)):
            ev = events[i]
            fam = ev[0]
            if fam == "span":
                _, pid, _, kind, t0, dur, j, g, _, tokens = ev
                w = self._win(t0 + dur)
                w.j += j
                w.g += g
                w.buckets_j[kind] = w.buckets_j.get(kind, 0.0) + j
                ep_name = names.get(pid)
                ep = w._ep(ep_name) if ep_name is not None else None
                if ep is not None:
                    ep["j"] += j
                    ep["g"] += g
                if kind == "active":
                    if tokens:
                        w.tokens += tokens
                        if ep is not None:
                            ep["tokens"] += tokens
                    if dur > 0:
                        w.active_s += dur
                        pw = round(j / dur, 6)
                        w.power_hist[pw] = w.power_hist.get(pw, 0.0) + dur
            elif fam == "inst":
                _, pid, _, name, t, args = ev
                w = self._win(t)
                if name == "crash_loss":
                    lj = args.get("j", 0.0)
                    w.lost_j += lj
                    w.lost_g += args.get("g", 0.0)
                    ep_name = names.get(pid)
                    if ep_name is not None:
                        w._ep(ep_name)["lost_j"] += lj
                elif name in _COUNTED:
                    w.counts[name] = w.counts.get(name, 0) + 1
                    ep_name = args.get("endpoint") or names.get(pid)
                    if name in ("drop", "shed") and ep_name is not None:
                        w._ep(ep_name)[name + "s"] += 1
            else:  # "ctr"
                _, _, _, series, t, value = ev
                self._win(t).gauges[series] = value
        self._ev_i = len(events)

        requests = self.rec.requests
        for i in range(self._req_i, len(requests)):
            pid, _, _, cls, arrival, _, first_token, done, _ = requests[i]
            w = self._win(done)
            ep_name = names.get(pid, "")
            slo_ms, deadline_s = self.slo_targets.get((ep_name, cls), (0.0, 0.0))
            ttft = (first_token if first_token is not None else done) - arrival
            if slo_ms > 0:
                good = ttft * 1e3 <= slo_ms
            elif deadline_s > 0:
                good = done - arrival <= deadline_s
            else:
                good = True
            c = w.classes.get(cls)
            if c is None:
                c = [0, 0, 0, []]
                w.classes[cls] = c
            c[0] += 1
            c[1 if good else 2] += 1
            c[3].append(ttft)
            ep = w._ep(ep_name)
            ep["n"] += 1
            ep["good" if good else "bad"] += 1
            ec = ep["classes"].get(cls)
            if ec is None:
                ec = [0, 0, 0]
                ep["classes"][cls] = ec
            ec[0] += 1
            ec[1 if good else 2] += 1
        self._req_i = len(requests)

    # -- sealing --------------------------------------------------------------
    def _seal(self, idx: int) -> dict:
        w = self._open.pop(idx, None) or _Window(idx)
        t0 = idx * self.window_s
        t1 = t0 + self.window_s
        classes = {}
        served = good = bad = 0
        for cls, (n, ok, ko, ttfts) in w.classes.items():
            ttfts.sort()
            classes[cls] = {"n": n, "good": ok, "bad": ko,
                            "p50_ttft_s": _pct(ttfts, 0.50),
                            "p95_ttft_s": _pct(ttfts, 0.95)}
            served += n
            good += ok
            bad += ko
        endpoints = {}
        for name, ep in w.endpoints.items():
            endpoints[name] = {
                **{k: ep[k] for k in ("n", "good", "bad", "j", "g",
                                      "tokens", "lost_j", "drops", "sheds")},
                "classes": {cls: {"n": c[0], "good": c[1], "bad": c[2]}
                            for cls, c in ep["classes"].items()}}
        return {
            "t0": t0, "t1": t1,
            "served": served, "good": good, "bad": bad,
            "classes": classes, "endpoints": endpoints,
            "j": w.j, "g": w.g, "tokens": w.tokens,
            "watts": w.j / self.window_s,
            "j_per_token": w.j / w.tokens if w.tokens else 0.0,
            "g_per_token": w.g / w.tokens if w.tokens else 0.0,
            "buckets_j": w.buckets_j,
            "active_s": w.active_s,
            "power_w_hist": w.power_hist,
            "lost_j": w.lost_j, "lost_g": w.lost_g,
            "drops": w.counts.get("drop", 0),
            "sheds": w.counts.get("shed", 0),
            "crashes": w.counts.get("crash", 0),
            "retries": w.counts.get("retry", 0),
            "gauges": w.gauges,
            "late_events": w.late,
        }
