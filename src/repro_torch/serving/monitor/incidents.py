"""Incident detection: alert episodes merged into operator-facing records.

Alerts are per-window, per-budget facts; an operator deals in *incidents*.
The :class:`IncidentDetector` merges consecutive alerting windows — and
episodes separated by less than ``incident_gap_s`` of quiet — into one
incident carrying its start/end instants, peak severity, the budgets that
fired, the endpoints visibly affected (SLO misses, lost joules, drops or
sheds during the alerting windows), and the energy attributed per meter
bucket while it was open.  The attribution is read straight off the
sealed windows' span sums, so an incident's joule bill reconciles with
the meter by construction.

These records can be scored against the chaos script's ground truth
(every scripted crash/outage/brownout carries its exact virtual instant):
recall, precision and time-to-detect per incident class.
"""

from __future__ import annotations

from typing import List, Optional

_SEVERITY_RANK = {"": 0, "warn": 1, "page": 2}


class IncidentDetector:
    """Streaming episode merger (pure function of the alert stream)."""

    def __init__(self, gap_s: float):
        self.gap_s = gap_s
        self.incidents: List[dict] = []
        self._open: Optional[dict] = None

    def on_window(self, win: dict, alerts: List[dict]) -> None:
        if not alerts:
            if (self._open is not None
                    and win["t1"] - self._open["end"] > self.gap_s):
                self._close()
            return
        inc = self._open
        if inc is None:
            inc = {"start": win["t0"], "end": win["t1"], "severity": "",
                   "budgets": set(), "endpoints": set(), "alerts": 0,
                   "windows": 0, "lost_j": 0.0, "buckets_j": {}}
            self._open = inc
        inc["end"] = win["t1"]
        inc["alerts"] += len(alerts)
        inc["windows"] += 1
        for a in alerts:
            inc["budgets"].add(a["budget"])
            if a["endpoint"]:
                inc["endpoints"].add(a["endpoint"])
            if _SEVERITY_RANK[a["severity"]] > \
                    _SEVERITY_RANK[inc["severity"]]:
                inc["severity"] = a["severity"]
        for name, ep in win["endpoints"].items():
            if ep["bad"] or ep["lost_j"] or ep["drops"] or ep["sheds"]:
                inc["endpoints"].add(name)
        inc["lost_j"] += win["lost_j"]
        for kind, j in win["buckets_j"].items():
            inc["buckets_j"][kind] = inc["buckets_j"].get(kind, 0.0) + j

    def finalize(self) -> List[dict]:
        self._close()
        return self.incidents

    def _close(self) -> None:
        if self._open is None:
            return
        inc = self._open
        inc["budgets"] = sorted(inc["budgets"])
        inc["endpoints"] = sorted(inc["endpoints"])
        inc["duration_s"] = inc["end"] - inc["start"]
        self.incidents.append(inc)
        self._open = None
