"""The monitor the fleet ticks: signals -> burn rates -> alerts -> incidents.

One :class:`MonitorRuntime` per monitored run.  The fleet calls
:meth:`observe` at every window boundary (right after the gauges sample,
the same cadence the autoscaler sees); the session calls :meth:`finalize`
after the run drains.  The runtime is a strict *read-only* consumer of the
:class:`~repro_torch.serving.telemetry.recorder.TraceRecorder` — under
``REPRO_SANITIZE=1`` every tick runs inside
:func:`repro_torch.energy.sanitize.observation_guard` (invariant R6), and
``finalize`` re-derives the whole alert stream from the sealed windows
through a fresh :class:`~repro_torch.serving.monitor.burnrate.BurnEngine`,
failing loudly if the incremental path ever diverges from the batch
recomputation (alert determinism, the other half of R6).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.energy.sanitize import (ConservationError, observation_guard,
                                   sanitize_enabled)
from repro_torch.serving.monitor.burnrate import BurnEngine
from repro_torch.serving.monitor.incidents import IncidentDetector
from repro_torch.serving.monitor.signals import SignalAggregator
from repro_torch.serving.monitor.spec import MonitorSpec


class MonitorRuntime:
    """Streaming green-SRE monitor bound to one recorder."""

    def __init__(self, spec: MonitorSpec, recorder,
                 slo_targets: Dict[Tuple[str, str], Tuple[float, float]]):
        probs = spec.problems()
        if probs:
            raise ValueError(f"{probs[0][0]}: {probs[0][1]}")
        self.spec = spec
        self.recorder = recorder
        self.signals = SignalAggregator(recorder, spec.window_s, slo_targets)
        self.burn = BurnEngine(spec.budgets, spec.window_s)
        self._detector = IncidentDetector(spec.incident_gap_s)
        self.windows: List[dict] = []
        self.alerts: List[dict] = []
        self._audit = sanitize_enabled()
        self._finalized = False

    # -- fleet face -----------------------------------------------------------
    def observe(self, t_now: float) -> None:
        """Window-boundary tick: consume the stream, seal, score."""
        if self._audit:
            with observation_guard(self.recorder,
                                   f"monitor tick @ t={t_now:.3f}"):
                self._tick(t_now)
        else:
            self._tick(t_now)

    def _tick(self, t_now: float) -> None:
        for win in self.signals.advance(t_now):
            self._score(win)

    def _score(self, win: dict) -> None:
        alerts = self.burn.on_window(win)
        self.alerts.extend(alerts)
        self._detector.on_window(win, alerts)
        self.windows.append(win)

    # -- session face ---------------------------------------------------------
    def finalize(self) -> "MonitorRuntime":
        """Drain the stream tail, close open incidents, re-prove alerts."""
        if self._finalized:
            return self
        if self._audit:
            with observation_guard(self.recorder, "monitor finalize"):
                for win in self.signals.flush():
                    self._score(win)
        else:
            for win in self.signals.flush():
                self._score(win)
        self._detector.finalize()
        self._finalized = True
        if self._audit:
            self._verify_replay()
        return self

    @property
    def incidents(self) -> List[dict]:
        return self._detector.incidents

    def budget_remaining(self) -> Dict[str, dict]:
        return self.burn.budget_remaining()

    # -- R6 determinism re-check ----------------------------------------------
    def _verify_replay(self) -> None:
        """Batch-recompute the alert stream from the sealed windows; the
        incremental path must have produced the identical list."""
        engine = BurnEngine(self.spec.budgets, self.spec.window_s)
        replayed: List[dict] = []
        for win in self.windows:
            replayed.extend(engine.on_window(win))
        if replayed != self.alerts:
            raise ConservationError(
                f"R6 alert determinism violated: incremental monitoring "
                f"produced {len(self.alerts)} alerts but a batch replay "
                f"over the same sealed windows produced {len(replayed)}")
