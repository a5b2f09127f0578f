"""Green-SRE monitoring on the virtual clock.

Telemetry makes the simulator observable; this package makes it *operable*: a
pure-observer streaming monitor that consumes the telemetry stream at
fleet window boundaries and turns it into what an on-call operator runs
on —

  * :mod:`~repro_torch.serving.monitor.signals` — windowed golden signals
    (latency p50/p95 per SLO class, traffic, drops/sheds, saturation) and
    green signals (W, J/token, gCO2/token, lost joules, per-zone carbon
    intensity);
  * :mod:`~repro_torch.serving.monitor.burnrate` — declarative
    :class:`BudgetSpec` s (SLO compliance, joule / gram / lost-joule
    allowances over a horizon) scored by multi-window SRE burn-rate rules
    with page/warn severities;
  * :mod:`~repro_torch.serving.monitor.incidents` — alert episodes merged into
    incident records, which can be scored for precision / recall /
    time-to-detect against the chaos script's ground truth;
  * :mod:`~repro_torch.serving.monitor.dashboard` — a self-contained HTML ops
    dashboard (stdlib-only).

Everything rides :class:`~repro_torch.serving.monitor.spec.MonitorSpec`
(the spec API that carries it is not ported yet) and is provably
observer-pure: monitored runs are bit-identical to
unmonitored ones in joules, grams and latencies — invariant R6, enforced
at every tick by the ``REPRO_SANITIZE=1`` sanitizer.
"""

from repro_torch.serving.monitor.burnrate import BudgetSpec, BurnEngine
from repro_torch.serving.monitor.dashboard import render_dashboard, write_dashboard
from repro_torch.serving.monitor.incidents import IncidentDetector
from repro_torch.serving.monitor.runtime import MonitorRuntime
from repro_torch.serving.monitor.signals import SignalAggregator
from repro_torch.serving.monitor.spec import MonitorSpec

__all__ = [
    "BudgetSpec",
    "BurnEngine",
    "IncidentDetector",
    "MonitorRuntime",
    "MonitorSpec",
    "SignalAggregator",
    "render_dashboard",
    "write_dashboard",
]
