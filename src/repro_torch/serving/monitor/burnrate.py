"""Error budgets and multi-window burn-rate alerting (the SRE rulebook).

A :class:`BudgetSpec` declares *what the operator promised*: an SLO
compliance objective, or a joule / gram / lost-joule allowance over a
horizon.  The :class:`BurnEngine` turns every sealed signal window
(:mod:`repro_torch.serving.monitor.signals`) into a **burn rate** — how many
times faster than sustainable the budget is being consumed — and fires an
alert only when BOTH a fast and a slow trailing window agree (the classic
multi-window burn-rate rule: the fast window gives detection latency, the
slow window kills flapping).

Burn-rate semantics per kind:

  * ``slo``     — ``error_rate / (1 - objective)``; an error is a delivered
    request that missed its class target (``slo_ms`` on TTFT, else
    ``deadline_s`` on completion).  Burn 1.0 = exactly spending the error
    budget.
  * ``joules`` / ``grams`` — consumption rate over the window divided by
    the sustainable rate ``budget / horizon_s``.
  * ``loss``    — same, over the meter's ``lost`` bucket (joules billed but
    never delivered — the crash/outage signature; zero on a healthy fleet).
  * ``crashes`` — replica-death rate vs an allowance of ``budget`` crashes
    per ``horizon_s`` (the recorder's ``crash`` instants: health-check
    observable, zero on a healthy fleet).
  * ``power``   — fraction of active compute-seconds billed *below* the
    declared rated power ``budget`` (W), vs compliance ``objective``: a
    brownout's clamped dispatches are billed at exactly
    ``cap_frac x rated``, so this is zero on a healthy fleet and jumps the
    moment a power cap lands.  Fleet-scoped (``endpoint`` is ignored).

Everything is pure data + pure arithmetic on the virtual clock: same spec,
same run, same alerts, bit for bit (invariant R6, ``docs/INVARIANTS.md``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Sequence, Tuple

_KINDS = ("slo", "joules", "grams", "loss", "crashes", "power")

# ratio kinds burn error-fraction / (1 - objective); the rest burn
# spend-rate / sustainable-rate
_RATIO_KINDS = ("slo", "power")


@dataclasses.dataclass(frozen=True)
class BudgetSpec:
    """One declared budget (JSON-round-trippable, sweepable).

    ``endpoint`` scopes the budget to one endpoint (empty = fleet-wide);
    ``slo_class`` scopes a ``slo`` budget to one class (empty = every
    delivered request with a target).  ``objective`` is the promised
    compliance fraction for ``slo`` budgets; ``budget`` the joule/gram
    allowance over ``horizon_s`` for the energy kinds.  An alert needs the
    burn rate over BOTH trailing windows (``fast_window_s``,
    ``slow_window_s``) to clear the same threshold: ``page_burn`` pages,
    ``warn_burn`` warns.
    """

    name: str = ""
    kind: str = "slo"
    endpoint: str = ""
    slo_class: str = ""
    objective: float = 0.99
    budget: float = 0.0
    horizon_s: float = 60.0
    fast_window_s: float = 1.0
    slow_window_s: float = 5.0
    page_burn: float = 10.0
    warn_burn: float = 2.0

    def problems(self) -> Sequence[Tuple[str, str]]:
        out = []
        if not self.name:
            out.append(("name", "a budget needs a name (it keys alerts, "
                                "incidents and budget_remaining)"))
        if self.kind not in _KINDS:
            out.append(("kind", f"unknown budget kind {self.kind!r}; "
                                f"known: {sorted(_KINDS)}"))
        if self.kind in _RATIO_KINDS and not 0.0 < self.objective < 1.0:
            out.append(("objective",
                        f"{self.kind} objective must be in (0, 1), "
                        f"got {self.objective}"))
        if self.kind != "slo" and self.budget <= 0:
            out.append(("budget",
                        f"{self.kind} budget must be > 0 "
                        f"({'rated watts' if self.kind == 'power' else 'over the horizon'}), "
                        f"got {self.budget}"))
        if self.horizon_s <= 0:
            out.append(("horizon_s", f"must be > 0, got {self.horizon_s}"))
        if self.fast_window_s <= 0:
            out.append(("fast_window_s",
                        f"must be > 0, got {self.fast_window_s}"))
        if self.slow_window_s < self.fast_window_s:
            out.append(("slow_window_s",
                        f"slow window ({self.slow_window_s}) must be >= "
                        f"fast window ({self.fast_window_s})"))
        if self.slow_window_s > self.horizon_s:
            out.append(("slow_window_s",
                        f"slow window ({self.slow_window_s}) cannot exceed "
                        f"the horizon ({self.horizon_s})"))
        if self.warn_burn <= 0:
            out.append(("warn_burn", f"must be > 0, got {self.warn_burn}"))
        if self.page_burn < self.warn_burn:
            out.append(("page_burn",
                        f"page threshold ({self.page_burn}) must be >= "
                        f"warn threshold ({self.warn_burn})"))
        return out


def _slo_counts(win: dict, spec: BudgetSpec) -> Tuple[float, float]:
    """(errors, served) for a ``slo`` budget's scope in one window."""
    if spec.endpoint:
        ep = win["endpoints"].get(spec.endpoint)
        if ep is None:
            return 0.0, 0.0
        if spec.slo_class:
            c = ep["classes"].get(spec.slo_class)
            return (0.0, 0.0) if c is None else (c["bad"], c["n"])
        return ep["bad"], ep["n"]
    if spec.slo_class:
        c = win["classes"].get(spec.slo_class)
        return (0.0, 0.0) if c is None else (c["bad"], c["n"])
    return win["bad"], win["served"]


def _energy_spend(win: dict, spec: BudgetSpec) -> float:
    """Joules/grams/lost-joules/crashes spent in one window, in scope."""
    if spec.kind == "crashes":
        return float(win.get("crashes", 0))
    field = {"joules": "j", "grams": "g", "loss": "lost_j"}[spec.kind]
    if spec.endpoint:
        ep = win["endpoints"].get(spec.endpoint)
        return 0.0 if ep is None else ep[field]
    return win[field]


def _power_counts(win: dict, spec: BudgetSpec) -> Tuple[float, float]:
    """(capped compute-seconds, total active compute-seconds) for one
    window: seconds billed below the declared rated power are errors."""
    hist = win.get("power_w_hist") or {}
    thresh = spec.budget * (1.0 - 1e-6)
    capped = sum(dur for w, dur in hist.items() if float(w) < thresh)
    return capped, win.get("active_s", 0.0)


class _BudgetState:
    """Per-budget trailing history and cumulative spend."""

    __slots__ = ("spec", "n_fast", "n_slow", "hist", "spent", "served")

    def __init__(self, spec: BudgetSpec, window_s: float):
        self.spec = spec
        self.n_fast = max(1, int(round(spec.fast_window_s / window_s)))
        self.n_slow = max(self.n_fast,
                          int(round(spec.slow_window_s / window_s)))
        self.hist: deque = deque(maxlen=self.n_slow)  # (num, den) pairs
        self.spent = 0.0    # cumulative errors / joules / grams / crashes
        self.served = 0.0   # cumulative denominator (ratio kinds only)

    def _burn(self, n: int, window_s: float) -> float:
        pairs = list(self.hist)[-n:]
        num = sum(p[0] for p in pairs)
        den = sum(p[1] for p in pairs)
        if self.spec.kind in _RATIO_KINDS:
            if den <= 0:
                return 0.0
            return (num / den) / (1.0 - self.spec.objective)
        sustainable = self.spec.budget / self.spec.horizon_s
        return (num / (len(pairs) * window_s)) / sustainable if pairs else 0.0

    def observe(self, win: dict, window_s: float) -> Tuple[float, float]:
        if self.spec.kind in _RATIO_KINDS:
            bad, n = (_slo_counts(win, self.spec) if self.spec.kind == "slo"
                      else _power_counts(win, self.spec))
            self.hist.append((bad, n))
            self.spent += bad
            self.served += n
        else:
            spend = _energy_spend(win, self.spec)
            self.hist.append((spend, window_s))
            self.spent += spend
        return self._burn(self.n_fast, window_s), \
            self._burn(self.n_slow, window_s)

    def remaining(self) -> dict:
        spec = self.spec
        if spec.kind in _RATIO_KINDS:
            allowance = (1.0 - spec.objective) * self.served
        else:
            allowance = spec.budget
        left = allowance - self.spent
        frac = left / allowance if allowance > 0 else 1.0
        return {"kind": spec.kind, "budget": allowance, "spent": self.spent,
                "remaining": left, "remaining_frac": frac}


class BurnEngine:
    """Feeds sealed windows through every budget; emits alerts.

    Each sealed window gets a ``burn`` / ``remaining`` stamp per budget
    (the dashboard's burn-down series), and an alert dict per budget whose
    fast AND slow burns clear a threshold.  Stateless apart from the
    per-budget deques, so a replay over the same window list reproduces
    the same alerts — the R6 determinism re-check uses exactly that.
    """

    def __init__(self, budgets: Sequence[BudgetSpec], window_s: float):
        self.window_s = window_s
        self.states = [_BudgetState(b, window_s) for b in budgets]

    def on_window(self, win: dict) -> List[dict]:
        alerts = []
        burns: Dict[str, Tuple[float, float]] = {}
        remaining: Dict[str, float] = {}
        for st in self.states:
            fast, slow = st.observe(win, self.window_s)
            spec = st.spec
            burns[spec.name] = (fast, slow)
            remaining[spec.name] = st.remaining()["remaining_frac"]
            severity = ""
            if fast >= spec.page_burn and slow >= spec.page_burn:
                severity = "page"
            elif fast >= spec.warn_burn and slow >= spec.warn_burn:
                severity = "warn"
            if severity:
                alerts.append({
                    "t": win["t1"], "budget": spec.name, "kind": spec.kind,
                    "severity": severity, "endpoint": spec.endpoint,
                    "burn_fast": fast, "burn_slow": slow})
        win["burn"] = burns
        win["remaining"] = remaining
        return alerts

    def budget_remaining(self) -> Dict[str, dict]:
        return {st.spec.name: st.remaining() for st in self.states}
