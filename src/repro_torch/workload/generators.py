"""Trace-driven arrival generators: workload shape as first-class data.

Demand *shaping* — understanding and steering WHEN load arrives — is the
twin of carbon-aware scheduling: a deferral queue or a calendar autoscaler
is only testable against workloads whose temporal shape is explicit.  Every
generator here produces a plain ``List[Request]`` stream for the fleet's
``offer()`` path (deterministic given its seed), replacing the ad-hoc
arrival lists benchmarks used to hand-roll:

  * :func:`poisson` — homogeneous Poisson arrivals (bit-identical to the
    legacy ``repro_torch.serving.request.synth_workload``, which now delegates
    here);
  * :func:`diurnal` — inhomogeneous Poisson via thinning against a raised-
    cosine day/night rate profile (quiet nights, busy afternoons);
  * :func:`bursty` — a background Poisson stream plus periodic flash
    crowds (``burst_n`` requests arriving at ``burst_rate_per_s`` every
    ``burst_every_s``), the stress case for deferral and autoscaling;
  * :func:`replay` — recorded arrival instants replayed verbatim.

:class:`WorkloadSpec` is the declarative form the spec layer embeds in
``EndpointSpec.workload`` (JSON-round-trippable, sweepable); ``build()``
dispatches to the matching generator.  Batch-class work is minted by
stamping a relative completion ``deadline_s`` on every request — exactly
what the carbon deferral queue keys on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request


def _requests(times: np.ndarray, rng: np.random.RandomState, prompt_len: int,
              max_new: int, vocab: int, rid0: int, slo_ms: Optional[float],
              deadline_s: Optional[float],
              priority: Optional[str] = None) -> List[Request]:
    """Stamp prompts/ids/budgets onto computed arrival instants.  Prompts
    are drawn AFTER all arrival times in ONE batched randint: RandomState
    fills the ``(n, prompt_len)`` matrix row-major from the same MT19937
    stream as ``n`` sequential per-request draws, so both the token values
    and the post-call RNG state are bit-identical to the legacy per-request
    loop (regression-tested in ``tests/test_workload.py``)."""
    n = len(times)
    if n == 0:
        return []
    prompts = rng.randint(0, vocab, size=(n, prompt_len)).astype(np.int32)
    arrivals = np.asarray(times, np.float64).tolist()
    return [
        Request(
            rid=rid0 + i,
            prompt=prompts[i],
            max_new_tokens=max_new,
            arrival_s=t,
            slo_ms=slo_ms,
            deadline_s=(t + deadline_s if deadline_s is not None else None),
            priority=priority,
        )
        for i, t in enumerate(arrivals)
    ]


def poisson(n: int, prompt_len: int, max_new: int, vocab: int,
            rate_per_s: float, seed: int = 0, rid0: int = 0,
            slo_ms: Optional[float] = None,
            deadline_s: Optional[float] = None,
            priority: Optional[str] = None) -> List[Request]:
    """Homogeneous Poisson arrivals starting at t=0."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    t = np.cumsum(gaps) - gaps[0]
    return _requests(t, rng, prompt_len, max_new, vocab, rid0, slo_ms,
                     deadline_s, priority)


def diurnal(n: int, prompt_len: int, max_new: int, vocab: int,
            base_rate_per_s: float, peak_rate_per_s: float,
            period_s: float = 60.0, phase_s: float = 0.0, seed: int = 0,
            rid0: int = 0, slo_ms: Optional[float] = None,
            deadline_s: Optional[float] = None,
            priority: Optional[str] = None) -> List[Request]:
    """Inhomogeneous Poisson arrivals with a raised-cosine daily profile.

    ``rate(t)`` swings between ``base_rate_per_s`` (the trough, at
    ``phase_s``) and ``peak_rate_per_s`` (half a period later) — generated
    by thinning a homogeneous stream at the peak rate, the standard exact
    method for inhomogeneous Poisson processes.
    """
    peak = max(peak_rate_per_s, base_rate_per_s)

    def rate(t: float) -> float:
        w = 2.0 * math.pi * (t - phase_s) / period_s
        return base_rate_per_s + (peak - base_rate_per_s) * 0.5 * (
            1.0 - math.cos(w))

    rng = np.random.RandomState(seed)
    times: List[float] = []
    t = 0.0
    while len(times) < n:
        t += float(rng.exponential(1.0 / peak))
        if rng.uniform() * peak <= rate(t):
            times.append(t)
    t0 = times[0]
    arr = np.asarray(times) - t0
    return _requests(arr, rng, prompt_len, max_new, vocab, rid0, slo_ms,
                     deadline_s, priority)


def bursty(n: int, prompt_len: int, max_new: int, vocab: int,
           rate_per_s: float, burst_n: int, burst_every_s: float,
           burst_rate_per_s: float, phase_s: float = 0.0, seed: int = 0,
           rid0: int = 0, slo_ms: Optional[float] = None,
           deadline_s: Optional[float] = None,
           priority: Optional[str] = None) -> List[Request]:
    """Background Poisson stream + periodic flash crowds.

    Every ``burst_every_s`` (first crowd at ``phase_s``) a flash crowd of
    ``burst_n`` requests arrives at ``burst_rate_per_s``; between crowds the
    background ticks along at ``rate_per_s``.  Both streams are generated
    up front and merged by arrival time, truncated to ``n`` requests — so
    the shape is deterministic and the crowds land exactly on schedule
    (e.g. aligned with a carbon signal's dirty peaks).
    """
    rng = np.random.RandomState(seed)
    bg_gaps = rng.exponential(1.0 / rate_per_s, size=n)
    bg = np.cumsum(bg_gaps) - bg_gaps[0]
    crowds: List[np.ndarray] = []
    n_crowds = int(math.ceil(n / max(burst_n, 1)))
    for k in range(n_crowds):
        gaps = rng.exponential(1.0 / burst_rate_per_s, size=burst_n)
        start = phase_s + k * burst_every_s
        crowds.append(start + np.cumsum(gaps) - gaps[0])
    times = np.sort(np.concatenate([bg] + crowds))[:n]
    return _requests(times, rng, prompt_len, max_new, vocab, rid0, slo_ms,
                     deadline_s, priority)


def replay(arrivals: Sequence[float], prompt_len: int, max_new: int,
           vocab: int, seed: int = 0, rid0: int = 0,
           slo_ms: Optional[float] = None,
           deadline_s: Optional[float] = None,
           priority: Optional[str] = None) -> List[Request]:
    """Replay recorded arrival instants verbatim (sorted, zero-based)."""
    arr = np.sort(np.asarray([float(t) for t in arrivals]))
    if arr.size:
        arr = arr - arr[0]
    rng = np.random.RandomState(seed)
    return _requests(arr, rng, prompt_len, max_new, vocab, rid0, slo_ms,
                     deadline_s, priority)


# -- the declarative form ------------------------------------------------------


_KINDS = ("poisson", "diurnal", "bursty", "trace")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """An arrival generator as pure data (JSON-round-trippable, sweepable).

    ``kind`` selects the generator; unrelated fields are ignored by the
    other kinds so sweeps can flip ``kind`` without rebuilding the spec.
    A non-``None`` ``deadline_s`` mints batch-class work: every request is
    stamped with ``arrival + deadline_s`` as its completion deadline (the
    deferral queue's currency); ``slo_ms`` stamps the interactive TTFT
    budget instead.
    """

    kind: str = "poisson"
    n: int = 100
    prompt_len: int = 16
    max_new_tokens: int = 16
    rate_per_s: float = 10.0
    seed: int = 0
    rid0: int = 0
    slo_ms: Optional[float] = None
    deadline_s: Optional[float] = None
    # admission priority class stamped on every request (None = standard);
    # the ladder vocabulary lives in repro_torch.serving.admission.priority
    priority: Optional[str] = None
    # diurnal
    peak_rate_per_s: float = 0.0
    period_s: float = 60.0
    phase_s: float = 0.0
    # bursty
    burst_n: int = 0
    burst_every_s: float = 10.0
    burst_rate_per_s: float = 0.0
    # trace replay
    arrivals: Tuple[float, ...] = ()
    # client regions (the regions layer, not ported yet): requests cycle the named
    # origins round-robin in arrival order, so one spec declares a
    # geo-mixed client population; () = region-less (never pays transit)
    origins: Tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "arrivals",
                           tuple(float(t) for t in self.arrivals))
        object.__setattr__(self, "origins", tuple(self.origins))

    def problems(self) -> Sequence[Tuple[str, str]]:
        """(relative_field, message) violations; the spec layer prefixes
        its field path (same contract as ``CarbonSpec.problems``)."""
        out = []
        if self.kind not in _KINDS:
            out.append(("kind", f"unknown workload kind {self.kind!r}; "
                                f"known: {sorted(_KINDS)}"))
        if self.kind != "trace" and self.n < 1:
            out.append(("n", f"must be >= 1, got {self.n}"))
        if self.prompt_len < 1:
            out.append(("prompt_len", f"must be >= 1, got {self.prompt_len}"))
        if self.max_new_tokens < 1:
            out.append(("max_new_tokens",
                        f"must be >= 1, got {self.max_new_tokens}"))
        if self.kind in ("poisson", "bursty") and self.rate_per_s <= 0:
            out.append(("rate_per_s", f"must be > 0, got {self.rate_per_s}"))
        if self.slo_ms is not None and self.slo_ms <= 0:
            out.append(("slo_ms", f"must be > 0 ms, got {self.slo_ms}"))
        if self.deadline_s is not None and self.deadline_s <= 0:
            out.append(("deadline_s", f"must be > 0 s, got {self.deadline_s}"))
        if self.priority is not None:
            from repro_torch.serving.admission.priority import PRIORITY_LEVELS

            if self.priority not in PRIORITY_LEVELS:
                out.append(("priority",
                            f"unknown priority class {self.priority!r}; "
                            f"known: {sorted(PRIORITY_LEVELS)}"))
        for j, o in enumerate(self.origins):
            if not o:
                out.append((f"origins[{j}]",
                            "origin region names must be non-empty"))
        if self.kind == "diurnal":
            if self.rate_per_s <= 0:
                out.append(("rate_per_s",
                            f"must be > 0, got {self.rate_per_s}"))
            if self.peak_rate_per_s < self.rate_per_s:
                out.append(("peak_rate_per_s",
                            f"peak {self.peak_rate_per_s} must be >= the "
                            f"base rate_per_s {self.rate_per_s}"))
            if self.period_s <= 0:
                out.append(("period_s", f"must be > 0, got {self.period_s}"))
        if self.kind == "bursty":
            if self.burst_n < 1:
                out.append(("burst_n", f"must be >= 1, got {self.burst_n}"))
            if self.burst_rate_per_s <= 0:
                out.append(("burst_rate_per_s",
                            f"must be > 0, got {self.burst_rate_per_s}"))
            if self.burst_every_s <= 0:
                out.append(("burst_every_s",
                            f"must be > 0, got {self.burst_every_s}"))
        if self.kind == "trace" and not self.arrivals:
            out.append(("arrivals", "trace replay needs >= 1 arrival time"))
        return out

    def build(self, vocab: int) -> List[Request]:
        probs = self.problems()
        if probs:
            raise ValueError(f"{probs[0][0]}: {probs[0][1]}")
        common = dict(prompt_len=self.prompt_len,
                      max_new=self.max_new_tokens, vocab=vocab,
                      seed=self.seed, rid0=self.rid0, slo_ms=self.slo_ms,
                      deadline_s=self.deadline_s, priority=self.priority)
        if self.kind == "poisson":
            out = poisson(self.n, rate_per_s=self.rate_per_s, **common)
        elif self.kind == "diurnal":
            out = diurnal(self.n, base_rate_per_s=self.rate_per_s,
                          peak_rate_per_s=self.peak_rate_per_s,
                          period_s=self.period_s, phase_s=self.phase_s,
                          **common)
        elif self.kind == "bursty":
            out = bursty(self.n, rate_per_s=self.rate_per_s,
                         burst_n=self.burst_n,
                         burst_every_s=self.burst_every_s,
                         burst_rate_per_s=self.burst_rate_per_s,
                         phase_s=self.phase_s, **common)
        else:
            out = replay(self.arrivals, **common)
        if self.origins:
            # geo-mixed clients: cycle the declared origin regions in
            # arrival order (deterministic — no extra randomness to seed)
            out = [dataclasses.replace(r,
                                       origin=self.origins[k
                                                           % len(self.origins)])
                   for k, r in enumerate(out)]
        return out
