"""Runtime conservation sanitizer for :class:`~repro_torch.energy.meter.EnergyMeter`.

``REPRO_SANITIZE=1`` swaps every meter the serving stack constructs (via
:func:`new_meter`) for a :class:`SanitizedEnergyMeter` that re-derives the
billing contract at every event and raises :class:`ConservationError` — with
the offending event's full context — the moment accounting drifts:

  * **event deltas** — each ``record_*`` call must move exactly the buckets
    its arguments imply (``record_active(dur)`` adds ``dur`` seconds and
    ``dur x active_power_w`` joules, split across its rids; ``record_xfer``
    bills at the *link's* power; negative durations are rejected);
  * **tamper detection** — between two events no field may change: a
    snapshot taken after every event is compared at the next one, so a
    mis-billed segment (anything poking ``active_s`` / ``per_request_j``
    behind the meter's back) is caught and named;
  * **conservation** — after every event, in joules AND grams:
    ``total == active + idle + preempt + xfer + lost`` and the per-request
    attribution plus the tracked unattributed remainder equals the active
    bucket;
  * **lost-work reclassification** — ``mark_lost`` must leave the totals
    bit-identical (a crash reclassifies energy, it never mints or refunds
    it) while moving exactly the victims' attribution into ``lost``;
  * **merge/absorb** — folding a contributor in must grow every bucket by
    exactly the contributor's content (the joule-preserving fold), and the
    per-source provenance must keep decomposing the total.

The checks cost a few comparisons per event, so the sanitizer is cheap
enough for CI: the ``REPRO_SANITIZE=1`` pytest job runs the whole serving
suite under it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterable, List, Optional

from repro_torch.energy.meter import EnergyMeter

# relative/absolute slack for float accumulation across long runs
_REL = 1e-9
_ABS = 1e-9
# record_* silently ignores dur <= 0; anything below this is a real sign
# error, not float residue from a subtraction like `uptime - billed`
_NEG_DUR = -1e-6

_TRACKED = ("active_s", "idle_s", "active_g", "idle_g", "preempt_s",
            "preempt_j", "preempt_g", "xfer_s", "xfer_j", "xfer_g",
            "lost_s", "lost_j", "lost_g", "total_tokens")


class ConservationError(AssertionError):
    """A billing invariant broke; the message carries the event context."""


def sanitize_enabled() -> bool:
    """Read the env var per call so tests can monkeypatch it on and off."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def new_meter(**kwargs) -> EnergyMeter:
    """The serving stack's one meter constructor: sanitized when
    ``REPRO_SANITIZE=1``, the plain meter otherwise."""
    if sanitize_enabled():
        return SanitizedEnergyMeter(**kwargs)
    return EnergyMeter(**kwargs)


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= _ABS + _REL * max(abs(a), abs(b))


@contextlib.contextmanager
def observation_guard(recorder, label: str = "monitor tick"):
    """R6 runtime proof: a pure observer may *read* the telemetry stream
    but never write it.

    The green-SRE monitor (``repro_torch.serving.monitor``) wraps every
    fleet tick in this guard when ``REPRO_SANITIZE=1``: the recorder's stream
    counters (events, capped drops, request records, deferral holds,
    sinks) and the span-attributed bucket ledgers are snapshotted before
    the observation and re-compared after it.  Any drift means the monitor
    perturbed the very stream it scores — the R6 violation — and raises
    :class:`ConservationError` with both states named.
    """
    before = (len(recorder.events), recorder.dropped,
              len(recorder.requests), len(recorder.holds),
              len(recorder.sinks))
    before_buckets = recorder.bucket_totals()
    yield
    after = (len(recorder.events), recorder.dropped,
             len(recorder.requests), len(recorder.holds),
             len(recorder.sinks))
    if after != before:
        raise ConservationError(
            f"R6 observer purity violated at {label}: recorder counters "
            f"moved {before} -> {after} (events, dropped, requests, holds, "
            f"sinks) — a monitor must never write the telemetry stream")
    if recorder.bucket_totals() != before_buckets:
        raise ConservationError(
            f"R6 observer purity violated at {label}: span-attributed "
            f"bucket ledgers changed during a read-only observation")


@dataclasses.dataclass
class SanitizedEnergyMeter(EnergyMeter):
    """Drop-in :class:`EnergyMeter` that audits every billing event."""

    def __post_init__(self):
        self._events: List[str] = []
        self._snapshot: Optional[Dict[str, float]] = None
        # active energy billed without per-request attribution (legacy
        # absorb path, plain-meter merges): tracked so the attribution
        # identity stays exact instead of becoming an inequality
        self._unattr_j = 0.0
        self._unattr_g = 0.0

    # -- plumbing -------------------------------------------------------------
    def _capture(self) -> Dict[str, float]:
        snap = {f: getattr(self, f) for f in _TRACKED}
        snap["sum_req_j"] = sum(self.per_request_j.values())
        snap["sum_req_g"] = sum(self.per_request_g.values())
        for src, d in self.by_source.items():
            for k, v in d.items():
                snap[f"by_source[{src}].{k}"] = v
        return snap

    def _fail(self, event: str, detail: str) -> None:
        recent = "; ".join(self._events[-4:]) or "<none>"
        raise ConservationError(
            f"energy conservation violated at {event}: {detail}\n"
            f"  recent events: {recent}\n"
            f"  meter summary: {self.summary()}")

    def _check_untouched(self, event: str) -> None:
        if self._snapshot is None:
            return
        now = self._capture()
        for k, v in self._snapshot.items():
            if now.get(k) != v:
                self._fail(
                    event,
                    f"field {k} changed outside the meter API "
                    f"(expected {v!r}, found {now.get(k)!r}) — some code "
                    "mis-billed a segment by mutating the meter directly")

    def _global_invariants(self, event: str) -> None:
        for f in ("active_s", "idle_s", "preempt_s", "preempt_j",
                  "preempt_g", "xfer_s", "xfer_j", "xfer_g",
                  "lost_s", "lost_j", "lost_g", "active_g", "idle_g"):
            v = getattr(self, f)
            if not (v == v) or v < -_ABS:  # NaN or negative bucket
                self._fail(event, f"bucket {f} is invalid: {v!r}")
        total = (self.active_j + self.idle_j + self.preempt_j
                 + self.xfer_j + self.lost_j)
        if not _close(self.total_j, total):
            self._fail(event, f"total_j {self.total_j} != active+idle+"
                              f"preempt+xfer+lost {total}")
        total_g = (self.active_g + self.idle_g + self.preempt_g
                   + self.xfer_g + self.lost_g)
        if not _close(self.total_g, total_g):
            self._fail(event, f"total_g {self.total_g} != active+idle+"
                              f"preempt+xfer+lost grams {total_g}")
        attr_j = sum(self.per_request_j.values()) + self._unattr_j
        if not _close(attr_j, self.active_j):
            self._fail(
                event,
                f"per-request joules {sum(self.per_request_j.values())} + "
                f"unattributed {self._unattr_j} != active_j "
                f"{self.active_j}")
        attr_g = sum(self.per_request_g.values()) + self._unattr_g
        if not _close(attr_g, self.active_g):
            self._fail(
                event,
                f"per-request grams {sum(self.per_request_g.values())} + "
                f"unattributed {self._unattr_g} != active_g "
                f"{self.active_g}")
        # span/meter reconciliation: when a telemetry sink observes
        # this meter, its span-attributed bucket sums must track the meter's
        # buckets exactly — joules AND grams — after every event
        tr = self.tracer
        if tr is not None and getattr(tr, "bucket_j", None) is not None:
            for bucket, want_j, want_g in (
                    ("active", self.active_j, self.active_g),
                    ("idle", self.idle_j, self.idle_g),
                    ("preempt", self.preempt_j, self.preempt_g),
                    ("xfer", self.xfer_j, self.xfer_g),
                    ("lost", self.lost_j, self.lost_g)):
                got_j = tr.bucket_j.get(bucket, 0.0)
                got_g = tr.bucket_g.get(bucket, 0.0)
                if not _close(got_j, want_j):
                    self._fail(event,
                               f"span-attributed {bucket} joules {got_j} "
                               f"!= meter bucket {want_j}")
                if not _close(got_g, want_g):
                    self._fail(event,
                               f"span-attributed {bucket} grams {got_g} "
                               f"!= meter bucket {want_g}")

    def _seal(self, event: str) -> None:
        self._global_invariants(event)
        self._events.append(event)
        if len(self._events) > 64:
            del self._events[:32]
        self._snapshot = self._capture()

    # -- audited events -------------------------------------------------------
    def record_active(self, dur_s: float, rids: Iterable[int] = (),
                      tokens: int = 0, t_s: Optional[float] = None,
                      power_w: Optional[float] = None) -> float:
        rids = list(rids)
        ev = (f"record_active(dur_s={dur_s!r}, rids={rids!r}, "
              f"tokens={tokens}, t_s={t_s!r}, power_w={power_w!r})")
        self._check_untouched(ev)
        if dur_s < _NEG_DUR:
            self._fail(ev, f"negative duration {dur_s}")
        pre_s, pre_g = self.active_s, self.active_g
        pre_req_j = sum(self.per_request_j.values())
        j = super().record_active(dur_s, rids, tokens, t_s, power_w)
        # a power override is folded in as equivalent seconds at the
        # meter's own active power (the merge idiom)
        exp_s = dur_s
        if power_w is not None and self.active_power_w > 0:
            exp_s = dur_s * power_w / self.active_power_w
        d_s = self.active_s - pre_s
        if dur_s > 0 and not _close(d_s, exp_s):
            self._fail(ev, f"active_s moved by {d_s}, expected {exp_s}")
        if not rids:
            self._unattr_j += j
            self._unattr_g += self.active_g - pre_g
        else:
            d_req = sum(self.per_request_j.values()) - pre_req_j
            if not _close(d_req, j):
                self._fail(ev, f"attributed {d_req} J of a {j} J event")
        self._seal(ev)
        return j

    def record_active_shared(self, start_s: float,
                             done_by_rid: Dict[int, float],
                             tokens: int = 0,
                             power_w: Optional[float] = None) -> float:
        ev = (f"record_active_shared(start_s={start_s!r}, "
              f"done_by_rid={dict(done_by_rid)!r}, tokens={tokens}, "
              f"power_w={power_w!r})")
        self._check_untouched(ev)
        pre_s = self.active_s
        pre_g = self.active_g
        pre_req_j = sum(self.per_request_j.values())
        pre_req_g = sum(self.per_request_g.values())
        j = super().record_active_shared(start_s, done_by_rid, tokens,
                                         power_w)
        # the window is fully attributed: segment shares must sum back to
        # the seconds and grams the window added
        d_j = (self.active_s - pre_s) * self.active_power_w
        if not _close(sum(self.per_request_j.values()) - pre_req_j, d_j):
            self._fail(ev, "per-request joule shares do not sum to the "
                           f"window's {d_j} J")
        d_g = self.active_g - pre_g
        if not _close(sum(self.per_request_g.values()) - pre_req_g, d_g):
            self._fail(ev, "per-request gram shares do not sum to the "
                           f"window's {d_g} g")
        self._seal(ev)
        return j

    def record_idle(self, dur_s: float,
                    t_s: Optional[float] = None) -> float:
        ev = f"record_idle(dur_s={dur_s!r}, t_s={t_s!r})"
        self._check_untouched(ev)
        if dur_s < _NEG_DUR:
            self._fail(ev, f"negative duration {dur_s}")
        pre = self.idle_s
        j = super().record_idle(dur_s, t_s)
        if dur_s > 0 and not _close(self.idle_s - pre, dur_s):
            self._fail(ev, f"idle_s moved by {self.idle_s - pre}, "
                           f"expected {dur_s}")
        self._seal(ev)
        return j

    def record_preempt(self, dur_s: float,
                       t_s: Optional[float] = None) -> float:
        ev = f"record_preempt(dur_s={dur_s!r}, t_s={t_s!r})"
        self._check_untouched(ev)
        if dur_s < _NEG_DUR:
            self._fail(ev, f"negative duration {dur_s}")
        pre_j = self.preempt_j
        j = super().record_preempt(dur_s, t_s)
        if dur_s > 0 and not _close(
                self.preempt_j - pre_j, dur_s * self.active_power_w):
            self._fail(ev, "preempt joules diverge from dur x active power")
        self._seal(ev)
        return j

    def record_xfer(self, dur_s: float, power_w: float,
                    t_s: Optional[float] = None) -> float:
        ev = (f"record_xfer(dur_s={dur_s!r}, power_w={power_w!r}, "
              f"t_s={t_s!r})")
        self._check_untouched(ev)
        if dur_s < _NEG_DUR:
            self._fail(ev, f"negative duration {dur_s}")
        pre_j = self.xfer_j
        j = super().record_xfer(dur_s, power_w, t_s)
        if dur_s > 0 and not _close(self.xfer_j - pre_j, dur_s * power_w):
            self._fail(ev, "xfer joules diverge from dur x link power")
        self._seal(ev)
        return j

    def mark_lost(self, rids: Iterable[int],
                  t_s: Optional[float] = None) -> float:
        rids = list(rids)
        ev = f"mark_lost(rids={rids!r}, t_s={t_s!r})"
        self._check_untouched(ev)
        pre_total_j, pre_total_g = self.total_j, self.total_g
        pre_lost_j = self.lost_j
        want = sum(self.per_request_j.get(rid, 0.0)
                   for rid in sorted(set(rids)))
        moved = super().mark_lost(rids, t_s)
        # a crash reclassifies energy — it must never mint or refund it
        if not _close(self.total_j, pre_total_j):
            self._fail(ev, f"total_j moved {pre_total_j} -> {self.total_j}; "
                           "mark_lost must be a pure reclassification")
        if not _close(self.total_g, pre_total_g):
            self._fail(ev, f"total_g moved {pre_total_g} -> {self.total_g}; "
                           "mark_lost must be a pure reclassification")
        if not _close(self.lost_j - pre_lost_j, want):
            self._fail(ev, f"lost_j grew by {self.lost_j - pre_lost_j}, "
                           f"expected the victims' attributed {want} J")
        self._seal(ev)
        return moved

    def merge(self, other: EnergyMeter,
              source: Optional[str] = None) -> EnergyMeter:
        ev = (f"merge(other=<{type(other).__name__} total_j="
              f"{other.total_j:.6f} total_g={other.total_g:.6f}>, "
              f"source={source!r})")
        self._check_untouched(ev)
        pre = self._capture()
        pre_total_j, pre_total_g = self.total_j, self.total_g
        super().merge(other, source=source)
        # the joule-preserving fold: the aggregate grows by exactly the
        # contributor's content (when a power rate is zero the fold keeps
        # seconds instead, and the joule identity is vacuous)
        if self.active_power_w > 0 and self.idle_power_w > 0:
            if not _close(self.total_j, pre_total_j + other.total_j):
                self._fail(
                    ev,
                    f"total_j moved {pre_total_j} -> {self.total_j}, "
                    f"expected +{other.total_j}")
        if not _close(self.total_g, pre_total_g + other.total_g):
            self._fail(ev, f"total_g moved {pre_total_g} -> {self.total_g}, "
                           f"expected +{other.total_g}")
        for f in ("preempt_j", "preempt_g", "xfer_j", "xfer_g",
                  "lost_j", "lost_g"):
            moved = getattr(self, f) - pre[f]
            want = getattr(other, f)
            if not _close(moved, want):
                self._fail(ev, f"{f} moved by {moved}, expected {want}")
        # carry the contributor's unattributed remainder so the attribution
        # identity keeps holding on the aggregate
        if isinstance(other, SanitizedEnergyMeter):
            self._unattr_j += other._unattr_j
            self._unattr_g += other._unattr_g
        else:
            self._unattr_j += other.active_j - sum(
                other.per_request_j.values())
            self._unattr_g += other.active_g - sum(
                other.per_request_g.values())
        self._seal(ev)
        return self
