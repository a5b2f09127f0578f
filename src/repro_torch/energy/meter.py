"""EnergyMeter: first-class serving-energy accounting (active vs idle draw).

Järvenpää et al. ("Green Architectural Tactics for ML-Enabled Systems") argue
energy accounting must be a first-class architectural component rather than an
afterthought; previously every scheduler here computed ``wall * power`` inline.
All serving-side joule accounting now flows through one ``EnergyMeter`` that
distinguishes the two power bins that matter for green serving decisions:

  * **active** seconds — the engine is executing (prefill/decode); billed at
    the active package power and *attributed to the resident requests*, so
    J/request reflects who actually occupied the hardware;
  * **idle** seconds — the endpoint is provisioned but waiting (gaps between
    arrivals, autoscaled replicas sitting warm); billed at the idle power and
    charged to the endpoint, not to any request.

Two further buckets price the admission-layer tactics so their cost is
visible instead of smeared into active/idle:

  * **preempt** seconds — pause/resume overhead when a latency-critical
    dispatch preempts an in-flight decode batch (the KV save/restore work);
    billed at the active power, charged to the endpoint;
  * **xfer** seconds — KV-cache handoff between disaggregated prefill and
    decode pools; billed at the *link's* power (the joules are accumulated,
    not derived from seconds, because the link power is not the replica's).

One bucket prices the resilience layer: **lost** — compute a crashed
replica had already billed for requests whose responses never made it out.
:meth:`mark_lost` *reclassifies* that energy (it was genuinely drawn; the
crash does not refund joules): the victims' per-request attribution moves
from the active bucket to ``lost``, so wasted work shows up as its own line
instead of being indistinguishable from useful compute.

Every joule is also billed in **grams of CO2e** through a
:class:`repro_torch.carbon.signal.CarbonSignal` — billed at the virtual time the
energy was drawn (``t_s`` on every recording call), so the same joules cost
different grams on a dirty evening peak than in a solar valley.  A meter
without an explicit signal uses the constant IEA-average signal, which
reproduces the old static ``J -> g`` conversion exactly.

Conservation invariants (tested): the per-request attribution always sums to
the active energy, ``total_j == active_j + idle_j + preempt_j + xfer_j +
lost_j`` — and identically in grams: ``sum(per_request_g) == active_g`` and
``total_g == active_g + idle_g + preempt_g + xfer_g + lost_g``, preserved
across :meth:`merge` / :func:`absorb_part` (a meter that never preempts,
hands off, or loses work has zero in the new buckets, reproducing the old
two-bucket identities exactly).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from repro_torch.carbon.signal import CarbonSignal, ConstantSignal
from repro_torch.energy.hw import HOST_CPU_IDLE_POWER_W, HOST_CPU_POWER_W

# the static-world fallback: one flat IEA-average grid
_CONSTANT_SIGNAL = ConstantSignal()


def estimate_j_per_token(active_power_w: float, prefill_s: float,
                         decode_s: float, batch: int,
                         max_new_tokens: int) -> float:
    """Predicted J/token of a batched dispatch from measured step times.

    The ONE pricing formula shared by the adaptive policy's batch sizing and
    the fleet's route-to-greenest marginal-cost ranking, so refining the
    energy model keeps admission and routing consistent.  (The carbon-aware
    router multiplies this by the replica zone's intensity to get marginal
    gCO2/token — same formula, different unit.)
    """
    return (active_power_w * (prefill_s + decode_s)
            / (max(batch, 1) * max(max_new_tokens, 1)))


def measured_j(wall_s: float, power_w: float) -> float:
    """The ONE sanctioned wall x power conversion (simlint R1 billed-time).

    Host-side measurement paths that convert a measured wall time and an
    assumed package power into joules must route through here (or through a
    recording meter), so the billing arithmetic never re-forks into inline
    copies across schedulers and estimators.
    """
    return wall_s * power_w


def absorb_part(meter: "EnergyMeter", m,
                source: Optional[str] = None) -> "EnergyMeter":
    """Fold one partition's :class:`~repro_torch.serving.request.ServingMetrics`
    into an aggregate meter.

    The (fixed) legacy merge path for callers that combine metrics *outside*
    the fleet — e.g. results of separate ``ServingServer.handle`` calls.  The
    fleet always has per-replica meters and merges with provenance; this
    helper exists so any external aggregation inherits the corrected
    accounting: a partition without an EnergyMeter is billed as active
    compute with *its own* token count — never a running cumulative total,
    which used to inflate per-token attribution for every partition after
    the first (regression-tested).
    """
    if m.meter is not None:
        meter.merge(m.meter, source=source)
    else:
        meter.record_active(m.wall_compute_s, tokens=m.total_tokens)
    return meter


@dataclasses.dataclass
class EnergyMeter:
    # Telemetry observer (a per-replica sink installed by the fleet when
    # `ServingSpec.telemetry.enabled`): every record_* call notifies it with
    # the exact joule/gram deltas it just billed, so span-attributed energy
    # reconciles with the buckets *by construction*.  Deliberately a plain
    # CLASS attribute, not a dataclass field — `asdict`, `merge` provenance
    # and the sanitizer's tamper snapshot never see it, so observing a meter
    # cannot perturb the accounting contract.  `merge` never notifies:
    # aggregate meters stay untraced (their content was already observed on
    # the contributing replicas).
    tracer = None

    active_power_w: float = HOST_CPU_POWER_W
    idle_power_w: float = HOST_CPU_IDLE_POWER_W
    # grid carbon-intensity signal for gram billing; None = constant IEA
    carbon: Optional[CarbonSignal] = None
    active_s: float = 0.0
    idle_s: float = 0.0
    # grams are accumulated (not derived like joules): with a time-varying
    # signal they depend on WHEN each second was billed, and a merge must
    # preserve them absolutely across meters with different signals/zones
    active_g: float = 0.0
    idle_g: float = 0.0
    # admission-layer buckets: preemption pause/resume overhead and KV-cache
    # handoff transfers.  Joules are accumulated (xfer bills at the link's
    # power, not this meter's), grams at the drawing instant like everything
    # else; both survive merge/absorb verbatim
    preempt_s: float = 0.0
    preempt_j: float = 0.0
    preempt_g: float = 0.0
    xfer_s: float = 0.0
    xfer_j: float = 0.0
    xfer_g: float = 0.0
    # resilience bucket: compute already billed for requests whose responses
    # a crash destroyed.  mark_lost() MOVES energy here from active (and the
    # victims' attribution) — a reclassification, never a new draw — so the
    # joules/grams are accumulated and survive merge verbatim like xfer
    lost_s: float = 0.0
    lost_j: float = 0.0
    lost_g: float = 0.0
    total_tokens: int = 0
    per_request_j: Dict[int, float] = dataclasses.field(default_factory=dict)
    per_request_g: Dict[int, float] = dataclasses.field(default_factory=dict)
    # provenance of merged meters (fleet use): source -> active/idle split
    by_source: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    @property
    def signal(self) -> CarbonSignal:
        return self.carbon if self.carbon is not None else _CONSTANT_SIGNAL

    def _grams(self, j: float, t_s: Optional[float], dur_s: float) -> float:
        t0 = 0.0 if t_s is None else t_s
        return self.signal.grams(j, t0, t0 + dur_s)

    # -- recording ------------------------------------------------------------
    def record_active(self, dur_s: float, rids: Iterable[int] = (),
                      tokens: int = 0, t_s: Optional[float] = None,
                      power_w: Optional[float] = None) -> float:
        """Bill ``dur_s`` of compute starting at virtual time ``t_s``, split
        equally across resident ``rids`` (joules and grams alike).

        ``power_w`` overrides the draw for this window (brownout power caps
        clamp the package below ``active_power_w``).  The override is folded
        in as *equivalent seconds* at this meter's active power — the merge
        idiom — so ``active_j`` stays derived and conservation exact."""
        if dur_s <= 0:
            return 0.0
        pw = self.active_power_w if power_w is None else power_w
        j = dur_s * pw
        g = self._grams(j, t_s, dur_s)
        self.active_s += (j / self.active_power_w
                          if self.active_power_w > 0 else dur_s)
        self.active_g += g
        self.total_tokens += tokens
        rids = list(rids)
        if rids:
            share, share_g = j / len(rids), g / len(rids)
            for rid in rids:
                self.per_request_j[rid] = \
                    self.per_request_j.get(rid, 0.0) + share
                self.per_request_g[rid] = \
                    self.per_request_g.get(rid, 0.0) + share_g
        if self.tracer is not None:
            self.tracer.on_energy("active", t_s, dur_s, j, g,
                                  rids=rids, tokens=tokens)
        return j

    def record_active_shared(self, start_s: float,
                             done_by_rid: Dict[int, float],
                             tokens: int = 0,
                             power_w: Optional[float] = None) -> float:
        """Bill a batched compute window where requests retire individually.

        The window spans ``[start_s, max(done)]``.  It is cut into segments at
        each retirement instant; each segment's energy is split across the
        requests still resident, so a short request in a batch is *not*
        charged for the tail where only long requests occupy the engine.
        Grams are billed per segment at the segment's own instant on the
        carbon signal, so the per-request gram attribution sums exactly to
        the active grams this window added.  ``power_w`` overrides the draw
        (brownout caps) and is folded in as equivalent seconds, exactly as
        in :meth:`record_active`.
        """
        if not done_by_rid:
            return 0.0
        pw = self.active_power_w if power_w is None else power_w
        end = max(done_by_rid.values())
        dur = end - start_s
        if dur <= 0:
            for rid in done_by_rid:        # zero-duration requests: J = g = 0
                self.per_request_j.setdefault(rid, 0.0)
                self.per_request_g.setdefault(rid, 0.0)
            return 0.0
        self.active_s += (dur * pw / self.active_power_w
                          if self.active_power_w > 0 else dur)
        self.total_tokens += tokens
        t = start_s
        win_g = 0.0
        for e in sorted(set(done_by_rid.values())):
            seg = e - t
            if seg <= 0:
                continue
            resident = [rid for rid, d in done_by_rid.items() if d > t]
            seg_j = seg * pw
            seg_g = self.signal.grams(seg_j, t, e)
            self.active_g += seg_g
            win_g += seg_g
            share = seg_j / max(len(resident), 1)
            share_g = seg_g / max(len(resident), 1)
            for rid in resident:
                self.per_request_j[rid] = \
                    self.per_request_j.get(rid, 0.0) + share
                self.per_request_g[rid] = \
                    self.per_request_g.get(rid, 0.0) + share_g
            t = e
        for rid in done_by_rid:              # zero-duration requests: J = 0
            self.per_request_j.setdefault(rid, 0.0)
            self.per_request_g.setdefault(rid, 0.0)
        if self.tracer is not None:
            self.tracer.on_energy("active", start_s, dur, dur * pw, win_g,
                                  rids=list(done_by_rid), tokens=tokens)
        return dur * pw

    def record_idle(self, dur_s: float, t_s: Optional[float] = None) -> float:
        if dur_s <= 0:
            return 0.0
        j = dur_s * self.idle_power_w
        g = self._grams(j, t_s, dur_s)
        self.idle_s += dur_s
        self.idle_g += g
        if self.tracer is not None:
            self.tracer.on_energy("idle", t_s, dur_s, j, g)
        return j

    def record_preempt(self, dur_s: float,
                       t_s: Optional[float] = None) -> float:
        """Bill pause/resume overhead of an in-replica preemption: the
        engine is busy saving/restoring state, so the seconds draw active
        power — but they belong to the *tactic*, not to any request."""
        if dur_s <= 0:
            return 0.0
        j = dur_s * self.active_power_w
        g = self._grams(j, t_s, dur_s)
        self.preempt_s += dur_s
        self.preempt_j += j
        self.preempt_g += g
        if self.tracer is not None:
            self.tracer.on_energy("preempt", t_s, dur_s, j, g)
        return j

    def record_xfer(self, dur_s: float, power_w: float,
                    t_s: Optional[float] = None) -> float:
        """Bill a KV-cache handoff: ``dur_s`` on the link at the *link's*
        power.  The transfer overlaps the replica's own timeline (the link
        streams while the replica serves on), so these seconds are extra
        energy, never replica busy-time."""
        if dur_s <= 0:
            return 0.0
        j = dur_s * power_w
        g = self._grams(j, t_s, dur_s)
        self.xfer_s += dur_s
        self.xfer_j += j
        self.xfer_g += g
        if self.tracer is not None:
            self.tracer.on_energy("xfer", t_s, dur_s, j, g)
        return j

    def mark_lost(self, rids: Iterable[int],
                  t_s: Optional[float] = None) -> float:
        """Reclassify the compute already billed to ``rids`` as lost.

        Called when a crash destroys a replica's undelivered responses at
        virtual instant ``t_s``: the energy was genuinely drawn, so totals
        do NOT change — each victim's attributed joules/grams move from the
        active bucket (and the per-request maps) into ``lost``, and the
        equivalent active seconds move to ``lost_s`` so busy time stays
        decomposable.  Unknown rids are ignored (nothing was billed to
        them here).  Returns the joules moved."""
        # the reclassification is instant-free (grams move verbatim); t_s
        # only timestamps the crash-loss marker on the trace
        moved = 0.0
        victims = [] if self.tracer is not None else None
        for rid in rids:
            j = self.per_request_j.pop(rid, 0.0)
            g = self.per_request_g.pop(rid, 0.0)
            if j == 0.0 and g == 0.0:
                continue
            s = j / self.active_power_w if self.active_power_w > 0 else 0.0
            self.active_s -= s
            self.active_g -= g
            self.lost_s += s
            self.lost_j += j
            self.lost_g += g
            moved += j
            if victims is not None:
                victims.append((rid, j, g))
        if victims:
            self.tracer.on_lost(t_s, victims)
        return moved

    def merge(self, other: "EnergyMeter",
              source: Optional[str] = None) -> "EnergyMeter":
        """Fold ``other`` into this meter.

        With ``source`` set (fleet use: ``"endpoint/r3"``) the merged meter
        keeps per-source provenance — the active/idle second, joule and gram
        split of every contributor — so a fleet total can always be
        decomposed back into its replicas (and that decomposition is what
        the conservation tests check).  The merge is *joule-preserving*: a
        contributor's energy is folded in as equivalent seconds at THIS
        meter's power rates, so ``total_j`` equals the sum of its
        contributors even when replicas run at heterogeneous power
        envelopes.  Grams are carried over verbatim — they were already
        priced at the contributor's own zone signal and drawing time, which
        the aggregate could not reconstruct.
        """
        if self.active_power_w > 0:
            self.active_s += other.active_j / self.active_power_w
        else:
            self.active_s += other.active_s
        if self.idle_power_w > 0:
            self.idle_s += other.idle_j / self.idle_power_w
        else:
            self.idle_s += other.idle_s
        self.active_g += other.active_g
        self.idle_g += other.idle_g
        # admission buckets carry over verbatim (joules AND grams were
        # already priced at the contributor's own power/zone/time)
        self.preempt_s += other.preempt_s
        self.preempt_j += other.preempt_j
        self.preempt_g += other.preempt_g
        self.xfer_s += other.xfer_s
        self.xfer_j += other.xfer_j
        self.xfer_g += other.xfer_g
        self.lost_s += other.lost_s
        self.lost_j += other.lost_j
        self.lost_g += other.lost_g
        self.total_tokens += other.total_tokens
        for rid, j in other.per_request_j.items():
            self.per_request_j[rid] = self.per_request_j.get(rid, 0.0) + j
        for rid, g in other.per_request_g.items():
            self.per_request_g[rid] = self.per_request_g.get(rid, 0.0) + g
        if other.by_source:            # nested merge: carry provenance through
            for src, d in other.by_source.items():
                self._add_source(src, d["active_s"], d["idle_s"],
                                 d["active_j"], d["idle_j"],
                                 d.get("active_g", 0.0), d.get("idle_g", 0.0),
                                 d.get("preempt_j", 0.0),
                                 d.get("preempt_g", 0.0),
                                 d.get("xfer_j", 0.0), d.get("xfer_g", 0.0),
                                 d.get("lost_j", 0.0), d.get("lost_g", 0.0))
        elif source is not None:
            self._add_source(source, other.active_s, other.idle_s,
                             other.active_j, other.idle_j,
                             other.active_g, other.idle_g,
                             other.preempt_j, other.preempt_g,
                             other.xfer_j, other.xfer_g,
                             other.lost_j, other.lost_g)
        return self

    def _add_source(self, source: str, active_s: float, idle_s: float,
                    active_j: float, idle_j: float,
                    active_g: float = 0.0, idle_g: float = 0.0,
                    preempt_j: float = 0.0, preempt_g: float = 0.0,
                    xfer_j: float = 0.0, xfer_g: float = 0.0,
                    lost_j: float = 0.0, lost_g: float = 0.0) -> None:
        d = self.by_source.setdefault(
            source, {"active_s": 0.0, "idle_s": 0.0,
                     "active_j": 0.0, "idle_j": 0.0,
                     "active_g": 0.0, "idle_g": 0.0,
                     "preempt_j": 0.0, "preempt_g": 0.0,
                     "xfer_j": 0.0, "xfer_g": 0.0,
                     "lost_j": 0.0, "lost_g": 0.0})
        d["active_s"] += active_s
        d["idle_s"] += idle_s
        d["active_j"] += active_j
        d["idle_j"] += idle_j
        d["active_g"] += active_g
        d["idle_g"] += idle_g
        d["preempt_j"] += preempt_j
        d["preempt_g"] += preempt_g
        d["xfer_j"] += xfer_j
        d["xfer_g"] += xfer_g
        d["lost_j"] += lost_j
        d["lost_g"] += lost_g

    # -- accounting -----------------------------------------------------------
    @property
    def active_j(self) -> float:
        return self.active_s * self.active_power_w

    @property
    def idle_j(self) -> float:
        return self.idle_s * self.idle_power_w

    @property
    def total_j(self) -> float:
        return (self.active_j + self.idle_j + self.preempt_j + self.xfer_j
                + self.lost_j)

    @property
    def total_g(self) -> float:
        return (self.active_g + self.idle_g + self.preempt_g + self.xfer_g
                + self.lost_g)

    @property
    def energy_per_token_j(self) -> float:
        return self.total_j / max(self.total_tokens, 1)

    @property
    def g_per_token(self) -> float:
        return self.total_g / max(self.total_tokens, 1)

    def energy_per_request_j(self, rid: int) -> float:
        return self.per_request_j.get(rid, 0.0)

    def g_per_request(self, rid: int) -> float:
        return self.per_request_g.get(rid, 0.0)

    def summary(self) -> dict:
        d = {
            "active_s": round(self.active_s, 6),
            "idle_s": round(self.idle_s, 6),
            "active_j": round(self.active_j, 6),
            "idle_j": round(self.idle_j, 6),
            "total_j": round(self.total_j, 6),
            "j_per_token": round(self.energy_per_token_j, 6),
            "active_g": round(self.active_g, 6),
            "idle_g": round(self.idle_g, 6),
            "total_g": round(self.total_g, 6),
            # grams/token sits at 1e-6..1e-5: 9 decimals keeps ~4 sig figs
            "g_per_token": round(self.g_per_token, 9),
        }
        if self.preempt_s or self.xfer_s:
            d["preempt_s"] = round(self.preempt_s, 6)
            d["preempt_j"] = round(self.preempt_j, 6)
            d["preempt_g"] = round(self.preempt_g, 9)
            d["xfer_s"] = round(self.xfer_s, 6)
            d["xfer_j"] = round(self.xfer_j, 6)
            d["xfer_g"] = round(self.xfer_g, 9)
        if self.lost_s or self.lost_j:
            d["lost_s"] = round(self.lost_s, 6)
            d["lost_j"] = round(self.lost_j, 6)
            d["lost_g"] = round(self.lost_g, 9)
        if self.by_source:
            d["by_source"] = {
                src: {k: round(v, 6) for k, v in split.items()}
                for src, split in sorted(self.by_source.items())
            }
        return d
