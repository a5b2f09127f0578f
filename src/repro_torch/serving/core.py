"""Event-driven serving core: ONE virtual-clock loop for every TD3 policy.

Previously each scheduler (realtime / dynamic / continuous) carried its own
copy of the virtual-clock loop and its own inline ``wall * power`` energy
math.  ``SchedulerCore`` owns everything a request-processing policy does not
care about:

  * the **virtual clock** and the sorted **arrival queue**;
  * **admission events** — policies pop arrivals and decide what to dispatch;
  * **retirement events** — per-request completion times (each request
    retires at the step where its own last token lands, not at the end of
    the longest request in its batch);
  * **energy metering** — every active/idle second flows through one
    :class:`repro_torch.energy.meter.EnergyMeter`; no policy touches power
    constants;
  * **measured-step-time replay** — engine calls route through
    :meth:`SchedulerCore.timed`, so a warm :class:`StepTimeCache` replays
    recorded durations on the virtual clock instead of re-executing the
    model (1k+ request workloads simulate in seconds).

A policy implements three small hooks (:meth:`SchedulingPolicy.reset`,
:meth:`~SchedulingPolicy.step`, :meth:`~SchedulingPolicy.active`) and drives
the core's primitives; see ``repro_torch.serving.scheduler`` for the four
concrete policies.

Two entry modes share one event loop:

  * **batch mode** — :meth:`SchedulerCore.run` takes a whole workload and
    drains it to completion;
  * **incremental mode** — :meth:`~SchedulerCore.begin`, then a router feeds
    arrivals one at a time via :meth:`~SchedulerCore.offer` and advances the
    replica with :meth:`~SchedulerCore.drain_until`; :meth:`~SchedulerCore.
    finish` closes the run.  This is what the replica fleet (not ported
    yet) uses to run N cores on one shared virtual timeline.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.carbon.signal import CarbonSignal
from repro_torch.core.engines import Engine
from repro_torch.energy.hw import HOST_CPU_IDLE_POWER_W, HOST_CPU_POWER_W
from repro_torch.energy.sanitize import new_meter
from repro_torch.serving.admission.priority import AdmissionControl, priority_level
from repro_torch.serving.queue import PendingQueue
from repro_torch.serving.request import Request, Response, ServingMetrics
from repro_torch.serving.stepcache import StepTimeCache, shape_bucket, synth_tokens


def pad_prompts(prompts: List[np.ndarray],
                width: Optional[int] = None) -> np.ndarray:
    """Left-align, zero-pad to ``width`` (default: the max prompt length)."""
    S = width if width is not None else max(len(p) for p in prompts)
    out = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        out[i, : len(p)] = p
    return out


class SchedulingPolicy:
    """Admission/dispatch policy plugged into a :class:`SchedulerCore`.

    ``step`` handles one scheduling event (admit a batch, advance a decode
    step, ...) using the core's primitives and MUST make progress — either
    consume pending arrivals, retire active work, or advance the clock.

    ``admission_lookahead_s`` tells an incremental caller (the fleet) how far
    past an arrival this policy's admission window extends: a windowing
    policy must not be drained right up to the routing frontier, or it would
    close batches that later-routed arrivals could still have joined.
    """

    name = "abstract"
    admission_lookahead_s = 0.0

    def reset(self, core: "SchedulerCore") -> None:
        """Called at the start of every run; (re)initialize policy state."""

    def active(self, core: "SchedulerCore") -> bool:
        """True while the policy holds admitted-but-unretired work."""
        return False

    def step(self, core: "SchedulerCore") -> None:
        raise NotImplementedError


class SchedulerCore:
    """Virtual-clock event loop shared by every request-processing policy."""

    def __init__(self, engine: Engine, policy: SchedulingPolicy, *,
                 step_cache: Optional[StepTimeCache] = None,
                 active_power_w: float = HOST_CPU_POWER_W,
                 idle_power_w: float = HOST_CPU_IDLE_POWER_W,
                 carbon: Optional[CarbonSignal] = None,
                 admission: Optional[AdmissionControl] = None):
        self.engine = engine
        self.policy = policy
        self.step_cache = step_cache
        self.active_power_w = active_power_w
        self.idle_power_w = idle_power_w
        self.carbon = carbon
        # priority ladder / preemption contract; None = FIFO, never preempt
        self.admission = admission
        # brownout power-cap windows [(t0_s, t1_s, cap_frac), ...] set by
        # the fleet's chaos runtime: a dispatch starting inside a window
        # runs with package power clamped to cap_frac x active power and
        # its measured step times stretched by the inverse (same joules,
        # longer steps — a first-order DVFS model).  Empty = never capped,
        # which is byte-identical to the pre-chaos core
        self.power_caps: List[Tuple[float, float, float]] = []
        # telemetry sink (a TraceRecorder._ReplicaSink) installed by the
        # fleet between core construction and Replica bring-up; None = no
        # tracing.  _reset re-binds it to each fresh meter so every billing
        # event of every meter lifetime is observed.  Pure observer: a
        # traced run is bit-identical to an untraced one.
        self.tracer = None
        self._reset([])

    def _reset(self, workload: List[Request]) -> None:
        # rung indices only under a ladder: the FIFO path must never
        # classify priority names (unknown names must not raise)
        self.pending = PendingQueue(workload,
                                    use_rungs=self.admission is not None)
        self.clock = 0.0
        self.wall = 0.0
        self.responses: List[Response] = []
        self.total_tokens = 0
        # new_meter returns the conservation-auditing wrapper when
        # REPRO_SANITIZE=1 (see repro_torch.energy.sanitize), the plain meter
        # otherwise
        self.meter = new_meter(active_power_w=self.active_power_w,
                               idle_power_w=self.idle_power_w,
                               carbon=self.carbon)
        if self.tracer is not None:
            self.tracer.reset()
            self.meter.tracer = self.tracer

    # -- arrival queue --------------------------------------------------------
    @property
    def now(self) -> float:
        return self.clock

    def peek(self) -> Optional[Request]:
        return self.pending.peek()

    def pop(self) -> Request:
        return self.pending.pop()

    def has_pending(self) -> bool:
        return self.pending.has_pending()

    # -- priority-ordered admission (repro_torch.serving.admission) -----------------
    def peek_next(self, visible_t: Optional[float] = None) -> Optional[Request]:
        """The request :meth:`pop_next` would return, without removing it."""
        nxt = self.peek()
        if self.admission is None or nxt is None:
            return nxt
        t = visible_t if visible_t is not None \
            else max(self.clock, nxt.arrival_s)
        best = self.pending.peek_best(t)
        return nxt if best is None else best

    def pop_next(self, visible_t: Optional[float] = None) -> Request:
        """FIFO pop — unless an admission ladder is configured, in which
        case the most urgent request among those arrived by ``visible_t``
        (default: the head arrival's instant) is popped first.  With no
        backlog this degenerates to FIFO, so enabling priorities on an
        uncongested queue changes nothing."""
        if self.admission is None:
            return self.pop()
        nxt = self.peek()
        t = visible_t if visible_t is not None \
            else max(self.clock, nxt.arrival_s)
        best = self.pending.pop_best(t)
        if best is None:
            return self.pop()
        return best

    def _pop_preemptor(self, level: int, before_s: float) -> Optional[Request]:
        """Remove and return the earliest pending arrival strictly more
        urgent than ``level`` arriving strictly before ``before_s``."""
        return self.pending.pop_preemptor(level, before_s)

    def pending_within(self, t: float) -> List[Request]:
        """Queued-but-unpopped arrivals with ``arrival_s <= t`` (for SLO-aware
        policies that size a batch from what is visible in the window) — a
        bisected slice view, not a rescan of the whole backlog."""
        return self.pending.pending_within(t)

    @property
    def vocab(self) -> int:
        cfg = getattr(self.engine, "cfg", None)
        return int(getattr(cfg, "vocab_size", 1 << 30) or (1 << 30))

    # -- clock / energy events ------------------------------------------------
    def advance_to(self, t: float) -> None:
        """Idle until virtual time ``t`` (endpoint provisioned, not working)."""
        if t > self.clock:
            self.meter.record_idle(t - self.clock, t_s=self.clock)
            self.clock = t

    def provision(self, created_s: float, ready_s: float) -> None:
        """Cold-start bootstrap: the replica is provisioned (drawing idle
        power) from ``created_s`` and able to serve from ``ready_s``; the
        clock lands on the ready instant.  This is the one sanctioned way
        to start a core's timeline mid-run — a bare ``core.clock = t``
        elsewhere would skip the provisioning bill (simlint R4)."""
        if ready_s > created_s:
            self.meter.record_idle(ready_s - created_s, t_s=created_s)
        self.clock = ready_s

    def advance_active(self, dur_s: float, rids=(), tokens: int = 0) -> None:
        """Advance the clock through ``dur_s`` of compute billed to ``rids``."""
        self.meter.record_active(dur_s, rids, tokens, t_s=self.clock)
        self.wall += dur_s
        self.clock += dur_s

    # -- measured/replayed engine execution -----------------------------------
    def timed(self, key: tuple,
              thunk: Callable[[], Tuple[Tuple[float, ...], object]]):
        """Execute ``thunk`` on a cache miss; replay its duration on a hit.

        ``thunk`` returns ``(durations, result)``; on a hit the recorded
        durations come back with ``result=None`` (callers synthesize tokens).
        """
        if self.step_cache is not None:
            hit = self.step_cache.get(key)
            if hit is not None:
                return hit, None
        payload, result = thunk()
        if self.step_cache is not None:
            self.step_cache.put(key, payload)
        return payload, result

    # -- the shared admit -> generate -> retire path --------------------------
    def _timed_generate(self, batch: List[Request]):
        """Measure-or-replay one uniform generate for ``batch``; returns
        ``(prefill_s, decode_s, result_or_None, max_new)``.

        Pads to the power-of-two bucket the cache key names, so the
        compiled executable (and its measured duration) is shared across
        lengths.  This is the ONE home of the ``("generate", B, sb,
        max_new)`` key convention: the disaggregated phase dispatches must
        price against exactly the entries the unified path replays.
        """
        sb = shape_bucket(max(len(r.prompt) for r in batch))
        prompts = pad_prompts([r.prompt for r in batch], width=sb)
        max_new = max(r.max_new_tokens for r in batch)
        key = ("generate", prompts.shape[0], sb, max_new)

        def thunk():
            res = self.engine.generate(prompts, max_new)
            return (res.prefill_s, res.decode_s), res

        (prefill_s, decode_s), res = self.timed(key, thunk)
        return prefill_s, decode_s, res, max_new

    def cap_frac(self, t: float) -> float:
        """The brownout power-cap fraction governing a dispatch that starts
        at ``t`` (1.0 = uncapped; overlapping windows clamp hardest)."""
        frac = 1.0
        for t0, t1, f in self.power_caps:
            if t0 <= t < t1:
                frac = min(frac, f)
        return frac

    def execute_generate(self, batch: List[Request], start_s: float,
                         _depth: int = 0) -> None:
        """Dispatch ``batch`` as one uniform engine call at ``start_s``.

        Records a Response per request with its own retirement time (the step
        where its n-th token lands) and bills batch energy segment-wise so
        early-retiring requests do not pay for the longest request's tail.

        Under a preemptive admission ladder, a strictly-more-urgent pending
        arrival landing inside this dispatch's decode window *pauses* it:
        the core bills a pause overhead (``preempt`` bucket), runs the
        urgent request as its own dispatch on the same clock, bills a resume
        overhead, and every token of this batch landing after the pause
        point is pushed late by exactly the interruption.  The prefill is
        atomic (it is the unit preemption protects), and joule/gram
        conservation holds across pauses because the batch's compute is
        billed segment-wise at each segment's own wall instant.
        """
        self.advance_to(start_s)
        prefill_s, decode_s, res, max_new = self._timed_generate(batch)
        frac = self.cap_frac(start_s)
        cap_w = None
        if frac < 1.0:
            # brownout: steps stretch by 1/frac, billed at the clamped
            # power — the energy per step is conserved to first order
            prefill_s /= frac
            decode_s /= frac
            cap_w = self.meter.active_power_w * frac
        total = prefill_s + decode_s
        intr = self._run_preemptions(batch, start_s, prefill_s, total, _depth)

        def to_wall(c: float) -> float:
            """Wall instant the compute offset ``c`` of this batch lands
            (tokens landing exactly at a pause point land before it)."""
            w = start_s + c
            for ci, di in intr:
                if c > ci + 1e-12:
                    w += di
            return w

        first_s = to_wall(prefill_s)
        # vectorized token-landing math: same IEEE double expression as
        # token_landing_s evaluated elementwise (bit-identical offsets)
        step = decode_s / max(max_new - 1, 1)
        n_arr = np.fromiter((min(r.max_new_tokens, max_new) for r in batch),
                            np.int64, count=len(batch))
        land_c = prefill_s + np.maximum(n_arr - 1, 0) * step
        done_w = None if intr else start_s + land_c
        done_c = {}                      # rid -> landing compute offset
        done_by_rid = {}
        n_tokens = 0
        vocab = self.vocab
        for bi, req in enumerate(batch):
            n = int(n_arr[bi])
            if res is not None:
                toks = np.asarray(res.tokens[bi, :n])
            else:
                toks = synth_tokens(req.prompt, n, vocab)
            c = float(land_c[bi])
            done_c[req.rid] = c
            done = to_wall(c) if intr else float(done_w[bi])
            done_by_rid[req.rid] = done
            # the pause time that pushed THIS request late (zero when the
            # dispatch ran uninterrupted): done == start + c + its gaps
            self.record_response(req, toks, start_s, first_s, done,
                                 preempted_s=(done - start_s - c) if intr
                                 else 0.0)
            n_tokens += n
        if intr:
            self._bill_preempted(start_s, done_c, intr, n_tokens,
                                 power_w=cap_w)
        else:
            self.meter.record_active_shared(start_s, done_by_rid,
                                            tokens=n_tokens, power_w=cap_w)
        self.wall += prefill_s + decode_s
        self.clock = start_s + total + sum(d for _, d in intr)

    def _run_preemptions(self, batch: List[Request], start_s: float,
                         prefill_s: float, total: float,
                         depth: int) -> List[Tuple[float, float]]:
        """Serve every pending strictly-more-urgent arrival landing inside
        this dispatch; returns the inserted interruptions as
        ``[(compute_offset_s, duration_s), ...]`` in pause order."""
        adm = self.admission
        if adm is None or not adm.preempt or depth >= 2 \
                or total - prefill_s <= 1e-12:
            return []
        level = min(priority_level(r.priority) for r in batch)
        if level <= 0:
            return []                  # interactive work is never preempted
        intr: List[Tuple[float, float]] = []
        resume_w = start_s             # wall instant compute (re)starts
        consumed = 0.0                 # compute consumed at resume_w
        while len(intr) < adm.max_preemptions:
            end_w = start_s + total + sum(d for _, d in intr)
            pre = self._pop_preemptor(level, end_w)
            if pre is None:
                break
            # pause once the preemptor has arrived — but never inside the
            # prefill and never before the previous resume point
            if pre.arrival_s <= resume_w:
                pause_c = consumed
            else:
                pause_c = consumed + (pre.arrival_s - resume_w)
            pause_c = min(max(pause_c, prefill_s), total)
            pause_w = resume_w + max(pause_c - consumed, 0.0)
            if self.tracer is not None:
                self.tracer.instant("preempt_pause", pause_w,
                                    {"preemptor": pre.rid,
                                     "paused": [r.rid for r in batch]})
            self.meter.record_preempt(adm.pause_s, t_s=pause_w)
            sub_start = pause_w + adm.pause_s
            # one pause absorbs the whole urgent backlog: every other
            # more-urgent request already waiting at the pause instant
            # rides the preempting dispatch (up to the policy's batch
            # budget), so a flash crowd costs one interruption, not one
            # per arrival
            cap = getattr(self.policy, "max_batch", None) \
                or getattr(self.policy, "num_slots", None) or 1
            urgent = [pre]
            while len(urgent) < cap:
                extra_pre = self._pop_preemptor(level, sub_start)
                if extra_pre is None:
                    break
                urgent.append(extra_pre)
            # the machine is busy through the pause: move the clock without
            # billing the gap idle (the batch's own segments cover the rest)
            self.clock = max(self.clock, sub_start)
            self.execute_generate(urgent, sub_start, _depth=depth + 1)
            sub_end = self.clock
            self.meter.record_preempt(adm.resume_s, t_s=sub_end)
            dur = (sub_end + adm.resume_s) - pause_w
            intr.append((pause_c, dur))
            resume_w = pause_w + dur
            consumed = pause_c
            if self.tracer is not None:
                self.tracer.instant("preempt_resume", resume_w,
                                    {"preemptor": pre.rid})
        return intr

    def _bill_preempted(self, start_s: float, done_c: Dict[int, float],
                        intr: List[Tuple[float, float]],
                        tokens: int,
                        power_w: Optional[float] = None) -> None:
        """Segment-wise active billing for a preempted dispatch: the batch's
        compute is cut at every retirement and pause offset; each segment is
        billed at its own (shifted) wall instant and split across the
        requests still resident — the preemption-aware sibling of
        :meth:`EnergyMeter.record_active_shared`."""
        total = max(done_c.values())
        cuts = sorted(set(list(done_c.values())
                          + [c for c, _ in intr] + [total]))

        def gaps_before(c: float) -> float:
            return sum(d for ci, d in intr if ci <= c + 1e-12)

        t = 0.0
        first = True
        for c in cuts:
            seg = c - t
            if seg <= 1e-15:
                t = c
                continue
            resident = [rid for rid, dc in done_c.items() if dc > t + 1e-12]
            self.meter.record_active(seg, rids=resident,
                                     tokens=tokens if first else 0,
                                     t_s=start_s + t + gaps_before(t),
                                     power_w=power_w)
            first = False
            t = c
        for rid in done_c:               # zero-compute requests: J = g = 0
            self.meter.per_request_j.setdefault(rid, 0.0)
            self.meter.per_request_g.setdefault(rid, 0.0)

    # -- disaggregated phase dispatches (prefill/decode pools) ----------------------
    def execute_prefill(self, batch: List[Request], start_s: float) -> None:
        """Prefill-pool dispatch: run only the prompt pass of ``batch``.

        Produces each request's token 1 — the TTFT token — and retires the
        prefill leg at the prefill's end; the decode pool (fed by the
        fleet's KV handoff) owns tokens 2..n.  Billed as ``prefill_s`` of
        active compute shared uniformly by the batch.
        """
        self.advance_to(start_s)
        prefill_s, _decode_s, res, _max_new = self._timed_generate(batch)
        frac = self.cap_frac(start_s)
        cap_w = None
        if frac < 1.0:
            prefill_s /= frac
            cap_w = self.meter.active_power_w * frac
        end = start_s + prefill_s
        rids = [r.rid for r in batch]
        for bi, req in enumerate(batch):
            if res is not None:
                tok0 = np.asarray(res.tokens[bi, :1])
            else:
                tok0 = synth_tokens(req.prompt, 1, self.vocab)
            self.record_response(req, tok0, start_s, end, end)
        self.meter.record_active(prefill_s, rids=rids, tokens=len(batch),
                                 t_s=start_s, power_w=cap_w)
        self.wall += prefill_s
        self.clock = end

    def execute_decode(self, batch: List[Request], start_s: float) -> None:
        """Decode-pool dispatch: tokens 2..n of each request in ``batch``.

        The decode duration comes from the same measured ``generate`` entry
        the unified path replays, so a disaggregated run spends exactly the
        compute a unified run would — what changes is where each phase runs
        and what the KV handoff adds on top.
        """
        self.advance_to(start_s)
        _prefill_s, decode_s, res, max_new = self._timed_generate(batch)
        frac = self.cap_frac(start_s)
        cap_w = None
        if frac < 1.0:
            decode_s /= frac
            cap_w = self.meter.active_power_w * frac
        step = decode_s / max(max_new - 1, 1)
        n_arr = np.fromiter((min(r.max_new_tokens, max_new) for r in batch),
                            np.int64, count=len(batch))
        done_arr = start_s + np.maximum(n_arr - 1, 0) * step
        done_by_rid = {}
        n_tokens = 0
        vocab = self.vocab
        for bi, req in enumerate(batch):
            n = int(n_arr[bi])
            if res is not None:
                toks = np.asarray(res.tokens[bi, 1:n])
            else:
                toks = synth_tokens(req.prompt, n, vocab)[1:]
            done = float(done_arr[bi])
            done_by_rid[req.rid] = done
            # first_token_s is the prefill leg's business; the fleet stitches
            self.record_response(req, toks, start_s, start_s, done)
            n_tokens += len(toks)
        self.meter.record_active_shared(start_s, done_by_rid, tokens=n_tokens,
                                        power_w=cap_w)
        end = max(done_by_rid.values(), default=start_s)
        self.wall += end - start_s
        self.clock = end

    def record_response(self, req: Request, tokens, start_s: float,
                        first_s: float, done_s: float,
                        preempted_s: float = 0.0) -> None:
        resp = Response(rid=req.rid, tokens=np.asarray(tokens, np.int32),
                        arrival_s=req.arrival_s, start_s=start_s,
                        first_token_s=first_s, done_s=done_s,
                        deadline_s=req.deadline_s, priority=req.priority)
        self.responses.append(resp)
        self.total_tokens += len(tokens)
        if self.tracer is not None:
            self.tracer.on_response(resp, preempted_s)

    # -- the event loop -------------------------------------------------------
    def begin(self) -> None:
        """Start an incremental run (arrivals fed later via :meth:`offer`)."""
        self._reset([])
        self.policy.reset(self)

    def offer(self, req: Request) -> None:
        """Enqueue one arrival.  Routers offer in global arrival order, so
        this is an O(1) append; out-of-order offers fall back to insort."""
        self.pending.push(req)

    def drain_until(self, horizon: float = float("inf")) -> None:
        """Process events whose arrivals lie at or before ``horizon``.

        No step *begins* at or past the horizon: once the clock reaches it,
        the core pauses — policy slot/batch state persists across calls —
        and resumes next window after the router has offered that window's
        arrivals.  Since admission is gated on ``arrival_s <= now`` and
        every step starts with ``now < horizon`` (a frontier the router has
        fully routed), an incremental run admits exactly what a batch-mode
        run would: a 1-replica fleet reproduces ``run()``'s timeline
        (tested).  A single dispatch may still legitimately *end* past the
        horizon; the crossing step simply becomes the window's last.
        """
        while self.clock < horizon:
            nxt = self.peek()
            ready = nxt is not None and nxt.arrival_s <= horizon
            if not ready and not self.policy.active(self):
                break
            self.policy.step(self)

    def finish(self) -> ServingMetrics:
        return ServingMetrics(self.responses, self.wall, self.meter.total_j,
                              self.total_tokens, meter=self.meter)

    def run(self, workload: List[Request]) -> ServingMetrics:
        self._reset(workload)
        self.policy.reset(self)
        self.drain_until()
        return self.finish()
