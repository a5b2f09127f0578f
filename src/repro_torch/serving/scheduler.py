"""TD3 request-processing policies over the event-driven SchedulerCore.

The paper (via its primary studies Yao'21 / Yarally'23 / Kumara'22) treats
real-time vs batching as *the* transversal decision for serving energy.  All
policies here are thin admission/dispatch plug-ins over ONE
:class:`repro_torch.serving.core.SchedulerCore`, which owns the virtual clock, the
arrival queue, retirement events, the measured-step-time replay cache and the
:class:`~repro_torch.energy.meter.EnergyMeter` (active vs idle draw, J/request,
J/token).  No policy contains a clock loop or an inline energy formula.

Policies:

  * ``realtime``         — dispatch each arrival alone (batch=1);
  * ``dynamic_batch``    — accumulate up to (max_batch, timeout), dispatch
    as one uniform batch;
  * ``adaptive_batch``   — beyond-paper: per admission window, pick the batch
    size the step-time cache predicts will keep p95 TTFT under the SLO at
    minimum J/token;
  * ``continuous_batch`` — beyond-paper (vLLM-style): slot-reuse decode with
    per-request admission and retirement.

The legacy ``*Scheduler`` classes remain as constructors-compatible shells:
``RealTimeScheduler(engine).run(wl)`` builds a core + policy underneath.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.engines import Engine
from repro_torch.energy.meter import estimate_j_per_token
from repro_torch.serving.core import SchedulerCore, SchedulingPolicy, pad_prompts
from repro_torch.serving.request import Request, ServingMetrics
from repro_torch.serving.stepcache import StepTimeCache, shape_bucket, synth_tokens

# backwards-compatible alias (pre-core name)
_pad_prompts = pad_prompts


class RealTimePolicy(SchedulingPolicy):
    """Process each request immediately and alone (batch=1)."""

    name = "realtime"

    def step(self, core: SchedulerCore) -> None:
        req = core.pop_next()          # priority-ordered under backlog
        core.execute_generate([req], max(core.now, req.arrival_s))


class DynamicBatchPolicy(SchedulingPolicy):
    """Accumulate requests up to (max_batch, timeout) and run them together.

    Admission is priority-aware when the core carries an admission ladder:
    the window head and its fill are popped most-urgent-first among the
    arrivals visible inside the window (FIFO within a class, and plain FIFO
    with no ladder).  Dispatches go through :meth:`_dispatch`, which the
    disaggregated phase policies override to run only their phase.
    """

    name = "dynamic_batch"

    def __init__(self, max_batch: int = 8, timeout_ms: float = 20.0):
        self.max_batch = max_batch
        self.timeout_s = timeout_ms / 1e3
        # an admission window stays open for timeout_s past its head arrival
        self.admission_lookahead_s = self.timeout_s

    def _dispatch(self, core: SchedulerCore, batch: List[Request],
                  start_s: float) -> None:
        core.execute_generate(batch, start_s)

    def _admit(self, core: SchedulerCore, max_batch: int) -> List[Request]:
        head = core.pop_next()
        open_t = max(core.now, head.arrival_s)
        close_t = open_t + self.timeout_s
        batch = [head]
        while (
            core.peek() is not None
            and len(batch) < max_batch
            and core.peek().arrival_s <= close_t
        ):
            batch.append(core.pop_next(close_t))
        # priority pops can reorder the fill, so the dispatch floor is the
        # latest arrival in the batch, not the last-popped one
        start = max(open_t if len(batch) == max_batch else close_t,
                    max(r.arrival_s for r in batch))
        self._dispatch(core, batch, start)
        return batch

    def step(self, core: SchedulerCore) -> None:
        self._admit(core, self.max_batch)


class AdaptiveBatchPolicy(DynamicBatchPolicy):
    """SLO/energy-aware batch sizing from the measured step-time cache.

    For each admission window the policy estimates, per candidate batch size
    ``b``: p95 TTFT ~ (b-1)/arrival_rate + prefill(b) (the head request waits
    for the window to fill, then for prefill) and J/token ~
    active_power * (prefill(b)+decode(b)) / (b * max_new).  It dispatches the
    candidate meeting the TTFT target at minimum predicted J/token; with an
    empty cache (no measurements yet) it behaves like dynamic batching at
    ``max_batch``, which also populates the cache for later windows.

    The TTFT target for a window is the *tightest* budget in sight: the
    policy-level ``ttft_slo_ms`` default, tightened by any per-request
    ``Request.slo_ms`` among the head and the arrivals visible inside the
    admission window — one latency-critical request shrinks the batch it
    rides in rather than being sacrificed to the global target.
    """

    name = "adaptive_batch"

    def __init__(self, max_batch: int = 8, ttft_slo_ms: float = 200.0,
                 rate_window: int = 16):
        super().__init__(max_batch=max_batch, timeout_ms=ttft_slo_ms / 2)
        self.ttft_slo_s = ttft_slo_ms / 1e3
        self._recent = deque(maxlen=rate_window)
        self.chosen: List[int] = []        # per-window decisions (observable)

    def reset(self, core: SchedulerCore) -> None:
        self._recent.clear()
        self.chosen = []

    def _rate(self) -> Optional[float]:
        if len(self._recent) < 2:
            return None
        span = self._recent[-1] - self._recent[0]
        if span <= 0:
            return None
        return (len(self._recent) - 1) / span

    def _window_slo_s(self, core: SchedulerCore, head: Request) -> float:
        """Tightest TTFT budget among the head and window-visible arrivals."""
        slo = self.ttft_slo_s
        open_t = max(core.now, head.arrival_s)
        for req in [head] + core.pending_within(open_t + self.timeout_s):
            if req.slo_ms is not None:
                slo = min(slo, req.slo_ms / 1e3)
        return slo

    def _choose(self, core: SchedulerCore, head: Request) -> int:
        cache = core.step_cache
        if cache is None:
            return self.max_batch
        sb = shape_bucket(len(head.prompt))
        rate = self._rate()
        slo_s = self._window_slo_s(core, head)
        best = None              # (infeasible, cost, b)
        b = 1
        cands = []
        while b < self.max_batch:
            cands.append(b)
            b *= 2
        cands.append(self.max_batch)
        for b in cands:
            est = cache.estimate_generate(b, sb, head.max_new_tokens)
            if est is None:
                continue
            prefill_s, decode_s = est
            wait = (b - 1) / rate if rate else 0.0
            ttft = wait + prefill_s
            j_tok = estimate_j_per_token(core.active_power_w, prefill_s,
                                         decode_s, b, head.max_new_tokens)
            feasible = ttft <= slo_s
            rank = (0, j_tok, -b) if feasible else (1, ttft, -b)
            if best is None or rank < best[0]:
                best = (rank, b)
        if best is None:
            return self.max_batch
        return best[1]

    def step(self, core: SchedulerCore) -> None:
        head = core.peek_next()        # the request _admit will pop first
        b = self._choose(core, head)
        self.chosen.append(b)
        # feed EVERY admitted arrival into the rate estimate (one sample per
        # window would underestimate the rate by ~the batch size)
        for req in self._admit(core, b):
            self._recent.append(req.arrival_s)


class ContinuousBatchPolicy(SchedulingPolicy):
    """Beyond-paper: slot-based continuous batching (decode-level admission).

    A fixed pool of ``num_slots`` cache slots; every event admits arrivals
    into free slots (per-request prefill) and then advances ALL active slots
    by one fused decode step.  Requests retire individually, so short
    requests never wait for long ones — the design that DL-serving software
    (SI3) and modern LLM servers use to lift both throughput and energy
    efficiency.  Prefill/decode durations route through the core's step-time
    cache, so a calibrated cache simulates this policy without touching the
    model (replayed steps synthesize token ids deterministically).
    """

    name = "continuous_batch"

    def __init__(self, num_slots: int = 8, max_seq: int = 256):
        self.num_slots = num_slots
        self.max_seq = max_seq

    def reset(self, core: SchedulerCore) -> None:
        B = self.num_slots
        # the engine's own slot cache: under SI2 on the card, the buffers
        # its captured decode step reads and writes
        self.kv = core.engine.decode_cache(B, self.max_seq)
        self.cur_tok = torch.zeros((B,), dtype=torch.int32,
                                   device=core.engine.device)
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_emitted = [0] * B
        self.slot_tokens: List[List[int]] = [[] for _ in range(B)]
        self.slot_start = [0.0] * B
        self.slot_ttft = [0.0] * B
        # slots admitted via a replayed prefill have no real kv/cur_tok state:
        # their tokens must stay synthetic even when a decode step executes
        self.slot_synth = [False] * B

    def active(self, core: SchedulerCore) -> bool:
        return any(r is not None for r in self.slot_req)

    def _insert(self, cache, sub, slot: int):
        """Copy the one-slot cache ``sub`` into slot ``slot`` of ``cache``,
        in place, and return ``cache`` itself (SI2 decodes only the dict
        its graph owns)."""
        for key, leaf in cache.items():
            if leaf.ndim == 1:  # lengths (B,)
                leaf[slot] = sub[key][0]
            else:               # (L, B, ...): k, v or wkv, tm_shift, cm_shift
                leaf[:, slot] = sub[key][:, 0]
        return cache

    def _admit(self, core: SchedulerCore) -> None:
        for s in range(self.num_slots):
            if self.slot_req[s] is not None:
                continue
            nxt = core.peek()
            if nxt is None or nxt.arrival_s > core.now:
                return
            req = core.pop_next(core.now)   # most urgent arrived request
            # bucket prompt length to a power of two so the compiled prefill
            # executable (and its measured duration) is reused across requests
            S = len(req.prompt)
            bucket = shape_bucket(S)
            prompt = np.zeros((bucket,), np.int32)
            prompt[:S] = req.prompt

            def thunk():
                # sanctioned measurement closure: a step-cache MISS really
                # executes the engine, and the measured duration is what the
                # virtual clock replays from then on
                core.engine._sync()
                t0 = time.perf_counter()          # simlint: allow(wall-clock)
                logits, sub = core.engine.prefill_one(prompt[None, :])
                tok = torch.argmax(logits, -1).to(torch.int32)
                core.engine._sync()
                dt = time.perf_counter() - t0     # simlint: allow(wall-clock)
                return (dt,), (tok, sub)

            (dt,), out = core.timed(("prefill1", bucket), thunk)
            start = core.now
            core.advance_active(dt, rids=[req.rid], tokens=1)
            self.slot_synth[s] = out is None
            if out is not None:
                tok, sub = out
                self.kv = self._insert(self.kv, sub, s)
                self.cur_tok[s] = tok[0]
                first = int(tok[0])
            else:
                first = int(synth_tokens(req.prompt, 1, core.vocab)[0])
            self.slot_req[s] = req
            self.slot_emitted[s] = 1
            self.slot_tokens[s] = [first]
            self.slot_start[s] = start
            self.slot_ttft[s] = core.now

    def step(self, core: SchedulerCore) -> None:
        self._admit(core)
        if not self.active(core):
            nxt = core.peek()
            if nxt is not None:
                core.advance_to(nxt.arrival_s)   # idle until next arrival
            return

        def thunk():
            # sanctioned measurement closure (see the prefill thunk above)
            core.engine._sync()
            t0 = time.perf_counter()              # simlint: allow(wall-clock)
            logits, kv = core.engine.decode_batch(self.kv, self.cur_tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
            core.engine._sync()
            dt = time.perf_counter() - t0         # simlint: allow(wall-clock)
            return (dt,), (tok, kv)

        (dt,), out = core.timed(("decode", self.num_slots), thunk)
        rids = [r.rid for r in self.slot_req if r is not None]
        core.advance_active(dt, rids=rids, tokens=len(rids))
        if out is not None:
            tok, self.kv = out
            self.cur_tok = tok
            host_tok = tok.cpu().numpy()          # one device->host read a step
        for s in range(self.num_slots):
            req = self.slot_req[s]
            if req is None:
                continue
            if out is not None and not self.slot_synth[s]:
                nxt_tok = int(host_tok[s])
            else:
                nxt_tok = int(
                    synth_tokens(req.prompt, self.slot_emitted[s] + 1,
                                 core.vocab)[-1]
                )
            self.slot_emitted[s] += 1
            self.slot_tokens[s].append(nxt_tok)
            if self.slot_emitted[s] >= req.max_new_tokens:
                core.record_response(
                    req, self.slot_tokens[s][: req.max_new_tokens],
                    self.slot_start[s], self.slot_ttft[s], core.now,
                )
                self.slot_req[s] = None


# -- disaggregated phase policies (prefill/decode pools) ---------------------------


class PrefillPhasePolicy(DynamicBatchPolicy):
    """Prefill-pool batching: same (max_batch, timeout) windowing as dynamic
    batching, but the dispatch runs only the prompt pass — the decode pool
    owns the rest of each request after the KV handoff."""

    name = "prefill_phase"

    def _dispatch(self, core: SchedulerCore, batch: List[Request],
                  start_s: float) -> None:
        core.execute_prefill(batch, start_s)


class DecodePhasePolicy(DynamicBatchPolicy):
    """Decode-pool batching: windows over handed-off requests, dispatching
    only the decode steps (tokens 2..n)."""

    name = "decode_phase"

    def _dispatch(self, core: SchedulerCore, batch: List[Request],
                  start_s: float) -> None:
        core.execute_decode(batch, start_s)


# -- legacy scheduler shells (constructor-compatible) --------------------------


class _PolicyScheduler:
    """Engine + policy bound into a runnable core (the pre-core interface)."""

    def __init__(self, engine: Engine, policy: SchedulingPolicy,
                 step_cache: Optional[StepTimeCache] = None):
        self.engine = engine
        self.policy = policy
        self.core = SchedulerCore(engine, policy, step_cache=step_cache)
        self.name = policy.name

    def run(self, workload: List[Request]) -> ServingMetrics:
        return self.core.run(workload)


class RealTimeScheduler(_PolicyScheduler):
    name = "realtime"

    def __init__(self, engine: Engine, step_cache=None):
        super().__init__(engine, RealTimePolicy(), step_cache)


class DynamicBatchScheduler(_PolicyScheduler):
    name = "dynamic_batch"

    def __init__(self, engine: Engine, max_batch: int = 8,
                 timeout_ms: float = 20.0, step_cache=None):
        super().__init__(engine, DynamicBatchPolicy(max_batch, timeout_ms),
                         step_cache)


class AdaptiveBatchScheduler(_PolicyScheduler):
    name = "adaptive_batch"

    def __init__(self, engine: Engine, max_batch: int = 8,
                 ttft_slo_ms: float = 200.0, step_cache=None):
        super().__init__(engine, AdaptiveBatchPolicy(max_batch, ttft_slo_ms),
                         step_cache)


class ContinuousBatchScheduler(_PolicyScheduler):
    name = "continuous_batch"

    def __init__(self, engine: Engine, num_slots: int = 8, max_seq: int = 256,
                 step_cache=None):
        super().__init__(engine, ContinuousBatchPolicy(num_slots, max_seq),
                         step_cache)


# the TD3 vocabulary (spec validation checks membership before make_policy)
POLICIES = ("realtime", "dynamic_batch", "adaptive_batch", "continuous_batch")


def make_policy(kind: str, *, max_batch=8, timeout_ms=20.0, max_seq=256,
                ttft_slo_ms=200.0) -> SchedulingPolicy:
    """Fresh policy instance for ``kind`` — policies are stateful, so every
    replica in a fleet gets its own (the fleet calls this per replica)."""
    if kind == "realtime":
        return RealTimePolicy()
    if kind == "dynamic_batch":
        return DynamicBatchPolicy(max_batch, timeout_ms)
    if kind == "adaptive_batch":
        return AdaptiveBatchPolicy(max_batch, ttft_slo_ms)
    if kind == "continuous_batch":
        return ContinuousBatchPolicy(max_batch, max_seq)
    raise ValueError(kind)


def make_scheduler(kind: str, engine: Engine, *, max_batch=8, timeout_ms=20.0,
                   max_seq=256, ttft_slo_ms=200.0, step_cache=None):
    policy = make_policy(kind, max_batch=max_batch, timeout_ms=timeout_ms,
                         max_seq=max_seq, ttft_slo_ms=ttft_slo_ms)
    return _PolicyScheduler(engine, policy, step_cache)
