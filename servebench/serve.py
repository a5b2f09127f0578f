"""One cell of the benchmark, run once: set-up, the measured window, and the
records the metric readers take.

Set-up, in order: the weights, made on the device from the seed (one
``torch.randn`` call a leaf, in the dtype they are served in); the engine
(``CompiledEngine``, SI2) over them, or over their ``rsm_int8`` form made in
memory with the program's ``formats.quantize_params``; a ``ServingSession``
deployed with that engine and one continuous-batching endpoint whose step
cache is off; and the objects ``ServingSession.run`` builds for a one-replica
endpoint, a ``SchedulerCore`` over ``make_policy("continuous_batch", ...)``.
A warm-up drives that core through one request of every prompt length
bucket the mix can send, which captures the pool's decode graph and the
B = 1 graph and runs the prefill of every shape the window will use.

The window drives the same core with ``begin`` / ``offer`` / ``drain_until``
in slices of ``SLICE_S`` of the serving timeline, until the wall clock has
passed the run's seconds.  Every engine call is executed (the step cache is
off), so the timeline is built from measured durations.  The harness records
around the calls into each layer, from its own files: the engine's two
calls are wrapped on the instance (a flag set, nothing timed), and the
core's ``advance_active``, called just after each timed call, records the
step: its measured seconds, its tokens, and, for a decode step, every
slot's cache length before it (a free slot keeps stepping).  A traced run
also opens host spans around the scheduler's step, the two engine calls and
the slot insert, which name the device's idle gaps.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np

from servebench import kinds, traffic
from servebench.reference.padding import pad_length

SLICE_S = 0.1          # serving-timeline seconds between two looks at the wall clock
ENDPOINT = "cell"


@dataclasses.dataclass
class Segment:
    """The records of one stretch of the window."""

    wall_s: float = 0.0
    energy_j: float = 0.0
    virt0: float = 0.0
    virt1: float = 0.0
    steps: List[dict] = dataclasses.field(default_factory=list)
    arrivals: Dict[int, float] = dataclasses.field(default_factory=dict)
    first: Dict[int, float] = dataclasses.field(default_factory=dict)
    done: list = dataclasses.field(default_factory=list)

    @property
    def tokens(self) -> int:
        return sum(s["tokens"] for s in self.steps)


def program_config(model: dict):
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in model.items() if k in names})


def make_weights(cfg, seed: int, device) -> dict:
    """The weight tree the program takes, every leaf drawn in one call from a
    generator on ``device`` seeded with ``seed``, in its served dtype."""
    import torch
    from repro_torch.models import transformer

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        dtype = spec.dtype or cfg.torch_dtype
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "full":
            return torch.full(spec.shape, spec.scale, dtype=dtype, device=device)
        w = torch.randn(spec.shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(spec.scale)

    return make(transformer.param_specs(cfg))


class Cell:
    """One configuration under one traffic mix, set up on ``device``;
    ``counts`` is the work-count module of the configuration's kind, found
    under ``root`` (``servebench/kinds.py``)."""

    def __init__(self, config: dict, mix: dict, seed: int, device, trace: bool = False,
                 root: str = kinds.ROOT):
        self.config, self.mix, self.seed, self.trace = config, mix, seed, trace
        self.counts = kinds.counts(config, root)
        self.model = config["model"]
        self.fmt = config["format"]
        self.slots, self.max_seq = mix["slots"], mix["max_seq"]
        self.device = device
        self.cfg = program_config(self.model)
        self.prompts: Dict[int, np.ndarray] = {}
        self.steps: Optional[List[dict]] = None
        self.first: Dict[int, float] = {}
        self._kind = None

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.engines import CompiledEngine
        from repro_torch.serving import formats
        from repro_torch.serving.api import (AutoscaleSpec, EndpointSpec, ServingSession,
                                             ServingSpec)
        from repro_torch.serving.core import SchedulerCore
        from repro_torch.serving.scheduler import make_policy

        self.weights = make_weights(self.cfg, self.seed, self.device)
        served = (formats.quantize_params(self.weights) if self.fmt == "rsm_int8"
                  else self.weights)
        engine = CompiledEngine(self.cfg, served, self.max_seq, self.device)
        ep = EndpointSpec(name=ENDPOINT, arch=self.config["arch"], format=self.fmt,
                          si="si2_runtime", policy="continuous_batch", step_cache=False,
                          max_batch=self.slots, max_seq=self.max_seq,
                          autoscale=AutoscaleSpec(enabled=False, max_replicas=1))
        self.session = ServingSession(device=self.device).deploy(
            ServingSpec(endpoints=(ep,)), engines={ENDPOINT: engine})
        self.engine = self.session.engine(ENDPOINT)
        self.core = SchedulerCore(self.engine, make_policy(
            ep.policy, max_batch=ep.max_batch, timeout_ms=ep.batch_timeout_ms,
            max_seq=ep.max_seq), step_cache=None)
        self.policy = self.core.policy
        self._install()
        self._warm_up()

    def _install(self) -> None:
        """Record around the engine's calls and the core's step accounting."""
        engine, core, policy = self.engine, self.core, self.policy
        prefill, decode = engine.prefill_one, engine.decode_batch
        advance = core.advance_active

        def prefill_one(tokens):
            self._kind = ("prefill", tokens.shape[1])
            return prefill(tokens)

        def decode_batch(cache, tokens):
            self._kind = ("decode", 0)
            return decode(cache, tokens)

        def advance_active(dt, rids=(), tokens=0):
            advance(dt, rids, tokens)
            if self.steps is not None:
                self._record(dt, rids, tokens)

        if self.trace:
            from torch.profiler import record_function

            def spanned(fn, name):
                def call(*args):
                    with record_function(name):
                        return fn(*args)
                return call

            prefill_one = spanned(prefill_one, "prefill_one")
            decode_batch = spanned(decode_batch, "decode_batch")
            policy.step = spanned(policy.step, "scheduler")
            policy._insert = spanned(policy._insert, "insert")
        engine.prefill_one = prefill_one
        engine.decode_batch = decode_batch
        core.advance_active = advance_active

    def _record(self, dt: float, rids, tokens: int) -> None:
        kind, bucket = self._kind
        self._kind = None
        if kind == "prefill":
            rid = rids[0]
            self.first[rid] = self.core.clock
            self.steps.append({"kind": "prefill", "dt": dt, "tokens": tokens,
                               "bucket": bucket, "prompt": len(self.prompts[rid])})
            return
        lens, ctx = [], []
        for s, req in enumerate(self.policy.slot_req):
            if req is None:
                n = self._slot_len[s]
            else:
                e = self.policy.slot_emitted[s]
                n = pad_length(len(req.prompt)) + e - 1
                ctx.append(len(req.prompt) + e)
            lens.append(n)
            self._slot_len[s] = n + 1
        self.steps.append({"kind": "decode", "dt": dt, "tokens": tokens,
                           "lens": lens, "live_ctx": ctx})

    def _request(self, spec: "traffic.Spec", arrival_s: float):
        from repro_torch.serving.request import Request

        self.prompts[spec.rid] = spec.prompt
        return Request(rid=spec.rid, prompt=spec.prompt,
                       max_new_tokens=spec.max_new_tokens, arrival_s=arrival_s)

    def _buckets(self) -> List[int]:
        lo, hi = self.mix["prompt"]
        b, out = pad_length(lo), []
        while b <= pad_length(hi):
            out.append(b)
            b *= 2
        return out

    def _warm_up(self) -> None:
        """One request of every prompt bucket the mix sends, three tokens
        each, through the window's own core: every shape the window uses is
        captured or run once."""
        rng = np.random.default_rng(self.seed)
        self.core.begin()
        self._slot_len = [0] * self.slots
        for i, b in enumerate(self._buckets()):
            ids = rng.integers(1, self.cfg.vocab_size, size=b, dtype=np.int64)
            self.core.offer(self._request(
                traffic.Spec(-1 - i, ids.astype(np.int32), 3, 0.0), 0.0))
        self.core.drain_until()
        self.graphs_after_warm_up = len(self.engine.slot_graphs)

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, energy, sync, tracer=None,
               traced_s: float = 0.0, min_done: int = 0) -> List[Segment]:
        """Serve the mix for ``seconds`` of wall clock after its warm-in; a
        traced run profiles the last ``traced_s`` of it as a segment of its
        own.  ``min_done`` (tests on the CPU) extends the window until that
        many requests have finished in it.  Returns the segments."""
        core = self.core
        gen = traffic.requests(self.mix, self.seed, self.cfg.vocab_size)
        backlog = self.mix["loop"] == "backlog"
        nxt = next(gen)
        core.begin()
        self._slot_len = [0] * self.slots
        self.steps, self.first = [], {}
        arrivals: Dict[int, float] = {}
        horizon = 0.0

        def offer_until(h: float) -> None:
            nonlocal nxt
            if backlog:
                while len(core.pending) < 2 * self.slots:
                    arrivals[nxt.rid] = core.clock
                    core.offer(self._request(nxt, core.clock))
                    nxt = next(gen)
                return
            while nxt.arrival_s <= h:
                arrivals[nxt.rid] = nxt.arrival_s
                core.offer(self._request(nxt, nxt.arrival_s))
                nxt = next(gen)

        def slice_() -> None:
            nonlocal horizon
            horizon = max(horizon, core.clock) + SLICE_S
            offer_until(horizon)
            core.drain_until(horizon)

        # warm-in: the open loop's first seconds; the backlog's first fill
        # (its first step admits into every slot, then decodes them all)
        if backlog:
            while not any(s["kind"] == "decode" for s in self.steps):
                slice_()
        else:
            while core.clock < self.mix["warm_in_s"]:
                slice_()
        self.core_responses0 = len(core.responses)
        self.graphs_in_window = len(self.engine.slot_graphs)

        segments = []
        spans = [seconds - traced_s, traced_s] if traced_s > 0 else [seconds]
        self.window_open = time.perf_counter()
        for i, length in enumerate(spans):
            seg = Segment(virt0=core.clock)
            n_steps, n_done = len(self.steps), len(core.responses)
            if i == 1:
                tracer.start()
            sync()
            energy.start()
            t0 = time.perf_counter()
            while True:
                slice_()
                if (time.perf_counter() - t0 >= length
                        and len(core.responses) - self.core_responses0 >= min_done):
                    break
            sync()
            seg.energy_j = energy.read()
            seg.wall_s = time.perf_counter() - t0
            if i == 1:
                tracer.stop()
            seg.virt1 = core.clock
            seg.steps = self.steps[n_steps:]
            seg.done = core.responses[n_done:]
            seg.arrivals = {r: a for r, a in arrivals.items() if seg.virt0 <= a <= seg.virt1}
            seg.first = {r: t for r, t in self.first.items() if r in seg.arrivals}
            segments.append(seg)
        self.finished = core.responses[self.core_responses0:]
        self.offered = arrivals
        self.pending_at_close = len(core.pending)
        return segments

    def free(self) -> None:
        """Drop the program's state (engine, graphs, caches, its weights in
        their served form); the benchmark's weights stay for the reference."""
        self.finished = [(r.rid, np.asarray(r.tokens)) for r in self.finished]
        for name in ("core", "policy", "engine", "session"):
            setattr(self, name, None)
        gc.collect()
