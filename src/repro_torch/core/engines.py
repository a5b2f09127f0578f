"""SI1/SI2 execution engines.

SI1 ``EagerEngine`` -- the paper's 'No runtime engine': PyTorch executes the
model op by op.  Simple, no capture latency, no launch-overhead savings.

SI2 ``CompiledEngine`` -- the paper's 'Runtime engine': at ``warmup`` (or at
the first prefill of a batch size) one decode step is captured into a CUDA
graph whose static buffers hold the KV cache, which the graph updates in
place (the counterpart of the JAX package's donated cache), and every
decode step replays the graph.  A B = 1 prefill (``prefill_one``, each
admission of continuous batching) replays a graph of its own prompt length,
captured at the first call of that length, which writes its k/v straight
into the B = 1 decode graph's buffers; ``generate``'s (B, S) prefill stays
eager and writes into the buffers of its batch's graph.  A slot-pool caller
(continuous batching, calibration) gets a cache of its own from
``decode_cache``, decoded by a graph captured on that cache's buffers, so
two pools on one engine (two replicas of an endpoint) never share slots.
A failed capture raises; it never falls back to eager.  On the CPU the
same step functions run uncaptured.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.devices import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer


def token_landing_s(prefill_s: float, decode_s: float, n_steps: int,
                    n: int) -> float:
    """Offset from generation start at which the n-th token (1-based) lands.

    Token 1 comes out of the prefill logits; tokens 2..n_steps land one
    decode step apart (``decode_s`` spans the ``n_steps - 1`` decode calls).
    """
    step = decode_s / max(n_steps - 1, 1)
    return prefill_s + max(min(n, n_steps) - 1, 0) * step


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, n_new)
    prefill_s: float
    decode_s: float               # total decode wall time
    n_steps: int
    compile_s: float = 0.0

    @property
    def decode_s_per_token(self) -> float:
        return self.decode_s / max(self.n_steps, 1)

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s

    def token_done_s(self, n: int) -> float:
        """Landing offset of this result's n-th token (see token_landing_s)."""
        return token_landing_s(self.prefill_s, self.decode_s, self.n_steps, n)


class Engine:
    """Shared generation loop; subclasses choose the execution mode."""

    name = "abstract"

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 256, device=None):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.device = resolve_device(device)

    # -- execution hooks ------------------------------------------------------
    def _batch(self, tokens) -> dict:
        """The prefill's batch: the tokens and, for audio, the stub front
        end's frames, zeros (B, encoder_seq, D) in the model dtype."""
        batch = {"tokens": tokens}
        cfg = self.cfg
        if cfg.family == "audio":
            batch["frames"] = torch.zeros((tokens.shape[0], cfg.encoder_seq, cfg.d_model),
                                          dtype=cfg.torch_dtype, device=self.device)
        return batch

    def _prefill(self, tokens):
        with torch.no_grad():
            return transformer.prefill(self.params, self.cfg, self._batch(tokens),
                                       self.max_seq)

    def _decode(self, cache, tokens):
        raise NotImplementedError

    def warmup(self, batch: int, prompt_len: int) -> float:
        return 0.0

    def _sync(self):
        """Wait for the device, so a host clock read next measures its work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device, torch.int32)
        return torch.as_tensor(np.asarray(tokens, np.int32)).to(self.device)

    # -- public API -----------------------------------------------------------
    def generate(self, tokens: np.ndarray, max_new_tokens: int) -> GenerationResult:
        """Greedy generation. tokens: (B, S) int32."""
        tokens = self._tokens(tokens)
        t0 = time.perf_counter()
        logits, cache = self._prefill(tokens)
        self._sync()
        t1 = time.perf_counter()
        out = []
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
        for _ in range(max_new_tokens - 1):
            logits, cache = self._decode(cache, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(tok)
        self._sync()
        t2 = time.perf_counter()
        return GenerationResult(
            tokens=torch.stack(out, dim=1).cpu().numpy(),
            prefill_s=t1 - t0,
            decode_s=t2 - t1,
            n_steps=max_new_tokens,
        )

    # serving hooks for continuous batching (SI3) ------------------------------
    def prefill_one(self, tokens):
        """tokens: (1, S). Returns (logits (1,V), cache_B1)."""
        return self._prefill(self._tokens(tokens))

    def decode_batch(self, cache, tokens):
        return self._decode(cache, self._tokens(tokens))

    def decode_cache(self, batch: int, max_seq: int) -> dict:
        """A fresh cache of ``batch`` slots (every leaf zero, ``lengths`` 0)
        that ``decode_batch`` decodes; slot-pool callers (continuous
        batching, calibration) take their cache from here."""
        return transformer.init_cache(self.cfg, batch, max_seq, device=self.device)

    def last_decode_device_ns(self) -> int:
        """Device nanoseconds of the last ``decode_batch``, read once the
        caller has synchronised; -1 where the engine does not time it."""
        return -1

    def last_prefill_replayed(self) -> bool:
        """Whether the last ``prefill_one`` replayed a captured graph (False
        for an eager or a capturing call)."""
        return False


class EagerEngine(Engine):
    """SI1: no runtime engine -- op-by-op framework dispatch."""

    name = "SI1_eager"

    def _decode(self, cache, tokens):
        with torch.no_grad():
            return transformer.decode_step(self.params, self.cfg, cache, tokens)


@dataclasses.dataclass
class _DecodeGraph:
    """One captured decode step and the static buffers it reads and writes."""

    graph: torch.cuda.CUDAGraph
    cache: dict                   # init_cache layout: updated in place by replay
    tokens: torch.Tensor          # (B,) int32 input
    logits: torch.Tensor          # (B, V) f32 output, overwritten by replay
    launches_per_replay: Dict[str, int]
    # recorded on the stream around each replay: its device time
    started: torch.cuda.Event
    ended: torch.cuda.Event
    capture_s: float = 0.0        # the eager step and the capture
    replays: int = 0

    @property
    def batch(self) -> int:
        return self.tokens.shape[0]

    @property
    def cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.cache.values())


@dataclasses.dataclass
class _PrefillGraph:
    """One captured B = 1 prefill of one prompt length and its static buffers."""

    graph: torch.cuda.CUDAGraph
    tokens: torch.Tensor          # (1, S) int32 input
    logits: torch.Tensor          # (1, V) f32 output, overwritten by any prefill graph
    cache: dict                   # the B = 1 decode graph's buffers, written in place
    launches_per_replay: Dict[str, int]
    capture_s: float = 0.0        # the eager prefill and the capture
    replays: int = 0              # calls served by a replay (the capturing one not counted)


class _SlotCache(dict):
    """A slot cache handed out by ``CompiledEngine.decode_cache``: a dict of
    its graph's buffers that carries the graph (``graph``) and can be weakly
    referenced, so the graph returns to the engine's free list when the
    caller drops the cache."""


class CompiledEngine(Engine):
    """SI2: runtime engine -- one CUDA graph of the decode step per batch size,
    and one of the B = 1 prefill per prompt length.

    The cache a prefill returns and the logits a decode returns live in the
    graph's buffers and are overwritten by the next prefill or decode of the
    same batch size.  The logits ``prefill_one`` returns are overwritten by
    the next ``prefill_one`` of any length: its graphs share one memory pool.
    """

    name = "SI2_compiled"

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 256, device=None):
        super().__init__(cfg, params, max_seq, device)
        self.graphs: Dict[int, _DecodeGraph] = {}      # generate's, by batch
        # slot-pool graphs: every one captured (in order), and those whose
        # cache was dropped, free to hand out again (by batch)
        self.slot_graphs: List[_DecodeGraph] = []
        self._free: Dict[int, List[_DecodeGraph]] = {}
        self._last: Optional[_DecodeGraph] = None      # the last graph replayed
        # B = 1 prefill graphs by prompt length, all in one memory pool
        self.prefill_graphs: Dict[int, _PrefillGraph] = {}
        self._prefill_pool = None
        self._prefill_replayed = False

    @property
    def prefill_captures(self) -> int:
        return len(self.prefill_graphs)

    @property
    def prefill_replays(self) -> int:
        return sum(g.replays for g in self.prefill_graphs.values())

    def _record(self, step, pool=None):
        """Run ``step`` once eagerly on a side stream (it loads every kernel
        and lets the allocator settle before capture, as CUDA graphs
        require), then capture it into a graph (in ``pool`` if given).
        Returns (the graph, ``step``'s output in its buffers, the launches
        a replay makes by kernel)."""
        with torch.no_grad():
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = ops.launch_counts()
            with torch.cuda.graph(graph, pool=pool):
                out = step()
            after = ops.launch_counts()
        self._sync()
        return graph, out, {k: after[k] - before[k] for k in after}

    def _capture(self, batch: int) -> _DecodeGraph:
        cfg, params = self.cfg, self.params
        t0 = time.perf_counter()
        cache = transformer.init_cache(cfg, batch, self.max_seq, device=self.device)
        tokens = torch.zeros((batch,), dtype=torch.int32, device=self.device)

        def step():
            logits, new_cache = transformer.decode_step(params, cfg, cache, tokens)
            cache["lengths"].copy_(new_cache["lengths"])
            return logits

        graph, logits, per_replay = self._record(step)
        return _DecodeGraph(graph, cache, tokens, logits, per_replay,
                            torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True),
                            capture_s=time.perf_counter() - t0)

    def _graph(self, batch: int) -> _DecodeGraph:
        g = self.graphs.get(batch)
        if g is None:
            g = self.graphs[batch] = self._capture(batch)
        return g

    def decode_cache(self, batch: int, max_seq: int) -> dict:
        """On the card: a cache no other caller and no ``generate`` shares,
        zeroed, whose buffers are those of a decode graph captured for it
        (copying a cache into a shared graph would cost a whole-cache copy a
        step).  A graph whose cache was dropped is handed out again before a
        new one is captured.  Their size is the engine's, so another
        ``max_seq`` raises."""
        if self.device.type != "cuda":
            return super().decode_cache(batch, max_seq)
        if max_seq != self.max_seq:
            raise ValueError(f"SI2's decode cache holds max_seq {self.max_seq} "
                             f"entries a slot, not {max_seq}")
        free = self._free.setdefault(batch, [])
        if free:
            g = free.pop()
        else:
            g = self._capture(batch)
            self.slot_graphs.append(g)
        for leaf in g.cache.values():
            leaf.zero_()
        cache = _SlotCache(g.cache)
        cache.graph = g
        weakref.finalize(cache, free.append, g)
        return cache

    def graph_of(self, cache: dict) -> _DecodeGraph:
        """The graph that decodes ``cache``: its slot graph if
        ``decode_cache`` handed it out, else ``generate``'s graph whose
        buffers it is; raises for any other cache."""
        g = getattr(cache, "graph", None)
        if g is not None:
            return g
        batch = cache["lengths"].shape[0]
        g = self.graphs.get(batch)
        if g is None or cache is not g.cache:
            raise ValueError("SI2 decodes only the cache its own prefill wrote "
                             f"(the graph's buffers for batch {batch}) or one "
                             "that decode_cache handed out")
        return g

    def _prefill(self, tokens):
        if self.device.type != "cuda":
            return super()._prefill(tokens)
        g = self._graph(tokens.shape[0])
        with torch.no_grad():
            return transformer.prefill(self.params, self.cfg, self._batch(tokens),
                                       self.max_seq, cache=g.cache)

    def _capture_prefill(self, tokens) -> _PrefillGraph:
        """Capture the B = 1 prefill of ``tokens``' length into the shared
        pool; its buffers then hold ``tokens`` (the graph is not replayed)."""
        t0 = time.perf_counter()
        cache = self._graph(1).cache
        static = tokens.clone()
        if self._prefill_pool is None:
            self._prefill_pool = torch.cuda.graph_pool_handle()

        def step():
            return transformer.prefill(self.params, self.cfg, self._batch(static),
                                       self.max_seq, cache=cache)[0]

        graph, logits, per_replay = self._record(step, self._prefill_pool)
        return _PrefillGraph(graph, static, logits, cache, per_replay,
                             capture_s=time.perf_counter() - t0)

    def prefill_one(self, tokens):
        """tokens: (1, S).  On the card, replays the prefill graph of length
        S, captured at the first call of that length (one eager prefill and
        the capture, then a replay).  Callers that repeat pass bucketed
        lengths (``shape_bucket``), so the graphs are one a bucket; an
        unbucketed caller captures one a distinct length.  A batch of
        several prompts, and the CPU, take ``generate``'s eager prefill."""
        tokens = self._tokens(tokens)
        self._prefill_replayed = False
        if self.device.type != "cuda" or tokens.shape[0] != 1:
            return self._prefill(tokens)
        S = tokens.shape[1]
        g = self.prefill_graphs.get(S)
        if g is None:
            g = self.prefill_graphs[S] = self._capture_prefill(tokens)
        else:
            g.tokens.copy_(tokens)
            g.replays += 1
            self._prefill_replayed = True
        g.graph.replay()
        return g.logits, g.cache

    def last_prefill_replayed(self) -> bool:
        return self._prefill_replayed

    def _decode(self, cache, tokens):
        if self.device.type != "cuda":
            with torch.no_grad():
                return transformer.decode_step(self.params, self.cfg, cache, tokens)
        g = self.graph_of(cache)
        g.tokens.copy_(tokens)
        g.started.record()
        g.graph.replay()
        g.ended.record()
        g.replays += 1
        self._last = g
        return g.logits, cache

    def last_decode_device_ns(self) -> int:
        """The last graph replay's device time, from the event pair recorded
        around it on the stream; adds no sync, so call it after one."""
        g = self._last
        if g is None:
            return -1
        return int(g.started.elapsed_time(g.ended) * 1e6)

    def warmup(self, batch: int, prompt_len: int) -> float:
        """Run one prefill and capture the decode step for ``batch``; returns
        the seconds it took (the 'runtime engine' build the paper attributes
        to SI2)."""
        t0 = time.perf_counter()
        tokens = torch.zeros((batch, prompt_len), dtype=torch.int32, device=self.device)
        logits, cache = self._prefill(tokens)
        tok = torch.argmax(logits, -1).to(torch.int32)
        self._decode(cache, tok)
        self._sync()
        return time.perf_counter() - t0


def make_engine(si_name: str, cfg, params, max_seq: int = 256, device=None) -> Engine:
    if si_name in ("si1_no_runtime", "SI1"):
        return EagerEngine(cfg, params, max_seq, device)
    if si_name in ("si2_runtime", "SI2"):
        return CompiledEngine(cfg, params, max_seq, device)
    raise ValueError(f"unknown engine {si_name!r}: SI1 or SI2")
