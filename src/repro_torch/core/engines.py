"""SI1/SI2 execution engines.

SI1 ``EagerEngine`` -- the paper's 'No runtime engine': PyTorch executes the
model op by op.  Simple, no capture latency, no launch-overhead savings.

SI2 ``CompiledEngine`` -- the paper's 'Runtime engine': at ``warmup`` (or at
the first prefill of a batch size) one decode step is captured into a CUDA
graph whose static buffers hold the KV cache, which the graph updates in
place (the counterpart of the JAX package's donated cache).  Prefill stays
eager and writes its k/v straight into those buffers; every decode step
replays the graph.  A failed capture raises; it never falls back to eager.
On the CPU the same step functions run uncaptured.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

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
    def _prefill(self, tokens):
        with torch.no_grad():
            return transformer.prefill(self.params, self.cfg, {"tokens": tokens},
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
    replays: int = 0


class CompiledEngine(Engine):
    """SI2: runtime engine -- one CUDA graph of the decode step per batch size.

    The cache a prefill returns and the logits a decode returns live in the
    graph's buffers and are overwritten by the next prefill or decode of the
    same batch size.
    """

    name = "SI2_compiled"

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 256, device=None):
        super().__init__(cfg, params, max_seq, device)
        self.graphs: Dict[int, _DecodeGraph] = {}

    def _capture(self, batch: int) -> _DecodeGraph:
        cfg, params = self.cfg, self.params
        cache = transformer.init_cache(cfg, batch, self.max_seq, device=self.device)
        tokens = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        with torch.no_grad():
            # one eager step on a side stream first: loads every kernel and
            # lets the allocator settle before capture, as CUDA graphs require
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                transformer.decode_step(params, cfg, cache, tokens)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = ops.launch_counts()
            with torch.cuda.graph(graph):
                logits, new_cache = transformer.decode_step(params, cfg, cache, tokens)
                cache["lengths"].copy_(new_cache["lengths"])
            after = ops.launch_counts()
        per_replay = {k: after[k] - before[k] for k in after}
        return _DecodeGraph(graph, cache, tokens, logits, per_replay)

    def _graph(self, batch: int) -> _DecodeGraph:
        g = self.graphs.get(batch)
        if g is None:
            g = self.graphs[batch] = self._capture(batch)
        return g

    def decode_cache(self, batch: int, max_seq: int) -> dict:
        """On the card: the graph's own buffers for ``batch``, zeroed in
        place (the graph decodes no other cache, and copying one in would
        cost a whole-cache copy a step).  Their size is the engine's, so
        another ``max_seq`` raises."""
        if self.device.type != "cuda":
            return super().decode_cache(batch, max_seq)
        if max_seq != self.max_seq:
            raise ValueError(f"SI2's decode cache holds max_seq {self.max_seq} "
                             f"entries a slot, not {max_seq}")
        cache = self._graph(batch).cache
        for leaf in cache.values():
            leaf.zero_()
        return cache

    def _prefill(self, tokens):
        if self.device.type != "cuda":
            return super()._prefill(tokens)
        g = self._graph(tokens.shape[0])
        with torch.no_grad():
            return transformer.prefill(self.params, self.cfg, {"tokens": tokens},
                                       self.max_seq, cache=g.cache)

    def _decode(self, cache, tokens):
        if self.device.type != "cuda":
            with torch.no_grad():
                return transformer.decode_step(self.params, self.cfg, cache, tokens)
        g = self._graph(tokens.shape[0])
        if cache is not g.cache:
            raise ValueError("SI2 decodes only the cache its own prefill wrote "
                             f"(the graph's buffers for batch {tokens.shape[0]})")
        g.tokens.copy_(tokens)
        g.graph.replay()
        g.replays += 1
        return g.logits, g.cache

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
