"""Shape-bucketed measured-step-time cache for virtual-clock replay.

The serving simulator advances a virtual clock with *measured* engine step
times.  Those times depend (to first order) only on the compiled executable's
input shapes, not on the token values — so once a ``(kind, batch, bucket)``
shape has been measured, repeated calls can *replay* the recorded duration on
the virtual clock instead of re-executing the model.  That turns a 1k-request
synthetic workload from minutes of model execution into a sub-second
simulation while keeping the queueing/energy dynamics faithful.

Keys (all sequence lengths power-of-two bucketed):

  ``("generate", B, S_bucket, max_new)`` -> ``(prefill_s, decode_s)``
  ``("prefill1", S_bucket)``             -> ``(dt_s,)``
  ``("decode", num_slots)``              -> ``(dt_s,)``

The first measurement for a key wins and is never overwritten, so a warm
cache replays a deterministic timeline (tested).  Replayed calls skip the
model entirely; token ids for them are synthesized deterministically from the
prompt (`synth_tokens`) — fine for workload simulation, not for correctness
tests, which run uncached.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def shape_bucket(n: int) -> int:
    """Round up to the next power of two (compiled-executable reuse)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def synth_tokens(prompt: np.ndarray, n: int, vocab: int) -> np.ndarray:
    """Deterministic stand-in tokens for replayed (simulated) engine calls."""
    seed = int(np.asarray(prompt, np.int64).sum()) * 1000003 + 7 * len(prompt)
    i = np.arange(n, dtype=np.int64)
    return ((seed + 2654435761 * (i + 1)) % max(int(vocab), 1)).astype(np.int32)


class ReplayEngine:
    """Engine stand-in for pure-replay cells: a warm :class:`StepTimeCache`
    means the model is never executed, so sweep workers (which run in
    separate processes and must not re-calibrate or touch a device)
    deploy endpoints with this stub instead of a real engine.  Any cache
    miss — a shape the parent did not calibrate — fails loudly rather than
    silently simulating with made-up step times."""

    def __init__(self, cfg):
        self.cfg = cfg
        # the slot cache a continuous batch holds is never decoded here
        self.device = torch.device("cpu")

    def _refuse(self, what: str):
        raise RuntimeError(
            f"ReplayEngine cannot execute {what}: this shape is missing "
            "from the warm StepTimeCache — calibrate it in the parent "
            "process before dispatching replay cells")

    def generate(self, tokens, max_new_tokens):
        self._refuse(f"generate(B={tokens.shape[0]}, S={tokens.shape[1]}, "
                     f"max_new={max_new_tokens})")

    def prefill_one(self, tokens):
        self._refuse("prefill_one")

    def decode_batch(self, cache, tokens):
        self._refuse("decode_batch")

    def decode_cache(self, batch: int, max_seq: int) -> dict:
        from repro_torch.models import transformer

        return transformer.init_cache(self.cfg, batch, max_seq, device=self.device)


class StepTimeCache:
    """Measured step durations keyed by execution shape; first write wins."""

    def __init__(self):
        self._times: Dict[tuple, Tuple[float, ...]] = {}
        self.hits = 0
        self.misses = 0

    # -- cross-process transport (the sweep pool ships calibrations) ----------
    def to_payload(self) -> Dict[tuple, Tuple[float, ...]]:
        """Picklable snapshot of the measurements (plain dict of tuples)."""
        return dict(self._times)

    @classmethod
    def from_payload(cls,
                     payload: Dict[tuple, Tuple[float, ...]]
                     ) -> "StepTimeCache":
        cache = cls()
        for k, v in payload.items():
            cache._times[tuple(k)] = tuple(float(x) for x in v)
        return cache

    def __len__(self) -> int:
        return len(self._times)

    def has(self, key: tuple) -> bool:
        """Membership without touching the hit/miss counters."""
        return key in self._times

    def get(self, key: tuple) -> Optional[Tuple[float, ...]]:
        hit = self._times.get(key)
        if hit is None:
            self.misses += 1
        else:
            self.hits += 1
        return hit

    def put(self, key: tuple, payload: Iterable[float]) -> None:
        self._times.setdefault(key, tuple(float(x) for x in payload))

    def has_shape(self, s_bucket: int) -> bool:
        """True if any measurement exists for this sequence-length bucket
        (the fleet's route-to-warmest affinity check)."""
        for k in self._times:
            if k[0] == "generate" and k[2] == s_bucket:
                return True
            if k[0] == "prefill1" and k[1] == s_bucket:
                return True
        return False

    def floor_ttft_s(self) -> Optional[float]:
        """The tightest TTFT any schedule could achieve from these
        measurements: the smallest measured batch-1 prefill on record.
        Spec validation rejects SLO budgets below this floor.

        Only true batch-1 measurements are used when available; otherwise
        the fallback scales a batched prefill linearly down to b=1, which
        (prefill scaling sublinearly in batch) is a LOWER bound — the check
        may then pass a borderline-infeasible budget, but never rejects a
        feasible one.
        """
        exact, approx = [], []
        for k, v in self._times.items():
            if k[0] == "generate":
                (exact if k[1] == 1 else approx).append(v[0] / max(k[1], 1))
            elif k[0] == "prefill1":
                exact.append(v[0])
        if exact:
            return min(exact)
        return min(approx) if approx else None

    def seed_from(self, other: "StepTimeCache") -> "StepTimeCache":
        """Copy measurements (first write still wins) — used to hand a
        calibrated cache to each new fleet replica."""
        for k, v in other._times.items():
            self._times.setdefault(k, v)
        return self

    def estimate_generate(self, batch: int, s_bucket: int,
                          max_new: int) -> Optional[Tuple[float, float]]:
        """(prefill_s, decode_s) prediction for a candidate batch size.

        Exact measurement if present; otherwise linear extrapolation from the
        nearest measured batch at the same (S_bucket, max_new) — a pessimistic
        (compute-bound) scaling that the adaptive policy uses for sizing.
        """
        exact = self._times.get(("generate", batch, s_bucket, max_new))
        if exact is not None:
            return exact
        near = [
            (k[1], v) for k, v in self._times.items()
            if k[0] == "generate" and k[2] == s_bucket and k[3] == max_new
        ]
        if not near:
            return None
        b_meas, (p, d) = min(near, key=lambda kv: abs(kv[0] - batch))
        f = batch / b_meas
        return (p * f, d * f)


def calibrate(engine, cache: StepTimeCache, *, batch_sizes: Iterable[int],
              prompt_len: int, max_new: int, vocab: int,
              num_slots: Optional[int] = None,
              max_seq: int = 256) -> StepTimeCache:
    """Populate ``cache`` with real measurements for the given shapes.

    Measures batched ``generate`` for each batch size, plus the
    continuous-batching primitives (single-prompt prefill, fused decode step)
    when ``num_slots`` is given.  After calibration a SchedulerCore run over a
    workload of these shapes is pure replay — no model execution.  The slot
    cache comes from ``engine.decode_cache``, so under SI2 on the card the
    measured step is the captured graph's, and ``max_seq`` must be the
    engine's own there.
    """
    rng = np.random.RandomState(0)
    sb = shape_bucket(prompt_len)
    for B in batch_sizes:
        prompts = rng.randint(0, vocab, size=(B, sb)).astype(np.int32)
        engine.generate(prompts, max_new)        # warm: keep one-time graph
        res = engine.generate(prompts, max_new)  # capture out of the cache
        cache.put(("generate", B, sb, max_new), (res.prefill_s, res.decode_s))
    if num_slots is not None:
        prompt = rng.randint(0, vocab, size=(sb,)).astype(np.int32)
        engine.prefill_one(prompt[None, :])      # warm
        engine._sync()
        # sanctioned measurement: calibration IS the act of reading real
        # step times that virtual-clock replay then reuses
        t0 = time.perf_counter()                 # simlint: allow(wall-clock)
        logits, _sub = engine.prefill_one(prompt[None, :])
        torch.argmax(logits, -1)
        engine._sync()
        dt = time.perf_counter() - t0            # simlint: allow(wall-clock)
        cache.put(("prefill1", sb), (dt,))

        kv = engine.decode_cache(num_slots, max_seq)
        tok = torch.zeros((num_slots,), dtype=torch.int32, device=engine.device)
        _logits, kv = engine.decode_batch(kv, tok)  # warm (cache updated in place)
        engine._sync()
        t0 = time.perf_counter()                 # simlint: allow(wall-clock)
        logits, _kv = engine.decode_batch(kv, tok)
        torch.argmax(logits, -1)
        engine._sync()
        dt = time.perf_counter() - t0            # simlint: allow(wall-clock)
        cache.put(("decode", num_slots), (dt,))
    return cache
