"""Deterministic LM data pipeline: synthetic corpus -> packed token batches.

The port's own copy of the JAX package's ``training/data.py`` (numpy only,
the same draws in the same order): for a seed its batches are bit-identical
to the reference's.  A seeded Zipfian token stream with injected n-gram
structure (so the loss actually decreases during the example training
runs), document boundaries, and sequence packing with next-token labels.
Batches are numpy arrays; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_repeat: int = 4          # how strongly bigrams repeat (learnability)


class SyntheticLM:
    """Infinite deterministic stream of packed (tokens, labels) batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        # fixed bigram table: each token has a few likely successors
        g = np.random.RandomState(cfg.seed + 1)
        self._succ = g.randint(0, v, size=(v, cfg.ngram_repeat))

    def _sample_doc(self, length: int) -> np.ndarray:
        v = self.cfg.vocab_size
        out = np.empty(length, np.int64)
        tok = int(self.rng.zipf(self.cfg.zipf_a) % v)
        for i in range(length):
            out[i] = tok
            if self.rng.rand() < 0.8:  # follow the bigram structure
                tok = int(self._succ[tok, self.rng.randint(self.cfg.ngram_repeat)])
            else:
                tok = int(self.rng.zipf(self.cfg.zipf_a) % v)
        return out

    def batches(self) -> Iterator[dict]:
        cfg = self.cfg
        buf = np.empty(0, np.int64)
        while True:
            need = cfg.batch_size * (cfg.seq_len + 1)
            while len(buf) < need:
                doc = self._sample_doc(self.rng.randint(32, 512))
                buf = np.concatenate([buf, doc, [1]])  # 1 = doc separator
            chunk = buf[:need].reshape(cfg.batch_size, cfg.seq_len + 1)
            buf = buf[need:]
            yield {
                "tokens": chunk[:, :-1].astype(np.int32),
                "labels": chunk[:, 1:].astype(np.int32),
            }


def eval_batches(cfg: DataConfig, n: int):
    """A fixed held-out set (different seed)."""
    ds = SyntheticLM(dataclasses.replace(cfg, seed=cfg.seed + 104729))
    it = ds.batches()
    return [next(it) for _ in range(n)]
