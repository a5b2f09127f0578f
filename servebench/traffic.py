"""The one traffic generator: a mix file of parameters in, requests out.

A mix (``servebench/traffic/<name>.json``) gives:
- ``loop``: ``open`` (Poisson arrivals at ``rate_per_s`` on the serving
  timeline) or ``backlog`` (every request pending from the start, so each
  slot refills as it frees);
- ``prompt`` and ``output``: [lo, hi] token counts, drawn log-uniform;
- ``slots`` and ``max_seq``: the continuous batch's pool;
- ``warm_in_s`` (open loop): timeline seconds served before the window opens.

Lengths and gaps are stratified in blocks of ``BLOCK`` requests: each block
holds the middle value of each of ``BLOCK`` equal slices of the
distribution, in an order shuffled by the seed.  Every seed so sends the
same set of sizes and gaps in every block, in another order, and the same
mean rate at every block boundary.  Token ids are uniform over the
vocabulary.  The same seed gives the same requests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

BLOCK = 64


@dataclass
class Spec:
    """One request as generated: prompt ids, output length, arrival time."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float


def _stratified(rng: np.random.Generator, n: int) -> np.ndarray:
    """The middles of the n slices [i/n, (i+1)/n) of [0, 1), shuffled."""
    return rng.permutation((np.arange(n) + 0.5) / n)


def _log_uniform(u: np.ndarray, lo: int, hi: int) -> np.ndarray:
    v = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    return np.clip(np.floor(v), lo, hi).astype(np.int64)


def requests(mix: dict, seed: int, vocab: int) -> Iterator[Spec]:
    """Requests of ``mix`` in arrival order, without end."""
    rng = np.random.default_rng(seed)
    open_loop = mix["loop"] == "open"
    if not open_loop and mix["loop"] != "backlog":
        raise ValueError(f"unknown loop {mix['loop']!r}: open or backlog")
    t = 0.0
    rid = 0
    while True:
        plen = _log_uniform(_stratified(rng, BLOCK), *mix["prompt"])
        olen = _log_uniform(_stratified(rng, BLOCK), *mix["output"])
        gaps = (-np.log1p(-_stratified(rng, BLOCK)) / mix["rate_per_s"]
                if open_loop else np.zeros(BLOCK))
        for i in range(BLOCK):
            t += float(gaps[i])
            ids = rng.integers(1, vocab, size=int(plen[i]), dtype=np.int64).astype(np.int32)
            yield Spec(rid, ids, int(olen[i]), t)
            rid += 1


def take(mix: dict, seed: int, vocab: int, n: int) -> List[Spec]:
    gen = requests(mix, seed, vocab)
    return [next(gen) for _ in range(n)]
