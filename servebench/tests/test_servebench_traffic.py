"""The traffic generator: deterministic from the seed, in its ranges, stratified."""

import json
import math
import os

import numpy as np
import pytest

from servebench import traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BIG_SEED = 2**31 + 987654321


def mix(name):
    with open(os.path.join(ROOT, "servebench", "traffic", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["chat", "decode", "prompt"])
def test_same_seed_same_requests(name):
    a = traffic.take(mix(name), BIG_SEED, 32000, 200)
    b = traffic.take(mix(name), BIG_SEED, 32000, 200)
    c = traffic.take(mix(name), BIG_SEED + 1, 32000, 200)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new_tokens == y.max_new_tokens
               and x.arrival_s == y.arrival_s for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("name", ["chat", "decode", "prompt"])
def test_lengths_in_range_and_log_uniform(name):
    m = mix(name)
    reqs = traffic.take(m, 11, 32000, 640)
    plen = np.array([len(r.prompt) for r in reqs])
    olen = np.array([r.max_new_tokens for r in reqs])
    assert plen.min() >= m["prompt"][0] and plen.max() <= m["prompt"][1]
    assert olen.min() >= m["output"][0] and olen.max() <= m["output"][1]
    # every block holds one draw from each of 64 slices of log(length)
    lo, hi = m["prompt"]
    span = math.log(hi + 1) - math.log(lo)
    k = np.arange(traffic.BLOCK)
    for b in range(0, 640, traffic.BLOCK):
        n = np.sort(plen[b:b + traffic.BLOCK])
        # a length n stands for a draw in [n, n + 1)
        assert np.all((np.log(n + 1) - math.log(lo)) / span >= k / traffic.BLOCK - 1e-12)
        assert np.all((np.log(n) - math.log(lo)) / span < (k + 1) / traffic.BLOCK)
    assert all(1 <= int(r.prompt.min()) and int(r.prompt.max()) < 32000 for r in reqs)


@pytest.mark.parametrize("name", ["chat", "decode", "prompt"])
def test_every_seed_sends_the_same_sizes_in_another_order(name):
    a = traffic.take(mix(name), 1, 1000, traffic.BLOCK)
    b = traffic.take(mix(name), BIG_SEED, 1000, traffic.BLOCK)
    for key in (lambda r: len(r.prompt), lambda r: r.max_new_tokens):
        assert sorted(map(key, a)) == sorted(map(key, b))
        assert list(map(key, a)) != list(map(key, b))


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_open_loop_rate_is_the_mix_rate_at_each_block(seed):
    m = dict(mix("chat"), loop="open", rate_per_s=3.0)
    reqs = traffic.take(m, seed, 32000, 4 * traffic.BLOCK)
    t = np.array([r.arrival_s for r in reqs])
    assert np.all(np.diff(t) >= 0)
    for b in range(1, 5):
        span = t[b * traffic.BLOCK - 1]
        # the middles of 64 slices of the exponential: a block's mean gap is
        # 1/rate within 2 %
        assert abs(span / (b * traffic.BLOCK) * m["rate_per_s"] - 1) < 0.02


@pytest.mark.parametrize("name", ["chat", "decode", "prompt"])
def test_backlog_arrives_at_once(name):
    reqs = traffic.take(mix(name), 3, 32000, 100)
    assert {r.arrival_s for r in reqs} == {0.0}
    assert [r.rid for r in reqs] == list(range(100))


def test_unknown_loop_is_refused():
    with pytest.raises(ValueError):
        traffic.take(dict(mix("chat"), loop="closed"), 1, 100, 1)
