"""Percentiles and the tails of a window with censored requests."""

import types

import numpy as np
import pytest

from servebench import readings, stats


@pytest.mark.parametrize("n", [1, 2, 5, 20, 201])
def test_percentile_is_linear_between_ranks(n):
    xs = list(np.random.default_rng(n).random(n))
    for q in (0, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), abs=1e-12)


def test_ttft_counts_a_request_without_first_token_up_to_the_window_end():
    seg = types.SimpleNamespace(virt1=10.0, arrivals={1: 1.0, 2: 2.0, 3: 9.5},
                                first={1: 1.5, 2: 12.0})
    assert sorted(readings.ttft_s(seg)) == pytest.approx([0.5, 0.5, 8.0])
    assert readings.p95_ms(readings.ttft_s(seg)) == pytest.approx(
        stats.percentile([0.5, 0.5, 8.0], 95) * 1e3)
    assert readings.p95_ms([]) is None


def test_tpot_over_completed_requests():
    done = [types.SimpleNamespace(tokens=np.zeros(n), done_s=d, first_token_s=f)
            for n, d, f in ((11, 2.0, 1.0), (1, 5.0, 5.0), (3, 1.0, 0.8))]
    seg = types.SimpleNamespace(done=done)
    assert readings.tpot_s(seg) == pytest.approx([0.1, 0.1])
