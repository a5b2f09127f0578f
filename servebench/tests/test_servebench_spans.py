"""The four readers of the program's wall-clock spans (``core.wall_log``):
their arithmetic on a log of known spans, their numbers on a CPU cell, and
no number, and no error, from a program that keeps no such log."""

import types

import pytest
import torch

from servebench import run as bench_run
from servebench.serve import Cell
from servebench.tests.test_servebench_faults import MIX, _config, _Energy

READERS = ("decode_device_ms", "prefill_enqueue_share", "sched_self_ms", "prefill_useful")
MS = 1_000_000


def _span(log, name, start, end, **fields):
    """A span of ``log`` closed at once and moved to [start, end] ms after
    1 s (``enqueued_ns`` an instant there too, ``device_ns`` in ms)."""
    sp = log.span(name)
    sp.__exit__(None, None, None)
    sp.start_ns, sp.end_ns = (1000 + start) * MS, (1000 + end) * MS
    for key, value in fields.items():
        setattr(sp, key, {"enqueued_ns": (1000 + value) * MS,
                          "device_ns": value * MS}.get(key, value))
    return sp


def _run(log):
    """A run whose untraced window is [1.0 s, 1.1 s]."""
    return types.SimpleNamespace(core=types.SimpleNamespace(wall_log=log), window_open=1.0,
                                 main=types.SimpleNamespace(wall_s=0.1))


def test_readers_on_known_spans():
    from repro_torch.serving.telemetry.wall import WallLog

    log = WallLog()
    # a step before the window, then two steps in it: an admission and a
    # decode, and a decode alone; the spans of one step nest as the policy's do
    for base in (-50, 10):
        step = log.span("repro_torch.step")
        admit = log.span("repro_torch.admit")
        _span(log, "repro_torch.drain", base, base + 1)
        _span(log, "repro_torch.prefill", base + 1, base + 11, enqueued_ns=base + 9, tokens=300,
              bucket=512)
        _span(log, "repro_torch.insert", base + 11, base + 12)
        admit.__exit__(None, None, None)
        _span(log, "repro_torch.drain", base + 12, base + 13)
        _span(log, "repro_torch.decode", base + 13, base + 23, tokens=4, device_ns=base + 60)
        step.__exit__(None, None, None)
        step.start_ns, step.end_ns = (1000 + base) * MS, (1000 + base + 25) * MS
    step = log.span("repro_torch.step")
    _span(log, "repro_torch.decode", 40, 46, tokens=4, device_ns=4)
    step.__exit__(None, None, None)
    step.start_ns, step.end_ns = 1039 * MS, 1048 * MS
    run = _run(log)
    got = {name: bench_run.reader(name)(run) for name in READERS}
    assert got["decode_device_ms"] == pytest.approx((70 + 4) / 2)
    assert got["prefill_enqueue_share"] == pytest.approx(100 * 8 / 10)
    # step one: 25 - 10 - 10; step two: 9 - 6
    assert got["sched_self_ms"] == pytest.approx((5 + 3) / 2)
    assert got["prefill_useful"] == pytest.approx(100 * 300 / 512)


def test_no_log_no_number():
    run = types.SimpleNamespace(core=types.SimpleNamespace(), window_open=1.0,
                                main=types.SimpleNamespace(wall_s=1.0))
    for name in READERS:
        assert bench_run.reader(name)(run) is None


def test_readers_on_a_cpu_cell():
    cell = Cell(_config("minitron-4b"), dict(MIX, loop="backlog"), 2**31 + 77,
                torch.device("cpu"))
    cell.setup()
    cell.main = cell.window(0.5, _Energy(), lambda: None, min_done=8)[0]
    got = {name: bench_run.reader(name)(cell) for name in READERS}
    assert got["decode_device_ms"] is None        # the CPU engine times no replay
    assert 0 < got["prefill_enqueue_share"] <= 100
    assert 0 < got["sched_self_ms"] < bench_run.reader("decode_step_ms")(cell)
    assert 50 <= got["prefill_useful"] <= 100
