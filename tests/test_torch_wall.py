"""The wall-clock span log (``serving/telemetry/wall.py``) and the spans the
continuous-batching policy records in it: one engine span per executed
call and none for a replayed one, children inside their parents, the
prefill's padding counters, the ring's bound, and the profiler's timeline
(spans enter ``record_function`` only while a profiler runs)."""

import statistics

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import engines
from repro_torch.models import transformer
from repro_torch.serving import core as tcore
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import stepcache
from repro_torch.serving.request import Request
from repro_torch.serving.telemetry import wall

ARCH = "minitron-4b-smoke"
ENGINE_SPANS = {"repro_torch.drain", "repro_torch.prefill", "repro_torch.decode", "repro_torch.insert",
                "repro_torch.token_read"}
LENGTHS = (3, 5, 9, 17, 12, 4, 30)


def _workload():
    rng = np.random.default_rng(7)
    return [Request(rid=i, prompt=rng.integers(1, 500, size=n).astype(np.int32),
                    max_new_tokens=2 + i % 4, arrival_s=0.002 * i)
            for i, n in enumerate(LENGTHS)]


def _core(engine, step_cache=None):
    policy = tsched.make_policy("continuous_batch", max_batch=4, max_seq=64)
    return tcore.SchedulerCore(engine, policy, step_cache=step_cache)


def _executed():
    """A run on the CPU that executes every engine call, the calls counted
    as the benchmark harness counts them (wrapped on the instance)."""
    cfg = get_arch(ARCH)
    engine = engines.CompiledEngine(cfg, transformer.init_params(cfg, 0, "cpu"), 64, "cpu")
    calls = {"prefill": 0, "decode": 0}
    prefill, decode = engine.prefill_one, engine.decode_batch

    def prefill_one(tokens):
        calls["prefill"] += 1
        return prefill(tokens)

    def decode_batch(cache, tokens):
        calls["decode"] += 1
        return decode(cache, tokens)

    engine.prefill_one, engine.decode_batch = prefill_one, decode_batch
    core = _core(engine)
    metrics = core.run(_workload())
    return core, calls, metrics


def test_one_engine_span_per_executed_call():
    core, calls, metrics = _executed()
    names = [s.name for s in core.wall_log.spans()]
    assert calls["prefill"] == len(LENGTHS) == names.count("repro_torch.prefill")
    assert names.count("repro_torch.admit") == names.count("repro_torch.insert") == len(LENGTHS)
    assert calls["decode"] == names.count("repro_torch.decode") == names.count("repro_torch.token_read")
    assert names.count("repro_torch.drain") == calls["prefill"] + calls["decode"]
    assert names.count("repro_torch.step") == names.count("repro_torch.retire") >= calls["decode"]
    assert len(metrics.responses) == len(LENGTHS)
    # decode spans count the live slots; the CPU engine times no replay
    decodes = [s for s in core.wall_log.spans() if s.name == "repro_torch.decode"]
    assert all(1 <= s.tokens <= 4 and s.device_ns == -1 for s in decodes)


def test_children_lie_inside_their_parents():
    core, _, _ = _executed()
    spans = core.wall_log.spans()
    by_seq = {s.seq: s for s in spans}
    parents = {"repro_torch.admit": "repro_torch.step", "repro_torch.prefill": "repro_torch.admit",
               "repro_torch.insert": "repro_torch.admit", "repro_torch.decode": "repro_torch.step",
               "repro_torch.token_read": "repro_torch.step", "repro_torch.retire": "repro_torch.step"}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.name == "repro_torch.step":
            assert s.parent == -1
            continue
        p = by_seq[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s.name, p.name)
        if s.name == "repro_torch.drain":
            assert p.name in ("repro_torch.admit", "repro_torch.step")
        else:
            assert p.name == parents[s.name]
        if p.name == "repro_torch.admit":
            assert s.rid == p.rid >= 0
    for s in spans:
        if s.name == "repro_torch.prefill":
            assert s.start_ns <= s.enqueued_ns <= s.end_ns


def test_prefill_counts_its_prompt_and_bucket():
    core, _, _ = _executed()
    prefills = {s.rid: s for s in core.wall_log.spans() if s.name == "repro_torch.prefill"}
    assert sorted(prefills) == list(range(len(LENGTHS)))
    for rid, n in enumerate(LENGTHS):
        assert prefills[rid].tokens == n
        assert prefills[rid].bucket == stepcache.shape_bucket(n)


def test_a_cpu_prefill_span_records_no_graph_replay():
    """``graph`` on a prefill span says whether the engine replayed a
    captured prefill: never on the CPU (0); other spans leave it at -1."""
    core, _, _ = _executed()
    for s in core.wall_log.spans():
        assert s.graph == (0 if s.name == "repro_torch.prefill" else -1), s.name
    assert core.engine.prefill_captures == 0


def test_the_virtual_clock_advances_by_the_engine_spans():
    core, _, metrics = _executed()
    spans = core.wall_log.spans()
    timed = sum(s.end_ns - s.start_ns for s in spans
                if s.name in ("repro_torch.prefill", "repro_torch.decode"))
    assert metrics.wall_compute_s == pytest.approx(timed / 1e9, rel=1e-9)


def test_a_warm_step_cache_records_no_engine_span():
    cfg = get_arch(ARCH)
    cache = stepcache.StepTimeCache()
    for n in LENGTHS:
        cache.put(("prefill1", stepcache.shape_bucket(n)), (0.004,))
    cache.put(("decode", 4), (0.003,))
    core = _core(stepcache.ReplayEngine(cfg), step_cache=cache)
    metrics = core.run(_workload())
    names = {s.name for s in core.wall_log.spans()}
    assert len(metrics.responses) == len(LENGTHS) and cache.misses == 0
    assert not names & ENGINE_SPANS
    assert {"repro_torch.step", "repro_torch.admit", "repro_torch.retire"} <= names


def test_the_log_outlives_a_run_reset():
    core, _, _ = _executed()
    n = core.wall_log.count
    core.begin()
    assert core.wall_log.count == n and len(core.wall_log.spans()) == n


def test_the_ring_keeps_its_last_spans_and_counts_the_rest():
    log = wall.WallLog()
    assert wall.CAPACITY == 65536
    extra = 123
    for _ in range(wall.CAPACITY + extra):
        with log.span("repro_torch.step"):
            pass
    kept = log.spans()
    assert len(kept) == wall.CAPACITY and log.dropped == extra
    assert [s.seq for s in kept[:2]] == [extra, extra + 1]
    assert kept[-1].seq == wall.CAPACITY + extra - 1


def test_a_span_closes_when_its_block_raises():
    log = wall.WallLog()
    with pytest.raises(RuntimeError):
        with log.span("repro_torch.step"):
            with log.span("repro_torch.decode"):
                raise RuntimeError("engine failed")
    with log.span("repro_torch.step") as top:
        pass
    assert top.parent == -1 and all(s.end_ns >= s.start_ns for s in log.spans())


def test_spans_between_two_instants():
    log = wall.WallLog()
    for _ in range(3):
        with log.span("repro_torch.step"):
            pass
    a, b, c = log.spans()
    assert log.spans(b.start_ns, c.start_ns) == [b, c]
    assert log.spans(a.end_ns + 10**12, a.end_ns + 2 * 10**12) == []


def test_no_profiler_no_record_function(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    core, _, _ = _executed()
    assert core.wall_log.count > 0 and entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        core, _, _ = _executed()
    assert entered == [s.name for s in core.wall_log.spans()]


def test_spans_land_on_the_profiler_timeline():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        core, _, _ = _executed()
    log = core.wall_log
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("repro_torch.") and e.device_type() == DeviceType.CPU:
            events.setdefault(e.name(), []).append(e.start_ns())
    spans = {}
    for s in log.spans():
        spans.setdefault(s.name, []).append(s.start_ns + log.epoch_offset_ns)
    assert set(events) == set(spans) and len(spans) == 8
    gaps = []
    for name, starts in spans.items():
        assert len(events[name]) == len(starts), name
        gaps += [abs(a - b) for a, b in zip(sorted(events[name]), sorted(starts))]
    assert statistics.median(gaps) <= 50_000, statistics.median(gaps)
    assert max(gaps) <= 1_000_000, max(gaps)
