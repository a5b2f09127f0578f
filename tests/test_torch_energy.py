"""The port's energy meter, carbon signals, sanitizer, admission ladder,
pending queue and workload generators against the JAX package's: the same
event scripts and seeds give bit-identical joules, grams, arrivals and
prompts (``==``, not approx)."""

import dataclasses

import numpy as np
import pytest

from repro.carbon import signal as jsig
from repro.energy import meter as jmeter
from repro.energy import sanitize as jsan
from repro.serving import queue as jqueue
from repro.serving import request as jreq
from repro.serving.admission import priority as jprio
from repro.workload import generators as jgen
from repro_torch.carbon import signal as tsig
from repro_torch.energy import hw as thw
from repro_torch.energy import meter as tmeter
from repro_torch.energy import sanitize as tsan
from repro_torch.serving import queue as tqueue
from repro_torch.serving import request as treq
from repro_torch.serving.admission import priority as tprio
from repro_torch.workload import generators as tgen


def _diurnal(sig):
    return sig.DiurnalSignal(amplitude_g_per_kwh=300.0, period_s=8.0)


# -- meter event scripts: each takes (meter module, signal module, meter class)


def _conservation(M, S, cls):
    m = cls(active_power_w=10.0, idle_power_w=3.0)
    m.record_active(2.0, rids=[1, 2], tokens=4)
    m.record_active_shared(0.0, {3: 1.0, 4: 3.0}, tokens=6)
    m.record_idle(5.0)
    return m


def _time_priced(M, S, cls):
    m = cls(active_power_w=100.0, idle_power_w=10.0, carbon=_diurnal(S))
    m.record_active(1.0, rids=[1, 2], tokens=4, t_s=1.5)
    m.record_active_shared(5.5, {3: 6.0, 4: 6.5}, tokens=4)
    m.record_idle(0.5, t_s=0.0)
    return m


def _buckets(M, S, cls):
    m = cls(active_power_w=100.0, idle_power_w=20.0, carbon=_diurnal(S))
    m.record_active(0.5, rids=[1, 2], tokens=10, t_s=0.0)
    m.record_idle(0.25, t_s=0.5)
    m.record_preempt(0.01, t_s=0.75)
    m.record_xfer(0.02, 15.0, t_s=0.76)
    m.record_active_shared(1.0, {3: 1.2, 4: 1.4}, tokens=4, power_w=40.0)
    m.mark_lost([3], t_s=1.3)
    return m


def _merge_absorb(M, S, cls):
    a = M.EnergyMeter(carbon=_diurnal(S))
    a.record_active(1.0, rids=[1], tokens=2, t_s=2.0)
    a.record_idle(1.0, t_s=3.0)
    b = M.EnergyMeter(carbon=S.ConstantSignal(g_per_kwh=900.0))
    b.record_active(2.0, rids=[2], tokens=2, t_s=0.0)
    total = cls()
    total.merge(a, source="a/r0")
    total.merge(b, source="b/r0")
    outer = cls()
    outer.merge(total)
    return outer


def _absorb_legacy(M, S, cls):
    req = jreq if M is jmeter else treq
    legacy = req.ServingMetrics(responses=[], wall_compute_s=3.6e4,
                                energy_j=0.0, total_tokens=10)
    agg = cls(active_power_w=100.0)
    M.absorb_part(agg, legacy)
    part = M.EnergyMeter(active_power_w=50.0, idle_power_w=5.0)
    part.record_active(1.0, rids=[7], t_s=0.0)
    M.absorb_part(agg, req.ServingMetrics([], 1.0, part.total_j, 0, meter=part),
                  source="p0")
    return agg


SCRIPTS = {"conservation": _conservation, "time_priced": _time_priced,
           "buckets": _buckets, "merge": _merge_absorb, "absorb": _absorb_legacy}


def _state(m) -> dict:
    d = dataclasses.asdict(m)
    d.pop("carbon")
    d.update(summary=m.summary(), total_j=m.total_j, total_g=m.total_g,
             active_j=m.active_j, idle_j=m.idle_j,
             energy_per_token_j=m.energy_per_token_j, g_per_token=m.g_per_token,
             signal=dataclasses.asdict(m.signal))
    return d


@pytest.mark.parametrize("sanitized", [False, True], ids=["plain", "sanitized"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_meter_scripts_bit_identical(script, sanitized):
    j_cls = jsan.SanitizedEnergyMeter if sanitized else jmeter.EnergyMeter
    t_cls = tsan.SanitizedEnergyMeter if sanitized else tmeter.EnergyMeter
    want = SCRIPTS[script](jmeter, jsig, j_cls)
    got = SCRIPTS[script](tmeter, tsig, t_cls)
    assert _state(got) == _state(want)


def test_meter_helpers_and_host_constants():
    args = (65.0, 0.031, 0.12, 4, 16)
    assert tmeter.estimate_j_per_token(*args) == jmeter.estimate_j_per_token(*args)
    assert tmeter.measured_j(1.25, 412.5) == jmeter.measured_j(1.25, 412.5)
    from repro.energy import hw as jhw
    for name in ("HOST_CPU_POWER_W", "HOST_CPU_IDLE_FRACTION", "HOST_CPU_IDLE_POWER_W",
                 "CARBON_G_PER_KWH"):
        assert getattr(thw, name) == getattr(jhw, name)
    assert [f.name for f in dataclasses.fields(thw.ChipSpec)] == \
        [f.name for f in dataclasses.fields(jhw.ChipSpec)]
    assert not hasattr(thw, "TPU_V5E")


def test_new_meter_follows_the_environment(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert type(tsan.new_meter()) is tmeter.EnergyMeter
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert isinstance(tsan.new_meter(active_power_w=5.0), tsan.SanitizedEnergyMeter)
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert type(tsan.new_meter()) is tmeter.EnergyMeter


@pytest.mark.parametrize("tamper, match", [
    (lambda m: setattr(m, "active_s", m.active_s + 0.1), "active_s"),
    (lambda m: m.per_request_j.__setitem__(7, 2 * m.per_request_j[7]), "sum_req_j"),
])
def test_sanitizer_names_the_tampering(tamper, match):
    for san in (jsan, tsan):
        m = san.SanitizedEnergyMeter(active_power_w=100.0, idle_power_w=20.0)
        m.record_active(0.5, rids=[7], t_s=0.0)
        tamper(m)
        with pytest.raises(san.ConservationError, match=match):
            m.record_idle(0.1, t_s=0.5)
    with pytest.raises(tsan.ConservationError, match="negative duration"):
        tsan.SanitizedEnergyMeter().record_active(-0.5, t_s=0.0)


def test_observation_guard_catches_a_writing_observer():
    class Recorder:
        def __init__(self):
            self.events, self.dropped, self.requests = [], 0, []
            self.holds, self.sinks = [], []

        def bucket_totals(self):
            return {"active_j": float(len(self.events))}

    rec = Recorder()
    with tsan.observation_guard(rec):
        pass
    with pytest.raises(tsan.ConservationError):
        with tsan.observation_guard(rec, "tick"):
            rec.events.append("write")


# -- carbon signals --------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda S: S.ConstantSignal(),
    lambda S: S.ConstantSignal(g_per_kwh=123.0),
    lambda S: S.DiurnalSignal(amplitude_g_per_kwh=500.0, period_s=10.0, phase_s=1.5,
                              floor_g_per_kwh=20.0),
    lambda S: S.TraceSignal.from_csv("t,g\n0,100\n10,300\n25,50\n"),
    lambda S: S.CarbonSpec(kind="diurnal", g_per_kwh=400.0, period_s=6.0).build(),
    lambda S: S.CarbonSpec(kind="trace", trace=((0, 10), (4, 90))).build(),
], ids=["constant", "constant_123", "diurnal", "trace", "spec_diurnal", "spec_trace"])
def test_carbon_signals_bit_identical(make):
    want, got = make(jsig), make(tsig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for t in np.linspace(-3.0, 40.0, 87):
        assert got.intensity(float(t)) == want.intensity(float(t))
        assert got.grams(12.5, float(t), 0.75) == want.grams(12.5, float(t), 0.75)
    assert got.lowest_window_t(0.0, 20.0, 0.5, 2.0) == want.lowest_window_t(0.0, 20.0, 0.5, 2.0)
    bad = dict(kind="trace", trace=((5.0, 1.0), (5.0, 2.0)))
    assert tsig.CarbonSpec(**bad).problems() == jsig.CarbonSpec(**bad).problems()


# -- admission ladder and the pending queue ------------------------------------


def test_priority_ladder_matches():
    assert tprio.PRIORITY_LEVELS == jprio.PRIORITY_LEVELS
    for name in (None, "interactive", "standard", "batch"):
        assert tprio.priority_level(name) == jprio.priority_level(name)
    with pytest.raises(ValueError, match="unknown priority class"):
        tprio.priority_level("vip")
    spec = dict(enabled=True, preempt=True, pause_ms=3.0, max_preemptions=2)
    assert dataclasses.asdict(tprio.PrioritySpec(**spec).build()) == \
        dataclasses.asdict(jprio.PrioritySpec(**spec).build())
    assert tprio.PrioritySpec().build() is None


def _queue_trace(Q, wl):
    """Every PendingQueue operation the core uses, on a laddered backlog."""
    q = Q.PendingQueue(wl, use_rungs=True)
    out = [len(q), q.peek().rid, [r.rid for r in q.pending_within(0.3)]]
    out.append(q.pop_best(0.3).rid)
    out.append(q.peek_best(0.5).rid)
    pre = q.pop_preemptor(2, 0.6)
    out.append(pre.rid if pre is not None else None)
    out.append(q.pop().rid)
    late = wl[0]
    late.rid, late.arrival_s = 999, 0.25
    q.push(late)
    out.append([r.rid for r in q.pending_within(0.4)])
    out.append([r.rid for r in q.drain_all()])
    out.append(q.has_pending())
    return out


def test_pending_queue_matches():
    def wl(gen):
        reqs = gen.poisson(12, 4, 2, 50, rate_per_s=20.0, seed=4)
        for r, p in zip(reqs, ["batch", "standard", "interactive", None] * 3):
            r.priority = p
        return reqs

    assert _queue_trace(tqueue, wl(tgen)) == _queue_trace(jqueue, wl(jgen))


# -- workload generators ---------------------------------------------------------


def _same_requests(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a) if f.name != "prompt"}
        fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b) if f.name != "prompt"}
        assert fa == fb
        assert a.prompt.dtype == b.prompt.dtype and np.array_equal(a.prompt, b.prompt)


GENERATORS = {
    "synth_workload": lambda G, R: R.synth_workload(60, 16, 8, 1000, rate_per_s=40.0,
                                                    seed=3, rid0=500, slo_ms=80.0),
    "synth_deadline": lambda G, R: R.synth_workload(20, 8, 4, 100, rate_per_s=5.0,
                                                    seed=1, deadline_s=9.0),
    "poisson": lambda G, R: G.poisson(50, 8, 4, 100, rate_per_s=20.0, seed=7,
                                      priority="batch"),
    "diurnal": lambda G, R: G.diurnal(50, 8, 4, 100, base_rate_per_s=5.0,
                                      peak_rate_per_s=50.0, period_s=10.0, seed=7),
    "bursty": lambda G, R: G.bursty(120, 8, 4, 100, rate_per_s=10.0, burst_n=40,
                                    burst_every_s=6.0, burst_rate_per_s=300.0,
                                    phase_s=1.0, seed=2, rid0=1000, slo_ms=50.0,
                                    deadline_s=9.0),
    "replay": lambda G, R: G.replay([0.0, 0.5, 0.5, 2.25], 8, 4, 100, seed=5),
    "spec_diurnal": lambda G, R: G.WorkloadSpec(
        kind="diurnal", n=40, rate_per_s=4.0, peak_rate_per_s=40.0, period_s=5.0,
        origins=("eu", "us"), priority="interactive").build(vocab=77),
    "spec_bursty": lambda G, R: G.WorkloadSpec(
        kind="bursty", n=30, burst_n=10, burst_rate_per_s=100.0, seed=9).build(vocab=64),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_bit_identical(name):
    _same_requests(GENERATORS[name](tgen, treq), GENERATORS[name](jgen, jreq))


def test_workload_spec_problems_match():
    bad = dict(kind="bursty", n=0, rate_per_s=-1.0, burst_n=0, priority="vip")
    assert tgen.WorkloadSpec(**bad).problems() == jgen.WorkloadSpec(**bad).problems()
    with pytest.raises(ValueError, match="n: must be >= 1"):
        tgen.WorkloadSpec(**bad).build(vocab=10)
