"""The port's SchedulerCore, TD3 policies and step-time cache against the JAX
package's.

  * replay: on the same warm StepTimeCache no model runs, so every policy's
    ServingMetrics, per-request joules and grams and every response's times
    are bit-identical (``==``) to the reference's, plain, under
    ``REPRO_SANITIZE=1``, under a preemptive priority ladder and on a
    diurnal carbon signal;
  * execution in f32: every policy's greedy tokens equal the reference's
    (minitron-4b-smoke; continuous batching also on rwkv6-3b-smoke and
    mixtral-8x7b-smoke, whose slot insert copies the ssm and moe leaves);
  * a free continuous-batch slot that steps past ``max_seq`` drops its
    cache write, as the reference's scatter does, and the busy slots'
    tokens stay the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.carbon.signal import DiurnalSignal as JDiurnal
from repro.configs import get_arch as j_get_arch
from repro.core import engines as jeng
from repro.models import transformer as JT
from repro.serving import core as jcore
from repro.serving import scheduler as jsched
from repro.serving import stepcache as jstep
from repro.serving.admission.priority import AdmissionControl as JAdmission
from repro.serving.request import Request as JRequest
from repro.serving.request import synth_workload as j_synth_workload
from repro.workload import generators as jgen
from repro_torch.carbon.signal import DiurnalSignal as TDiurnal
from repro_torch.configs import get_arch
from repro_torch.core import engines as teng
from repro_torch.models import transformer as T
from repro_torch.serving import core as tcore
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import stepcache as tstep
from repro_torch.serving.admission.priority import AdmissionControl as TAdmission
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.request import synth_workload
from repro_torch.workload import generators as tgen

ARCH = "minitron-4b-smoke"
PACKAGES = {
    "ref": dict(core=jcore, sched=jsched, step=jstep, gen=jgen, Diurnal=JDiurnal,
                Admission=JAdmission),
    "port": dict(core=tcore, sched=tsched, step=tstep, gen=tgen, Diurnal=TDiurnal,
                 Admission=TAdmission),
}
POLICY_NAMES = ("realtime", "dynamic_batch", "adaptive_batch", "continuous_batch",
                "prefill_phase", "decode_phase")


# -- replay: bit-identical timelines, joules and grams ---------------------------


def _warm_cache(step):
    """Monotone synthetic step times for every shape the replay runs use."""
    cache = step.StepTimeCache()
    for b in range(1, 5):
        for n in (2, 3, 5):
            cache.put(("generate", b, 8, n), (0.004 + 0.0013 * b, (0.010 + 0.0021 * b) * n))
    cache.put(("prefill1", 8), (0.0047,))
    cache.put(("decode", 4), (0.0031,))
    return cache


def _workload(pkg, laddered: bool):
    wl = pkg["gen"].bursty(28, 5, 3, 100, rate_per_s=30.0, burst_n=10, burst_every_s=0.3,
                           burst_rate_per_s=400.0, seed=11)
    for i, r in enumerate(wl):
        r.max_new_tokens = (2, 3, 5)[i % 3]
        if laddered:
            r.priority = "interactive" if i % 9 == 8 else ("batch", "standard")[i % 2]
    return wl


def _policy(pkg, name):
    sched = pkg["sched"]
    if name == "prefill_phase":
        return sched.PrefillPhasePolicy(max_batch=4, timeout_ms=12.0)
    if name == "decode_phase":
        return sched.DecodePhasePolicy(max_batch=4, timeout_ms=12.0)
    return sched.make_policy(name, max_batch=4, timeout_ms=12.0, max_seq=32,
                             ttft_slo_ms=25.0)


def _replay(pkg, name, setup):
    kw = {}
    if setup == "ladder":
        kw["admission"] = pkg["Admission"](preempt=True, max_preemptions=2)
    if setup == "diurnal":
        kw["carbon"] = pkg["Diurnal"](amplitude_g_per_kwh=350.0, period_s=0.9)
    engine = pkg["step"].ReplayEngine(j_get_arch(ARCH) if pkg["core"] is jcore
                                      else get_arch(ARCH))
    core = pkg["core"].SchedulerCore(engine, _policy(pkg, name),
                                     step_cache=_warm_cache(pkg["step"]),
                                     active_power_w=412.5, idle_power_w=71.25, **kw)
    return core.run(_workload(pkg, setup == "ladder"))


def _responses(m):
    return [(r.rid, r.arrival_s, r.start_s, r.first_token_s, r.done_s, r.deadline_s,
             r.priority, np.asarray(r.tokens).tolist()) for r in m.responses]


def _assert_same_metrics(got, want):
    assert got.summary() == want.summary()
    assert (got.wall_compute_s, got.energy_j, got.total_tokens) == \
        (want.wall_compute_s, want.energy_j, want.total_tokens)
    gm, wm = dataclasses.asdict(got.meter), dataclasses.asdict(want.meter)
    assert gm.pop("carbon") == wm.pop("carbon")
    assert gm == wm     # per-request J and g, every bucket, tokens
    assert _responses(got) == _responses(want)


@pytest.mark.parametrize("setup", ["plain", "sanitize", "ladder", "diurnal"])
@pytest.mark.parametrize("name", POLICY_NAMES)
def test_replay_bit_identical(name, setup, monkeypatch):
    if setup == "sanitize":
        monkeypatch.setenv("REPRO_SANITIZE", "1")
    else:
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    want = _replay(PACKAGES["ref"], name, setup)
    got = _replay(PACKAGES["port"], name, setup)
    assert len(got.responses) == 28
    _assert_same_metrics(got, want)
    if setup == "sanitize":
        assert type(got.meter).__name__ == "SanitizedEnergyMeter"
    if setup == "ladder" and name in ("realtime", "dynamic_batch", "adaptive_batch"):
        assert got.meter.preempt_j > 0.0    # the ladder really preempted


@pytest.mark.parametrize("name", ["dynamic_batch", "continuous_batch"])
def test_incremental_mode_bit_identical(name):
    """begin / offer / drain_until / finish, the fleet's entry mode."""
    runs = []
    for key in ("ref", "port"):
        pkg = PACKAGES[key]
        engine = pkg["step"].ReplayEngine(j_get_arch(ARCH) if key == "ref" else get_arch(ARCH))
        core = pkg["core"].SchedulerCore(engine, _policy(pkg, name),
                                         step_cache=_warm_cache(pkg["step"]))
        core.begin()
        wl = _workload(pkg, False)
        for i in range(0, len(wl), 5):
            for r in wl[i:i + 5]:
                core.offer(r)
            core.drain_until(wl[min(i + 5, len(wl) - 1)].arrival_s)
        core.drain_until()
        runs.append(core.finish())
    _assert_same_metrics(runs[1], runs[0])


def test_replay_engine_refuses_a_miss():
    core = tcore.SchedulerCore(tstep.ReplayEngine(get_arch(ARCH)),
                               tsched.RealTimePolicy(), step_cache=tstep.StepTimeCache())
    with pytest.raises(RuntimeError, match="missing from the warm StepTimeCache"):
        core.run(tgen.poisson(2, 8, 2, 50, rate_per_s=5.0))


def test_step_cache_and_helpers_match():
    for n in (1, 2, 3, 8, 9, 17, 513):
        assert tstep.shape_bucket(n) == jstep.shape_bucket(n)
    prompt = np.arange(11, dtype=np.int32)
    np.testing.assert_array_equal(tstep.synth_tokens(prompt, 9, 777),
                                  jstep.synth_tokens(prompt, 9, 777))
    np.testing.assert_array_equal(tcore.pad_prompts([prompt[:3], prompt], width=16),
                                  jcore.pad_prompts([prompt[:3], prompt], width=16))
    t, j = _warm_cache(tstep), _warm_cache(jstep)
    assert t.to_payload() == j.to_payload()
    for b in (1, 3, 6, 8):
        assert t.estimate_generate(b, 8, 3) == j.estimate_generate(b, 8, 3)
    assert t.floor_ttft_s() == j.floor_ttft_s()
    assert t.has_shape(8) and not t.has_shape(16)
    assert tstep.StepTimeCache.from_payload(j.to_payload()).to_payload() == j.to_payload()
    assert tsched.POLICIES == jsched.POLICIES
    with pytest.raises(ValueError):
        tsched.make_policy("fifo")


# -- real execution, f32 ---------------------------------------------------------


def _pair(arch: str, max_seq: int):
    jcfg = j_get_arch(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = T.params_from_numpy(jax.tree.map(np.asarray, jp), get_arch(arch), device="cpu")
    return (jeng.CompiledEngine(jcfg, jp, max_seq=max_seq),
            {"SI1": teng.EagerEngine(get_arch(arch), p, max_seq, device="cpu"),
             "SI2": teng.CompiledEngine(get_arch(arch), p, max_seq, device="cpu")})


@pytest.fixture(scope="module")
def minitron():
    return _pair(ARCH, 64)


def _tokens(sched_mod, kind, engine, wl, max_seq=64):
    sched = sched_mod.make_scheduler(kind, engine, max_batch=4, timeout_ms=10.0,
                                     max_seq=max_seq)
    m = sched.run(wl)
    return {r.rid: np.asarray(r.tokens).tolist() for r in m.responses}


@pytest.mark.parametrize("si", ["SI1", "SI2"])
@pytest.mark.parametrize("kind", jsched.POLICIES)
def test_policy_tokens_match_reference(minitron, kind, si):
    jengine, tengines = minitron
    vocab = get_arch(ARCH).vocab_size
    want = _tokens(jsched, kind, jengine,
                   j_synth_workload(4, 8, 3, vocab, rate_per_s=1000, seed=3))
    got = _tokens(tsched, kind, tengines[si],
                  synth_workload(4, 8, 3, vocab, rate_per_s=1000, seed=3))
    assert len(got) == 4 and got == want


@pytest.mark.parametrize("arch", ["rwkv6-3b-smoke", "mixtral-8x7b-smoke"])
def test_continuous_batch_tokens_match_reference_ssm_and_moe(arch):
    jengine, tengines = _pair(arch, 32)
    vocab = get_arch(arch).vocab_size
    wl = lambda gen: gen.poisson(5, 6, 4, vocab, rate_per_s=200, seed=2)  # noqa: E731
    want = _tokens(jsched, "continuous_batch", jengine, wl(jgen), 32)
    got = _tokens(tsched, "continuous_batch", tengines["SI1"], wl(tgen), 32)
    assert len(got) == 5 and got == want


def test_slot_insert_copies_in_place_and_returns_the_same_dict():
    for arch in ("rwkv6-3b-smoke", ARCH):
        cfg = get_arch(arch)
        cache = T.init_cache(cfg, 3, 8, device="cpu")
        sub = {k: torch.full_like(v[:, :1], 7) for k, v in cache.items() if k != "lengths"}
        sub["lengths"] = torch.tensor([5], dtype=torch.int32)
        leaves = {k: v for k, v in cache.items()}
        out = tsched.ContinuousBatchPolicy(3, 8)._insert(cache, sub, 1)
        assert out is cache
        for k, v in cache.items():
            assert v is leaves[k]
            if k == "lengths":
                assert v.tolist() == [0, 5, 0]
            else:
                assert bool((v[:, 1] == 7).all()) and not bool(v[:, 0].any())
                assert not bool(v[:, 2].any())


def test_calibrate_fills_the_reference_keys(minitron):
    jengine, tengines = minitron
    vocab = get_arch(ARCH).vocab_size
    kw = dict(batch_sizes=[1, 2], prompt_len=6, max_new=3, vocab=vocab, num_slots=2,
              max_seq=64)
    want = jstep.calibrate(jengine, jstep.StepTimeCache(), **kw).to_payload()
    for engine in tengines.values():
        got = tstep.calibrate(engine, tstep.StepTimeCache(), **kw).to_payload()
        assert sorted(got) == sorted(want)
        assert all(len(got[k]) == len(want[k]) and min(got[k]) > 0.0 for k in got)


# -- F4: a write past the cache's end is dropped ----------------------------------


def test_decode_write_past_the_end_is_dropped(minitron):
    jengine, tengines = minitron
    cfg, jcfg = get_arch(ARCH), j_get_arch(ARCH)
    rng = np.random.default_rng(0)
    shape = (cfg.num_layers, 2, 16, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tokens = np.array([5, 7], np.int32)
    for uniform, lengths in ((False, [3, 16]), (True, [16, 16])):
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
              "lengths": jnp.asarray(lengths, jnp.int32)}
        tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "lengths": torch.tensor(lengths, dtype=torch.int32)}
        with torch.no_grad():
            t_logits, t_cache = T.decode_step(tengines["SI1"].params, cfg, tc,
                                              torch.from_numpy(tokens),
                                              uniform_lengths=uniform)
        assert t_cache["lengths"].tolist() == [n + 1 for n in lengths]
        # the full slot's cache is untouched: nothing was written past its end
        np.testing.assert_array_equal(t_cache["k"][:, 1].numpy(), k[:, 1])
        np.testing.assert_array_equal(t_cache["v"][:, 1].numpy(), v[:, 1])
        if not uniform:
            j_logits, _ = JT.decode_step(jengine.params, jcfg, jc, jnp.asarray(tokens))
            np.testing.assert_allclose(t_logits[0].numpy(), np.asarray(j_logits[0]),
                                       atol=1e-3, rtol=0)


def test_free_slot_past_max_seq_keeps_busy_tokens(minitron):
    """2 slots of 32: B (16 + 2 tokens) retires after one step, and its free
    slot keeps stepping past 32 while A (8 + 20 tokens) decodes."""
    vocab = get_arch(ARCH).vocab_size
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, 8).astype(np.int32),
               rng.integers(0, vocab, 16).astype(np.int32)]

    def run(sched_mod, Req, engine):
        wl = [Req(rid=0, prompt=prompts[0], max_new_tokens=20),
              Req(rid=1, prompt=prompts[1], max_new_tokens=2)]
        m = sched_mod.ContinuousBatchScheduler(engine, num_slots=2, max_seq=32).run(wl)
        return {r.rid: np.asarray(r.tokens).tolist() for r in m.responses}

    jcfg = j_get_arch(ARCH)
    jengine32 = jeng.CompiledEngine(jcfg, minitron[0].params, max_seq=32)
    want = run(jsched, JRequest, jengine32)
    for si in ("SI1", "SI2"):
        port = minitron[1][si]
        engine = type(port)(port.cfg, port.params, 32, device="cpu")
        got = run(tsched, TRequest, engine)
        assert len(got[0]) == 20 and got[0] == want[0]
        assert got[1] == want[1]
