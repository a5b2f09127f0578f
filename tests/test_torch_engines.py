"""SI1/SI2 engines: greedy tokens equal the JAX package's for every TD2
format, SI2 equals SI1, and requests cross the wire codecs unchanged."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import engines as jeng
from repro.models import transformer as JT
from repro.serving import codecs as jcodecs
from repro.serving import formats as jfmt
from repro_torch.configs import get_arch
from repro_torch.core import engines as teng
from repro_torch.models import transformer as T
from repro_torch.serving import codecs as tcodecs
from repro_torch.serving import formats as tfmt
from repro_torch.serving.request import Request, Response

ARCH = "minitron-4b-smoke"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{fmt: (jax tree, port tree)}: one JAX init through each format's files,
    loaded by both packages as the serving API does."""
    jcfg = j_get_arch(ARCH)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = T.params_from_numpy(jax.tree.map(np.asarray, jp), get_arch(ARCH), device="cpu")
    root = tmp_path_factory.mktemp("registry")
    out = {}
    for fmt in ("native", "rsm", "rsm_int8"):
        path = str(root / fmt)
        if fmt == "native":
            jfmt.save_native(jp, path)
            out[fmt] = (jfmt.load_native(jp, path),
                        tfmt.load_native(p, path, device="cpu"))
        else:
            q = fmt == "rsm_int8"
            jfmt.save_rsm(jp, path, quantize=q)
            out[fmt] = (jfmt.load_rsm(jp, path, as_qtensor=q),
                        tfmt.load_rsm(p, path, as_qtensor=q, device="cpu"))
    return out


def _prompt(B=2, S=8):
    return np.random.default_rng(1).integers(0, get_arch(ARCH).vocab_size,
                                             (B, S)).astype(np.int32)


@pytest.mark.parametrize("fmt", ["native", "rsm", "rsm_int8"])
def test_greedy_tokens_match_reference(fmt, served):
    jtree, ttree = served[fmt]
    want = jeng.CompiledEngine(j_get_arch(ARCH), jtree, max_seq=32).generate(_prompt(), 6)
    for cls in (teng.EagerEngine, teng.CompiledEngine):
        got = cls(get_arch(ARCH), ttree, max_seq=32, device="cpu").generate(_prompt(), 6)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.tokens.shape == (2, 6) and got.n_steps == 6


def test_si2_equals_si1_on_cpu(served):
    _, ttree = served["rsm"]
    cfg = get_arch(ARCH)
    si1 = teng.make_engine("SI1", cfg, ttree, 32, device="cpu")
    si2 = teng.make_engine("SI2", cfg, ttree, 32, device="cpu")
    assert isinstance(si1, teng.EagerEngine) and isinstance(si2, teng.CompiledEngine)
    assert si2.warmup(2, 8) > 0.0 and si1.warmup(2, 8) == 0.0
    prompt = _prompt(3, 5)
    np.testing.assert_array_equal(si2.generate(prompt, 7).tokens,
                                  si1.generate(prompt, 7).tokens)
    logits, cache = si1.prefill_one(prompt[:1])
    assert logits.shape == (1, cfg.vocab_size) and int(cache["lengths"][0]) == 5
    logits, cache = si1.decode_batch(cache, np.array([3], np.int32))
    assert int(cache["lengths"][0]) == 6
    with pytest.raises(ValueError, match="unknown engine"):
        teng.make_engine("SI5", cfg, ttree, 32, device="cpu")


def test_prefill_into_a_used_cache_equals_a_fresh_one(served):
    """SI2's prefill overwrites the graph's cache in place: what is left of an
    earlier, longer batch must not survive it."""
    _, ttree = served["rsm"]
    cfg = get_arch(ARCH)
    long, short = (torch.from_numpy(_prompt(2, S)) for S in (11, 6))
    _, used = T.prefill(ttree, cfg, {"tokens": long}, 32)
    want_l, want = T.prefill(ttree, cfg, {"tokens": short}, 32)
    got_l, got = T.prefill(ttree, cfg, {"tokens": short}, 32, cache=used)
    assert got is used
    torch.testing.assert_close(got_l, want_l, rtol=0, atol=0)
    for key in ("k", "v", "lengths"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    with pytest.raises(ValueError, match="slots"):
        T.prefill(ttree, cfg, {"tokens": short[:1]}, 32, cache=used)


def test_generation_timing_helpers_match_reference():
    for args in [(0.5, 1.2, 7, 1), (0.5, 1.2, 7, 4), (0.5, 1.2, 7, 9), (0.1, 0.0, 1, 1)]:
        assert teng.token_landing_s(*args) == jeng.token_landing_s(*args)
    kw = dict(tokens=np.zeros((1, 4), np.int32), prefill_s=0.25, decode_s=0.75, n_steps=4)
    t, j = teng.GenerationResult(**kw), jeng.GenerationResult(**kw)
    assert (t.decode_s_per_token, t.total_s, t.token_done_s(3)) == \
        (j.decode_s_per_token, j.total_s, j.token_done_s(3))


@pytest.mark.parametrize("name", ["json", "binary"])
def test_codec_round_trip_matches_reference(name):
    t, j = tcodecs.make_codec(name), jcodecs.make_codec(name)
    assert t.name == j.name and t.content_type == j.content_type
    prompt = _prompt(1, 9)[0]
    wire = t.encode_request(7, prompt, 16)
    assert wire == j.encode_request(7, prompt, 16)
    rid, toks, n = t.decode_request(wire)
    req = Request(rid=rid, prompt=toks, max_new_tokens=n)
    assert (req.rid, req.max_new_tokens) == (7, 16)
    np.testing.assert_array_equal(req.prompt, prompt)
    out = np.arange(5, dtype=np.int32)
    resp = Response(rid=7, tokens=out, arrival_s=0.0, start_s=0.1,
                    first_token_s=0.2, done_s=0.5)
    assert (resp.latency_s, resp.ttft_s, resp.queue_s) == (0.5, 0.2, 0.1)
    wire = t.encode_response(resp.rid, resp.tokens)
    assert wire == j.encode_response(7, out)
    rid, back = j.decode_response(wire)
    assert rid == 7
    np.testing.assert_array_equal(back, out)
    with pytest.raises(ValueError):
        tcodecs.make_codec("carrier-pigeon")


def test_engine_tokens_are_int32_on_engine_device(served):
    _, ttree = served["rsm"]
    eng = teng.EagerEngine(get_arch(ARCH), ttree, 16, device="cpu")
    assert eng._tokens(_prompt(1, 3)).dtype == torch.int32
    assert eng._tokens(torch.tensor([[1, 2]])).dtype == torch.int32
