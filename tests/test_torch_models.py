"""The port's model layers, attention and transformer against the JAX package.

The same numpy inputs and the same parameters (the JAX package's
``init_params`` tree, converted with ``params_from_numpy``) go through both;
everything runs in float32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rope as jrope
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rope as trope
from repro_torch.models import transformer as T


def _pair(seed, shape, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(t, j, atol, rtol=None):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol if rtol is None else rtol)


# -- layers and rope, atol 1e-5 ----------------------------------------------------


def test_norms():
    jx, x = _pair(0, (3, 5, 64))
    jw, w = _pair(1, (64,))
    jb, b = _pair(2, (64,))
    _close(tlayers.rms_norm(x, w, 1e-5), jlayers.rms_norm(jx, jw, 1e-5), 1e-5)
    _close(tlayers.layer_norm(x, w, b), jlayers.layer_norm(jx, jw, jb), 1e-5)
    _close(tlayers.group_norm_heads(x, w, b, 4),
           jlayers.group_norm_heads(jx, jw, jb, 4), 1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlps(kind):
    D, F = 32, 48
    jx, x = _pair(3, (2, 5, D))
    specs = tlayers.mlp_specs(D, F, kind)
    jp, p = {}, {}
    for i, (k, (shape, _, scale)) in enumerate(sorted(specs.items())):
        jp[k], p[k] = _pair(10 + i, shape, scale or 0.1)
    _close(tlayers.apply_mlp(p, x, kind), jlayers.apply_mlp(jp, jx, kind), 1e-5)


def test_dense_embed_unembed():
    jx, x = _pair(4, (2, 3, 16))
    jw, w = _pair(5, (16, 24))
    jb, b = _pair(6, (24,))
    _close(tlayers.dense(x, w, b), jlayers.dense(jx, jw, jb), 1e-5)
    toks = np.array([[0, 5, 23], [7, 7, 1]], np.int32)
    jt, t = _pair(7, (24, 16))
    _close(tlayers.embed(torch.from_numpy(toks), t), jlayers.embed(jnp.asarray(toks), jt), 0)
    out = tlayers.unembed(x, t.T)
    assert out.dtype == torch.float32
    _close(out, jlayers.unembed(jx, jt.T), 1e-5)
    # a bf16 table still gives f32 logits
    out = tlayers.unembed(x.to(torch.bfloat16), t.T.to(torch.bfloat16))
    assert out.dtype == torch.float32
    _close(out, jlayers.unembed(jx.astype(jnp.bfloat16), jt.T.astype(jnp.bfloat16)), 1e-5)


def test_rope():
    B, S, H, hd = 2, 7, 3, 32
    jpos = jrope.positions_default(B, S, offset=3)
    pos = trope.positions_default(B, S, offset=3)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    ja, a = jrope.rope_angles(jpos, hd, 1e6), trope.rope_angles(pos, hd, 1e6)
    _close(a, ja, 1e-5)
    jx, x = _pair(8, (B, S, H, hd))
    _close(trope.apply_rotary(x, a), jrope.apply_rotary(jx, ja), 1e-5)
    jp3 = jnp.stack([jpos, jpos * 2, jpos + 1])
    p3 = torch.stack([pos, pos * 2, pos + 1])
    _close(trope.mrope_angles(p3, hd, 1e4, (4, 6, 6)),
           jrope.mrope_angles(jp3, hd, 1e4, (4, 6, 6)), 1e-5)


# -- attention, on the tests/test_models_units.py cases ------------------------------


@pytest.mark.parametrize("S,block", [(64, 16), (60, 16), (128, 128)])
@pytest.mark.parametrize("window", [None, 13])
def test_attention_matches_reference(S, block, window):
    B, H, K, dh = 2, 4, 2, 16
    jq, q = _pair(0, (B, S, H, dh))
    jk, k = _pair(1, (B, S, K, dh))
    jv, v = _pair(2, (B, S, K, dh))
    want = jattn.attention_reference(jq, jk, jv, causal=True, window=window)
    _close(tattn.attention(q, k, v, causal=True, window=window, block_kv=block),
           want, 2e-5)
    _close(tattn.attention_reference(q, k, v, causal=True, window=window), want, 2e-5)


def test_attention_kv_lengths_and_offset():
    B, S, H, K, dh = 2, 32, 2, 2, 8
    jq, q = _pair(3, (B, 1, H, dh))
    jk, k = _pair(4, (B, S, K, dh))
    jv, v = _pair(5, (B, S, K, dh))
    lengths = np.array([5, 32], np.int32)
    kw = dict(causal=False, block_kv=8)
    want = jattn.attention(jq, jk, jv, kv_lengths=jnp.asarray(lengths),
                           q_offset=jnp.asarray(lengths - 1), **kw)
    got = tattn.attention(q, k, v, kv_lengths=torch.from_numpy(lengths),
                          q_offset=torch.from_numpy(lengths - 1), **kw)
    _close(got, want, 1e-5)
    ref = tattn.attention_reference(q, k, v, causal=False,
                                    kv_lengths=torch.from_numpy(lengths),
                                    q_offset=torch.from_numpy(lengths - 1))
    _close(got, ref.numpy(), 1e-5)


@pytest.mark.parametrize("window", [None, 16])
def test_decode_attention_matches_reference(window):
    B, S, H, K, dh = 3, 64, 6, 2, 32
    jq, q = _pair(6, (B, H, dh))
    jk, k = _pair(7, (B, S, K, dh))
    jv, v = _pair(8, (B, S, K, dh))
    lengths = np.array([1, 40, 64], np.int32)
    _close(tattn.decode_attention(q, k, v, torch.from_numpy(lengths), window=window),
           jattn.decode_attention(jq, jk, jv, jnp.asarray(lengths), window=window), 1e-5)


# -- the transformer ---------------------------------------------------------------


@pytest.fixture(scope="module")
def twins():
    """(cfg, jax params, port params) per arch name, from one JAX init."""
    cache = {}

    def get(name, **changes):
        key = (name, tuple(sorted(changes.items())))
        if key not in cache:
            jcfg = dataclasses.replace(j_get_arch(name), **changes)
            cfg = dataclasses.replace(get_arch(name), **changes)
            jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
            p = T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
            cache[key] = (jcfg, cfg, jp, p)
        return cache[key]

    return get


def _tokens(cfg, shape, seed=4):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ["minitron-4b-smoke", "qwen3-8b-smoke", "yi-9b-smoke"])
def test_forward_prefill_decode_match_reference(arch, twins):
    jcfg, cfg, jp, p = twins(arch)
    toks = _tokens(cfg, (2, 12))
    _close(T.forward(p, cfg, {"tokens": torch.from_numpy(toks)})["logits"],
           JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})["logits"], 2e-4)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :9])}, max_seq=32)
    tl, tc = T.prefill(p, cfg, {"tokens": torch.from_numpy(toks[:, :9])}, max_seq=32)
    _close(tl, jl, 2e-4)
    for i in range(9, 12):
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, i]))
        tl, tc = T.decode_step(p, cfg, tc, torch.from_numpy(toks[:, i]))
        _close(tl, jl, 2e-4)
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))
    _close(tc["k"], jc["k"], 2e-4)


@pytest.mark.parametrize("arch", ["minitron-4b-smoke", "qwen3-8b-smoke", "yi-9b-smoke"])
def test_decode_matches_forward(arch, twins):
    """The serving invariant, as tests/test_arch_smoke.py: stepping the cache
    reproduces full-sequence logits (port only)."""
    _, cfg, _, p = twins(arch)
    B, S = 2, 12
    tokens = torch.from_numpy(_tokens(cfg, (B, S)))
    full = T.forward(p, cfg, {"tokens": tokens})["logits"]
    logits, cache = T.prefill(p, cfg, {"tokens": tokens[:, : S - 3]}, max_seq=32)
    got = [logits]
    for i in range(S - 3, S):
        logits, cache = T.decode_step(p, cfg, cache, tokens[:, i])
        got.append(logits)
    for j, g in enumerate(got[:-1]):
        err = float((g - full[:, S - 4 + j]).abs().max())
        assert err < 2e-2, (j, err)


def test_vlm_mrope_and_qkv_bias_match_reference(twins):
    for arch in ("qwen2-vl-2b-smoke", "qwen1.5-110b-smoke"):
        jcfg, cfg, jp, p = twins(arch)
        toks = _tokens(cfg, (2, 8))
        jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :6])}, max_seq=16)
        tl, tc = T.prefill(p, cfg, {"tokens": torch.from_numpy(toks[:, :6])}, max_seq=16)
        _close(tl, jl, 2e-4)
        jl, _ = JT.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, 6]))
        tl, _ = T.decode_step(p, cfg, tc, torch.from_numpy(toks[:, 6]))
        _close(tl, jl, 2e-4)


@pytest.mark.parametrize("uniform", [False, True])
def test_window_gather_and_uniform_write_match_reference(uniform, twins):
    """Native window 8 with a 64-entry cache takes the gather branch."""
    jcfg, cfg, jp, p = twins("minitron-4b-smoke", attn_window=8)
    toks = _tokens(cfg, (2, 12))
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_seq=64)
    tl, tc = T.prefill(p, cfg, {"tokens": torch.from_numpy(toks)}, max_seq=64)
    _close(tl, jl, 2e-4)
    tok = toks[:, -1]
    for _ in range(2):
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(tok), uniform_lengths=uniform)
        tl, tc = T.decode_step(p, cfg, tc, torch.from_numpy(tok), uniform_lengths=uniform)
        _close(tl, jl, 2e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_long_context_window_engages_past_64k(twins):
    """minitron's long_context_window (4096) applies once the cache exceeds 65536."""
    jcfg, cfg, jp, p = twins("minitron-4b-smoke")
    toks = _tokens(cfg, (1, 6))
    max_seq = 65536 + 64
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_seq=max_seq)
    tl, tc = T.prefill(p, cfg, {"tokens": torch.from_numpy(toks)}, max_seq=max_seq)
    jl, _ = JT.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, -1]))
    tl, _ = T.decode_step(p, cfg, tc, torch.from_numpy(toks[:, -1]))
    _close(tl, jl, 2e-4)


def test_init_params_tree_matches_reference():
    for arch in ("minitron-4b-smoke", "qwen3-8b-smoke", "qwen1.5-110b-smoke"):
        jp = JT.init_params(j_get_arch(arch), jax.random.PRNGKey(0))
        p = T.init_params(get_arch(arch), seed=0, device="cpu")
        jflat = {jax.tree_util.keystr(k): v.shape
                 for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
        flat = {jax.tree_util.keystr(k): tuple(v.shape)
                for k, v in jax.tree_util.tree_flatten_with_path(p)[0]}
        assert flat == jflat
    cfg = get_arch("minitron-4b-smoke")
    p = T.init_params(cfg, seed=0, device="cpu")
    assert abs(float(p["layers"]["attn"]["wq"].std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    assert torch.equal(T.init_params(cfg, seed=0, device="cpu")["embed"], p["embed"])


def test_params_from_numpy_checks_tree():
    cfg = get_arch("minitron-4b-smoke")
    tree = {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in T.init_params(cfg, device="cpu").items()}
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        T.params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        T.params_from_numpy({"embed": tree["embed"]}, cfg, device="cpu")


def test_other_families_not_ported():
    with pytest.raises(NotImplementedError):
        T.init_params(get_arch("mixtral-8x7b-smoke"), device="cpu")
