"""The hybrid (zamba2) and audio (whisper) families against the JAX package.

The same numpy inputs and the JAX package's parameters (``init_params``,
converted with ``params_from_numpy``) go through both packages in float32 on
the CPU:
  * Mamba2's mixer, whose prompt path here is the chunked (SSD) form of the
    reference's step-by-step scan, at lengths that are and are not multiples
    of its 64-step chunk, with and without an incoming state;
  * the parameter trees and decode caches (keys, shapes, dtypes);
  * whisper's free continuous-batch slot at ``max_seq``;
  * the TD2 formats both ways, and the fence at 8 or more layers (groups);
  * greedy tokens through the SI1/SI2 engines and continuous batching.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import engines as jeng
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.serving import formats as jfmt
from repro.serving import scheduler as jsched
from repro.workload import generators as jgen
from repro_torch.configs import get_arch
from repro_torch.core import engines as teng
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as T
from repro_torch.serving import formats as tfmt
from repro_torch.serving import scheduler as tsched
from repro_torch.workload import generators as tgen

ARCHS = ("zamba2-2.7b-smoke", "whisper-small-smoke")
FORMATS = ("native", "rsm", "rsm_int8")


def _twins(arch, **changes):
    jcfg = dataclasses.replace(j_get_arch(arch), **changes)
    cfg = dataclasses.replace(get_arch(arch), **changes)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, p


@pytest.fixture(scope="module")
def twins():
    cache = {}

    def get(arch, **changes):
        key = (arch, tuple(sorted(changes.items())))
        if key not in cache:
            cache[key] = _twins(arch, **changes)
        return cache[key]

    return get


def _np32(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        a, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np32(got), _np32(want), atol=atol, rtol=atol)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- Mamba2: the chunked form against the reference's scan --------------------------


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("T_len", [1, 7, 64, 100, 130])
def test_mamba2_mix_matches_reference(T_len, with_cache, twins):
    """Output and both states at atol 1e-4, f32; A_log and dt_bias drawn so
    that each head decays at its own rate."""
    jcfg, cfg, jp, _ = twins("zamba2-2.7b-smoke")
    rng = np.random.default_rng(T_len)
    jl = dict(jax.tree.map(lambda a: np.asarray(a[1]), jp["mamba_layers"]))
    nh = cfg.d_inner // cfg.ssm_head_dim
    jl["A_log"] = _rand(rng, (nh,), 0.5)
    jl["dt_bias"] = _rand(rng, (nh,))
    tl = {k: torch.from_numpy(np.array(v)) for k, v in jl.items()}
    jl = {k: jnp.asarray(v) for k, v in jl.items()}
    x = _rand(rng, (2, T_len, cfg.d_model))
    jc = tc = None
    if with_cache:
        c = {"conv": _rand(rng, (2, 3, cfg.d_inner + 2 * cfg.ssm_state)),
             "ssm": _rand(rng, (2, nh, cfg.ssm_head_dim, cfg.ssm_state))}
        jc = {k: jnp.asarray(v) for k, v in c.items()}
        tc = {k: torch.from_numpy(v) for k, v in c.items()}
    kw = dict(head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state)
    jy, jnew = jssm.mamba2_mix(jl, jnp.asarray(x), cache=jc, **kw)
    y, new = tssm.mamba2_mix(tl, torch.from_numpy(x), cache=tc, **kw)
    _close(y, jy, 1e-4)
    _close(new["ssm"], jnew["ssm"], 1e-4)
    _close(new["conv"], jnew["conv"], 1e-4)
    assert new["ssm"].dtype == torch.float32
    assert tuple(new["conv"].shape) == tuple(jnew["conv"].shape)


def test_ssd_chunked_equals_the_step_recurrence():
    """The chunked form against the port's own one-step recurrence, at a
    chunk of 4 over 11 steps (two whole chunks and a padded one)."""
    rng = np.random.default_rng(0)
    B, Tn, nh, hd, S = 2, 11, 3, 5, 4
    x, Bt, Ct = (torch.from_numpy(_rand(rng, s)) for s in
                 ((B, Tn, nh, hd), (B, Tn, S), (B, Tn, S)))
    dt = torch.from_numpy(np.abs(_rand(rng, (B, Tn, nh))))
    la = -dt * torch.from_numpy(np.abs(_rand(rng, (nh,))))
    h0 = torch.from_numpy(_rand(rng, (B, nh, hd, S)))
    y, h = tssm.ssd_chunked(x, Bt, Ct, la, dt, h0, chunk=4)
    hs, ys = h0, []
    for t in range(Tn):
        hs, yt = tssm.mamba2_step(hs, x[:, t], Bt[:, t], Ct[:, t], torch.exp(la[:, t]),
                                  dt[:, t])
        ys.append(yt)
    torch.testing.assert_close(y, torch.stack(ys, dim=1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hs, atol=1e-5, rtol=1e-5)


# -- trees and caches ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    jp = JT.init_params(j_get_arch(arch), jax.random.PRNGKey(0))
    p = T.init_params(get_arch(arch), seed=0, device="cpu")
    jflat = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)[6:])
            for k, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    assert flat == jflat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch, dtype):
    jcfg = dataclasses.replace(j_get_arch(arch), dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch), dtype=dtype)
    want = JT.init_cache(jcfg, 3, 24)
    got = T.init_cache(cfg, 3, 24, device="cpu")
    assert list(got) == list(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype)[6:] == str(want[key].dtype), key
        assert not bool(got[key].any()), key


def test_whisper_free_slot_past_max_seq_matches_reference(twins):
    """A free slot at max_seq: the reference reads its position embedding out
    of range (NaN) and drops its cache write; the port raises nothing, gives
    that slot the same NaN logits, and slot 0 the reference's logits."""
    jcfg, cfg, jp, p = twins("whisper-small-smoke")
    lengths = np.array([3, 16], np.int32)
    jc = dict(JT.init_cache(jcfg, 2, 16), lengths=jnp.asarray(lengths))
    tc = T.init_cache(cfg, 2, 16, device="cpu")
    tc["lengths"].copy_(torch.from_numpy(lengths))
    tok = np.array([5, 7], np.int32)
    jl, jnew = JT.decode_step(jp, jcfg, jc, jnp.asarray(tok))
    tl, tnew = T.decode_step(p, cfg, tc, torch.from_numpy(tok))
    _close(tl[0], jl[0], 2e-4)
    assert np.isnan(np.asarray(jl[1])).all() and bool(torch.isnan(tl[1]).all())
    for key in ("k", "v"):
        _close(tnew[key], jnew[key], 2e-4)
        assert not bool(torch.isnan(tnew[key]).any())
    np.testing.assert_array_equal(tnew["lengths"].numpy(), np.asarray(jnew["lengths"]))


# -- TD2 formats -----------------------------------------------------------------------


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "wq"))[0]:
        arrays = (leaf.wq, leaf.scales) if hasattr(leaf, "wq") else (leaf,)
        out[jax.tree_util.keystr(path)] = tuple(_np32(a) if isinstance(a, torch.Tensor)
                                                 else np.asarray(a) for a in arrays)
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert len(fa[k]) == len(fb[k]), k
        for x, y in zip(fa[k], fb[k]):
            assert x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def _save(mod, params, fmt, path):
    if fmt == "native":
        return mod.save_native(params, path)
    return mod.save_rsm(params, path, quantize=fmt == "rsm_int8")


def _load(mod, template, fmt, path, as_qtensor=False):
    kw = {} if mod is jfmt else {"device": "cpu"}
    if fmt == "native":
        return mod.load_native(template, path, **kw)
    return mod.load_rsm(template, path, as_qtensor=as_qtensor, **kw)


def _forward(mod, params, cfg, toks, frames):
    if mod is T:
        batch = {"tokens": torch.from_numpy(toks)}
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(frames)
        return T.forward(params, cfg, batch)["logits"].numpy()
    batch = {"tokens": jnp.asarray(toks)}
    if cfg.family == "audio":
        batch["frames"] = jnp.asarray(frames)
    return np.asarray(JT.forward(params, cfg, batch)["logits"])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_package_load(arch, fmt, twins, tmp_path):
    """Either package reads what the other wrote, leaf for leaf (rsm_int8
    dequantized on load, where both packages agree by design)."""
    _, _, jp, p = twins(arch)
    suffix = ".npz" if fmt == "native" else ""
    jdir, tdir = str(tmp_path / f"j{suffix}"), str(tmp_path / f"t{suffix}")
    assert _save(jfmt, jp, fmt, jdir) == _save(tfmt, p, fmt, tdir)
    want = _load(jfmt, jp, fmt, jdir)
    _assert_same(_load(tfmt, p, fmt, jdir), want)      # JAX wrote, port reads
    _assert_same(_load(jfmt, jp, fmt, tdir), want)     # port wrote, JAX reads
    if fmt != "native":
        for name in ("manifest.json", "tensors.bin"):
            assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()


@pytest.mark.parametrize("arch,changes,fenced", [
    ("zamba2-2.7b-smoke", {}, {"mamba_layers/in_proj", "mamba_layers/out_proj"}),
    ("zamba2-2.7b-smoke", {"num_layers": 16},     # 8 groups of 2
     {"group_gain", "mamba_layers/in_proj", "mamba_layers/out_proj",
      "mamba_layers/norm_w", "mamba_layers/gnorm_w", "mamba_layers/A_log",
      "mamba_layers/D_skip", "mamba_layers/dt_bias", "mamba_layers/conv_b"}),
    ("whisper-small-smoke", {}, set()),
    ("whisper-small-smoke", {"num_layers": 8, "encoder_layers": 8},
     {f"{stack}/{ln}" for stack in ("enc_layers", "dec_layers")
      for ln in ("ln1", "ln2")} | {"dec_layers/lnx"}),
])
def test_rsm_int8_fence(arch, changes, fenced, twins, tmp_path):
    """rsm_int8 written by the JAX package serves in the port: the leaves
    dense() consumes (attn, xattn, mlp) load as QTensor, every other quantized
    leaf (the Mamba2 leaves, group_gain, the stacked norms: the JAX package's
    QTensor path fails on them) loads dequantized; logits match the JAX
    package's dequantized load at 1e-4."""
    jcfg, cfg, jp, p = twins(arch, **changes)
    path = tmp_path / "q"
    jfmt.save_rsm(jp, str(path), quantize=True)
    manifest = json.loads((path / "manifest.json").read_text())["tensors"]
    quantized = {k for k, e in manifest.items() if e["quantized"]}
    assert fenced <= quantized
    served = tfmt.load_rsm(p, str(path), as_qtensor=True, device="cpu")
    flat = tfmt._flatten(served)
    for key in quantized:
        want_q = "/".join(key.split("/")[-2:]) in tfmt.MATMUL_LEAVES
        assert isinstance(flat[key], tfmt.QTensor) == want_q, key
        if not want_q:
            assert flat[key].dtype == getattr(torch, manifest[key]["orig_dtype"]), key
    assert any(isinstance(v, tfmt.QTensor) for v in flat.values())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    frames = _rand(rng, (2, cfg.encoder_seq, cfg.d_model))
    want = _forward(JT, jfmt.load_rsm(jp, str(path), as_qtensor=False), jcfg, toks, frames)
    np.testing.assert_allclose(_forward(T, served, cfg, toks, frames), want,
                               atol=1e-4, rtol=1e-4)
    _assert_same(tfmt.quantize_params(p), served)


# -- engines and continuous batching ----------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch, twins):
    """SI1 and SI2 (uncaptured on the CPU) give the JAX package's greedy
    tokens; whisper's engines feed the stub front end's zero frames."""
    jcfg, cfg, jp, p = twins(arch)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = jeng.CompiledEngine(jcfg, jp, max_seq=32).generate(prompt, 6).tokens
    for cls in (teng.EagerEngine, teng.CompiledEngine):
        got = cls(cfg, p, max_seq=32, device="cpu").generate(prompt, 6).tokens
        np.testing.assert_array_equal(got, want)


def _cb_tokens(sched_mod, engine, wl):
    m = sched_mod.make_scheduler("continuous_batch", engine, max_batch=4, timeout_ms=10.0,
                                 max_seq=32).run(wl)
    return {r.rid: np.asarray(r.tokens).tolist() for r in m.responses}


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batch_tokens_match_reference(arch, twins):
    """Slots insert and step the Mamba2 states (zamba2) and the cross caches
    (whisper); finished slots keep stepping past max_seq (to 46 of 32)."""
    jcfg, cfg, jp, p = twins(arch)
    wl = lambda gen: gen.poisson(5, 6, 20, cfg.vocab_size, rate_per_s=200, seed=2)  # noqa: E731
    want = _cb_tokens(jsched, jeng.CompiledEngine(jcfg, jp, max_seq=32), wl(jgen))
    got = _cb_tokens(tsched, teng.EagerEngine(cfg, p, 32, device="cpu"), wl(tgen))
    assert len(got) == 5 and got == want
