"""The port's attention backward against the JAX package's custom VJP.

The same numpy q, k, v go through ``repro.models.attention.attention``
(its flash backward, ``_attention_bwd_rule``) and the port's ``attention``
(``FlashAttention``: ``ops.flash_attention(return_lse=True)`` forward and
``ops.flash_attention_bwd`` backward, their plain versions on the CPU), in
float32.  Tolerance: atol 3e-4, rtol 3e-3, the reference's own
``test_attention_grad.py`` bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention_bwd as k1b
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn


def _qkv(seed, B, Sq, T, H, K, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, dh), (B, T, K, dh), (B, T, K, dh))]


@pytest.mark.parametrize("B,Sq,T,H,K,dh,kwargs", [
    (2, 24, 24, 4, 2, 16, dict(causal=True)),
    (2, 24, 24, 4, 2, 16, dict(causal=True, window=7)),
    (2, 24, 24, 4, 2, 16, dict(causal=False)),
    (2, 10, 33, 3, 3, 16, dict(causal=False)),       # Sq != T (cross attention), G 1
    (1, 20, 20, 6, 2, 80, dict(causal=True)),        # G 3, dh 80
    (1, 20, 20, 3, 3, 80, dict(causal=True, window=7)),
], ids=["causal", "window7", "noncausal", "cross_g1", "g3_dh80", "g1_dh80_window7"])
def test_attention_grads_match_the_reference_vjp(B, Sq, T, H, K, dh, kwargs):
    q, k, v = _qkv(0, B, Sq, T, H, K, dh)
    w = np.random.default_rng(1).standard_normal((B, Sq, H, dh)).astype(np.float32)

    def f(q, k, v):
        return (jattn.attention(q, k, v, block_kv=8, **kwargs) * w).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    n = ops.launch_counts()
    out = tattn.attention(*ts, **kwargs)
    (out * torch.from_numpy(w)).sum().backward()
    for t, j in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=3e-4, rtol=3e-3)
    # the forward value is the serving path's
    with torch.no_grad():
        np.testing.assert_allclose(out.detach().numpy(),
                                   tattn.attention(*ts, **kwargs).numpy(), atol=1e-5)
    # the CPU runs the plain versions: no kernel launched
    assert ops.launch_counts() == n


def test_function_saves_no_quadratic_residual():
    """The backward keeps (q, k, v, out, lse): nothing (Sq, T)-shaped."""
    B, S, H, K, dh = 1, 256, 2, 2, 16
    ts = [torch.from_numpy(a).requires_grad_() for a in _qkv(2, B, S, S, H, K, dh)]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tattn.attention(*ts, causal=True)
    assert sorted(saved) == sorted([(B, S, H, dh), (B, S, K, dh), (B, S, K, dh),
                                    (B, S, H, dh), (B, H, S)])
    assert all(S * S not in (np.prod(s[-2:]), np.prod(s)) for s in saved)
    out.sum().backward()
    assert all(t.grad is not None for t in ts)


def test_lse_matches_the_reference_forward():
    """ops.flash_attention(return_lse=True) gives the JAX package's
    m + log(max(l, 1e-20)), reshaped from (B, Sq, K, G) to (B, H, Sq)."""
    B, Sq, T, H, K, dh = 2, 12, 12, 6, 2, 16
    q, k, v = _qkv(3, B, Sq, T, H, K, dh)
    for kwargs in (dict(causal=True), dict(causal=True, window=5), dict(causal=False)):
        j_out, j_lse = jattn._attention_fwd_core(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, None,
            kwargs["causal"], kwargs.get("window"), 8, has_kv_len=False)
        out, lse = ops.flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                                         for a in (q, k, v)), return_lse=True, **kwargs)
        np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(j_out), atol=1e-5)
        want = np.asarray(j_lse).reshape(B, Sq, H).transpose(0, 2, 1)
        np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)
        # the port's own chunked forward keeps the reference's lse as well
        _, t_lse = tattn._attention_fwd_core(*(torch.from_numpy(a) for a in (q, k, v)),
                                             0, None, kwargs["causal"], kwargs.get("window"), 8)
        np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5, rtol=1e-5)


def test_bwd_plain_version_matches_autograd_and_zeroes_masked_rows():
    """flash_attention_bwd_ref equals autograd through flash_attention_ref,
    and a row whose keys are all masked (lse -1e30) gets zeros, not NaN."""
    B, Sq, T, H, K, dh = 1, 9, 9, 4, 2, 32
    q, k, v = (torch.from_numpy(a).transpose(1, 2).contiguous()
               for a in _qkv(4, B, Sq, T, H, K, dh))
    do = torch.randn(B, H, Sq, dh, generator=torch.Generator().manual_seed(0))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = ref.flash_attention_ref(qr, kr, vr, causal=True, window=3, return_lse=True)
    want = torch.autograd.grad(o, (qr, kr, vr), do)
    got = ref.flash_attention_bwd_ref(q, k, v, o.detach(), lse.detach(), do, causal=True,
                                      window=3)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    # non-causal, window 1, Sq > T: rows 9.. see no key
    q2 = torch.cat([q, q[:, :, :3]], dim=2)
    do2 = torch.cat([do, do[:, :, :3]], dim=2)
    o2, lse2 = ref.flash_attention_ref(q2, k, v, causal=False, window=1, return_lse=True)
    assert torch.all(lse2[..., 9:] == ref.NEG_INF)
    dq, dk, dv = ref.flash_attention_bwd_ref(q2, k, v, o2, lse2, do2, causal=False, window=1)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert not dq[:, :, 9:].abs().sum() and dq[:, :, :9].abs().sum() > 0


def test_attention_under_no_grad_and_offsets():
    """Serving calls (no_grad, q_offset, kv_lengths) keep the chunked forward;
    a differentiable call with an offset is refused, not silently wrong."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 2, 4, 12, 4, 2, 16))
    with torch.no_grad():
        out = tattn.attention(q, k, v, q_offset=8, kv_lengths=torch.tensor([12, 9]))
    want = tattn.attention_reference(q, k, v, q_offset=8, kv_lengths=torch.tensor([12, 9]))
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="q_offset=0"):
        tattn.attention(q.requires_grad_(), k, v, q_offset=8)


def _split_dq(q, k, v, o, lse, do, causal, window, p):
    """The mma path's dq pass split over the kv range (csrc/flash_attention_bwd.cu,
    ``attn_bwd_mma_dq`` then ``attn_bwd_dq_reduce``) in plain PyTorch: delta
    once from the whole rows, every split's partial dq over its chunk of keys
    alone, then the partials summed in split order."""
    B, H, Sq, dh = q.shape
    K, T = k.shape[1], k.shape[2]
    G, scale = H // K, dh ** -0.5
    kf, vf = (t.repeat_interleave(G, dim=1) for t in (k, v))
    delta = (do * o).sum(-1, keepdim=True)
    mask = ref._flash_mask(Sq, T, causal, window, q.device)
    dq = torch.zeros_like(q)
    for s in range(p.splits):
        span = slice(s * p.chunk, min(T, (s + 1) * p.chunk))
        sc = torch.einsum("bhqd,bhtd->bhqt", q * scale, kf[:, :, span])
        pr = torch.where(mask[:, span], torch.exp(sc - lse[..., None]), 0.0)
        dp = torch.einsum("bhqd,bhtd->bhqt", do, vf[:, :, span])
        dq = dq + torch.einsum("bhqt,bhtd->bhqd", pr * (dp - delta) * scale, kf[:, :, span])
    return dq


@pytest.mark.parametrize("B,Sq,T,H,K,dh,kwargs", [
    (1, 8, 300, 2, 2, 16, dict(causal=False)),          # Sq << T: whisper's cross shape
    (1, 200, 200, 4, 2, 16, dict(causal=True)),
    (1, 150, 150, 2, 1, 32, dict(causal=True, window=70)),
], ids=["cross", "causal", "causal_window70"])
def test_split_dq_model_matches_the_reference_vjp(B, Sq, T, H, K, dh, kwargs):
    """dq from the split-and-reduce model at the plan's splits (every one of
    them more than one) equals the JAX package's VJP of its attention, in f32."""
    p = k1b.dq_plan(B, H, Sq, T, 132)
    assert p.splits > 1
    q, k, v = _qkv(6, B, Sq, T, H, K, dh)
    w = np.random.default_rng(7).standard_normal((B, Sq, H, dh)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jattn.attention(q, k, v, block_kv=8, **kwargs),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(w))[0]
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, w))
    o, lse = ref.flash_attention_ref(qt, kt, vt, return_lse=True, **kwargs)
    got = _split_dq(qt, kt, vt, o, lse, dot, kwargs["causal"], kwargs.get("window"), p)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), atol=3e-4,
                               rtol=3e-3)
