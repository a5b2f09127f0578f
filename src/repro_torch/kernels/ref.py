"""Plain PyTorch versions of the kernels: what each CUDA kernel must compute.

The CPU path of every wrapper, and the oracle ``chip_smoke.py`` holds each
kernel against on the card.  The math is in float32, as in the JAX package's
``kernels/ref.py``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _flash_mask(Sq: int, T: int, causal: bool, window, device):
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((Sq, T), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=None, return_lse=False):
    """q: (B, H, Sq, dh); k/v: (B, K, T, dh).

    With ``return_lse`` also the row log-sum-exp of the scaled, masked
    scores in float32, (B, H, Sq): what the backward reads.  It equals the
    JAX package's ``m + log(max(l, 1e-20))`` (``models/attention.py``); a
    row with every key masked gets -1e30 from both.
    """
    B, H, Sq, dh = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, K, G, Sq, dh) * dh ** -0.5
    s = torch.einsum("bkgqd,bktd->bkgqt", qf, k.float())
    s = torch.where(_flash_mask(Sq, T, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    o = o.reshape(B, H, Sq, dh).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=None):
    """The gradients of ``flash_attention_ref`` from its output and lse.

    q, o, do: (B, H, Sq, dh); k, v: (B, K, T, dh); lse: (B, H, Sq) f32.
    Returns (dq, dk, dv) in q's, k's and v's dtypes; dk and dv sum over the
    G query heads of each kv head.  The arithmetic of the JAX package's
    ``_attention_bwd_rule``: delta = sum(do * o), p = exp(s - lse) masked,
    dv = p^T do, ds = p (dp - delta) scale, dq = ds k, dk = ds^T q.
    """
    B, H, Sq, dh = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    scale = dh ** -0.5
    qf = q.float().reshape(B, K, G, Sq, dh)
    dof = do.float().reshape(B, K, G, Sq, dh)
    delta = torch.sum(dof * o.float().reshape(B, K, G, Sq, dh), dim=-1)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qf * scale, kf)
    mask = _flash_mask(Sq, T, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, K, G, Sq)[..., None]), 0.0)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, dof)
    dp = torch.einsum("bkgqd,bktd->bkgqt", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf)
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qf)
    return (dq.reshape(B, H, Sq, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def decode_attention_ref(q, k_cache, v_cache, lengths, *, window=None):
    """q: (B, K, G, dh); caches: (B, K, S, dh); lengths: (B,)."""
    B, K, G, dh = q.shape
    S = k_cache.shape[2]
    qf = q.float() * dh ** -0.5
    s = torch.einsum("bkgd,bktd->bkgt", qf, k_cache.float())
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = k_pos < lengths[:, None]
    if window is not None:
        mask &= k_pos > (lengths[:, None] - 1 - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v_cache.float())
    return o.to(q.dtype)


def int8_matmul_ref(x, w_q, scales):
    out = x.float() @ w_q.float()
    return (out * scales[None, :]).to(x.dtype)


def moe_gmm_ref(x, w, group_sizes=None):
    """x: (E, C, D); w: (E, D, F); rows >= group_sizes[e] count as zero."""
    xf = x.float()
    if group_sizes is not None:
        C = x.shape[1]
        rows = torch.arange(C, device=x.device)[None, :, None]
        xf = torch.where(rows < group_sizes[:, None, None], xf, 0.0)
    return torch.einsum("ecd,edf->ecf", xf, w.float()).to(x.dtype)


def rwkv6_scan_ref(r, k, v, w, u, s0):
    """r/k/v/w: (B, H, T, dh); u: (H, dh); s0: (B, H, dh, dh).

    Returns (out (B, H, T, dh) in r's dtype, s_final (B, H, dh, dh) f32),
    stepping the recurrence of the JAX package's ``rwkv6_wkv_step``.
    """
    uf = u.float()
    s = s0.float()
    outs = []
    for t in range(r.shape[2]):
        r_, k_, v_, w_ = (a[:, :, t].float() for a in (r, k, v, w))
        kv = k_[..., :, None] * v_[..., None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r_, uf[None, :, :, None] * kv + s))
        s = w_[..., :, None] * s + kv
    return torch.stack(outs, dim=2).to(r.dtype), s
