"""Plain PyTorch versions of the kernels: what each CUDA kernel must compute.

The CPU path of every wrapper, and the oracle ``chip_smoke.py`` holds each
kernel against on the card.  The math is in float32, as in the JAX package's
``kernels/ref.py``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B, H, Sq, dh); k/v: (B, K, T, dh)."""
    B, H, Sq, dh = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, K, G, Sq, dh) * dh ** -0.5
    s = torch.einsum("bkgqd,bktd->bkgqt", qf, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((Sq, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, dh).to(q.dtype)


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
