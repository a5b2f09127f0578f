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


def moe_gmm_bwd_ref(x, w, group_sizes, dy):
    """The gradients of ``moe_gmm_ref`` from dy (E, C, F): (dx (E, C, D),
    dw (E, D, F)) in x's and w's dtypes, the formulas written out in
    float32: dx[e] = dy[e] w[e]^T with rows at or past group_sizes[e] zero,
    dw[e] = x~[e]^T dy[e] with x~ = x with those rows zeroed."""
    xf, dyf = x.float(), dy.float()
    dx = torch.einsum("ecf,edf->ecd", dyf, w.float())
    if group_sizes is not None:
        rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
        live = rows < group_sizes[:, None, None]
        xf = torch.where(live, xf, 0.0)
        dx = torch.where(live, dx, 0.0)
    dw = torch.einsum("ecd,ecf->edf", xf, dyf)
    return dx.to(x.dtype), dw.to(w.dtype)


WKV_CHECKPOINT_EVERY = 16   # steps between K5's state checkpoints (csrc/rwkv6_scan.cu CHUNK)


def rwkv6_scan_ref(r, k, v, w, u, s0, checkpoints=None):
    """r/k/v/w: (B, H, T, dh); u: (H, dh); s0: (B, H, dh, dh).

    Returns (out (B, H, T, dh) in r's dtype, s_final (B, H, dh, dh) f32),
    stepping the recurrence of the JAX package's ``rwkv6_wkv_step``.
    ``checkpoints``, if given ((B, H, ceil(T / WKV_CHECKPOINT_EVERY), dh,
    dh) f32), receives the state entering every chunk of
    WKV_CHECKPOINT_EVERY steps.
    """
    every = WKV_CHECKPOINT_EVERY
    uf = u.float()
    s = s0.float()
    outs = []
    for t in range(r.shape[2]):
        if checkpoints is not None and t % every == 0:
            checkpoints[:, :, t // every] = s
        r_, k_, v_, w_ = (a[:, :, t].float() for a in (r, k, v, w))
        kv = k_[..., :, None] * v_[..., None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r_, uf[None, :, :, None] * kv + s))
        s = w_[..., :, None] * s + kv
    return torch.stack(outs, dim=2).to(r.dtype), s


def rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dout, ds_final=None):
    """The gradients of ``rwkv6_scan_ref`` from dout (B, H, T, dh) and the
    final state's ds_final (B, H, dh, dh) or None (zero): (dr, dk, dv, dw in
    r's dtype, du (H, dh) in u's, ds0 (B, H, dh, dh) f32).

    The formulas written out in float32: the states S_t entering each step
    are recomputed forward, then with dS from ds_final, from t = T-1 down:
    dr_t = u k_t (v_t . dout_t) + S_t dout_t;  dk_t = r_t u (v_t . dout_t)
    + dS v_t;  dv_t = (r_t . u k_t) dout_t + dS^T k_t;  dw_t = rowsum(dS *
    S_t);  du += sum_b r_t k_t (v_t . dout_t);  dS <- w_t dS + r_t dout_t^T.
    """
    uf = u.float()
    s = s0.float()
    states = []
    for t in range(r.shape[2]):
        states.append(s)
        k_, v_, w_ = (a[:, :, t].float() for a in (k, v, w))
        s = w_[..., :, None] * s + k_[..., :, None] * v_[..., None, :]
    dS = torch.zeros_like(s) if ds_final is None else ds_final.float()
    grads = {n: [] for n in ("r", "k", "v", "w")}
    du = torch.zeros_like(uf)
    for t in reversed(range(r.shape[2])):
        r_, k_, v_, w_, do = (a[:, :, t].float() for a in (r, k, v, w, dout))
        st = states[t]
        vdo = (v_ * do).sum(-1, keepdim=True)
        grads["r"].append(uf * k_ * vdo + torch.einsum("bhij,bhj->bhi", st, do))
        grads["k"].append(r_ * uf * vdo + torch.einsum("bhij,bhj->bhi", dS, v_))
        grads["v"].append((r_ * uf * k_).sum(-1, keepdim=True) * do
                          + torch.einsum("bhij,bhi->bhj", dS, k_))
        grads["w"].append((dS * st).sum(-1))
        du = du + (r_ * k_ * vdo).sum(0)
        dS = w_[..., :, None] * dS + r_[..., :, None] * do[..., None, :]
    dr, dk, dv, dw = (torch.stack(grads[n][::-1], dim=2).to(r.dtype) if grads[n]
                      else torch.zeros_like(r) for n in ("r", "k", "v", "w"))
    return dr, dk, dv, dw, du.to(u.dtype), dS
