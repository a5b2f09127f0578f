"""GQA attention, forward only: the hand-written kernels on the GPU, and the
JAX package's chunked online softmax as plain PyTorch on the CPU.

Layouts:
  q        (B, Sq, H, dh)
  k, v     (B, T,  K, dh)        K = kv heads, H = K * G

On CUDA, ``attention`` with ``q_offset == 0`` and no ``kv_lengths`` -- every
prefill call of the model -- runs the flash kernel (K1), and
``decode_attention`` runs the decode kernel (K2).  Both kernels read these
layouts in place by stride.  Other ``attention`` arguments on CUDA raise
``NotImplementedError``: no caller on the serving path makes them.  The
custom backward of the JAX package comes with training.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _pad_to(x, mult: int, dim: int):
    n = x.shape[dim]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim), n


def _q_positions(q_offset, Sq: int, device):
    q_pos = torch.arange(Sq, dtype=torch.int32, device=device)[None, :]  # (1, Sq)
    if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
        return q_pos + q_offset.to(torch.int32)[:, None]                # (B, Sq)
    return q_pos + q_offset


def _mask_for(q_pos, k_pos, kv_len, nk, causal, window):
    """q_pos: (B?, Sq); k_pos: (bk,); kv_len: (B,) or None -> (B?, Sq, bk) bool."""
    mask = (k_pos < nk)[None, None, :]
    if kv_len is not None:
        mask = mask & (k_pos[None, :] < kv_len.to(torch.int32)[:, None])[:, None, :]
    qp = q_pos[:, :, None]
    kp = k_pos[None, None, :]
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    return mask


def attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset=0,
    kv_lengths=None,
    block_kv: int = 512,
):
    """Flash attention over (B, Sq, H, dh) queries and (B, T, K, dh) keys/values.

    q_offset: position of q[0] within the kv timeline (int or (B,) tensor).
    kv_lengths: optional (B,) valid kv lengths (positions >= length masked).
    window: sliding window width (attend to kv in (q_pos-window, q_pos]).
    """
    if q.is_cuda:
        if not (isinstance(q_offset, int) and q_offset == 0 and kv_lengths is None):
            raise NotImplementedError(
                "attention on CUDA runs the prefill kernel: q_offset=0 and no "
                "kv_lengths")
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal, window=window)
        return o.transpose(1, 2)
    return _attention_fwd_core(q, k, v, q_offset, kv_lengths, causal, window,
                               block_kv)


def _attention_fwd_core(q, k, v, q_offset, kv_lengths, causal, window, block_kv):
    """The chunked online-softmax forward of the JAX package, block by block."""
    B, Sq, H, dh = q.shape
    _, T, K, _ = k.shape
    G = H // K
    out_dtype = q.dtype
    scale = dh ** -0.5

    # contract in the cache dtype with f32 accumulation, as the JAX package
    qf = (q.float() * scale).reshape(B, Sq, K, G, dh).to(k.dtype).float()
    k, nk = _pad_to(k, block_kv, dim=1)
    v, _ = _pad_to(v, block_kv, dim=1)
    nblk = k.shape[1] // block_kv
    q_pos = _q_positions(q_offset, Sq, q.device)

    m = torch.full((B, Sq, K, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, K, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, K, G, dh), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        kblk = k[:, i * block_kv:(i + 1) * block_kv]
        vblk = v[:, i * block_kv:(i + 1) * block_kv]
        k_pos = i * block_kv + torch.arange(block_kv, dtype=torch.int32, device=q.device)
        s = torch.einsum("bqkgd,btkd->bqkgt", qf, kblk.float())
        mask = _mask_for(q_pos, k_pos, kv_lengths, nk, causal, window)
        mask = mask[:, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgt,btkd->bqkgd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(B, Sq, H, dh).to(out_dtype)


def attention_reference(q, k, v, *, causal=True, window=None, q_offset=0,
                        kv_lengths=None):
    """O(S^2)-memory oracle for tests."""
    B, Sq, H, dh = q.shape
    _, T, K, _ = k.shape
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, dh) * dh ** -0.5
    s = torch.einsum("bqkgd,btkd->bqkgt", qf, k.float())
    q_pos = _q_positions(q_offset, Sq, q.device)
    k_pos = torch.arange(T, device=q.device)
    if causal:
        mask = k_pos[None, None, :] <= q_pos[:, :, None]
    else:
        mask = torch.ones((1, Sq, T), dtype=torch.bool, device=q.device)
    if window is not None:
        mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    if kv_lengths is not None:
        mask = mask & (k_pos[None, None, :] < kv_lengths[:, None, None])
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgt,btkd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def decode_attention(
    q,
    k_cache,
    v_cache,
    lengths,
    *,
    window: Optional[int] = None,
    block_kv: int = 1024,  # kept for API compat; neither path uses it
):
    """Single-token attention over a KV cache.

    q: (B, H, dh); k_cache/v_cache: (B, S, K, dh); lengths: (B,) int32 --
    number of valid cache entries INCLUDING the current token's kv (already
    written).  On CUDA the decode kernel reads the cache in place; on the CPU
    the JAX package's direct (non-chunked) softmax runs, contracting in the
    cache dtype with f32 accumulation.
    """
    B, H, dh = q.shape
    S = k_cache.shape[1]
    K = k_cache.shape[2]
    G = H // K
    if q.is_cuda:
        o = ops.decode_attention(q.reshape(B, K, G, dh), k_cache.transpose(1, 2),
                                 v_cache.transpose(1, 2), lengths, window=window)
        return o.reshape(B, H, dh)
    scale = dh ** -0.5
    qf = (q.float() * scale).to(k_cache.dtype).float().reshape(B, K, G, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qf, k_cache.float())  # (B, K, G, S)
    k_pos = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    mask = k_pos < lengths.to(torch.int32)[:, None]
    if window is not None:
        mask = mask & (k_pos > (lengths.to(torch.int32)[:, None] - 1 - window))
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask[:, None, None, :], torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgt,btkd->bkgd",
                     (p / torch.clamp(l, min=1e-20)).to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, H, dh).to(q.dtype)
