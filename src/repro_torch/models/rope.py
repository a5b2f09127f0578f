"""Rotary position embeddings: standard RoPE + multimodal M-RoPE (qwen2-vl)."""

from __future__ import annotations

import torch


def _inv_freq(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> angles (..., S, head_dim//2) f32."""
    inv = _inv_freq(head_dim, theta, positions.device)
    return positions.float()[..., None] * inv


def mrope_angles(positions, head_dim: int, theta: float, sections):
    """positions: (3, B, S) (t/h/w ids) -> (B, S, head_dim//2).

    M-RoPE (qwen2-vl): the rotary frequency axis is split into three sections;
    each section takes its position id from the matching component (temporal /
    height / width). Text tokens carry identical t==h==w ids, reducing to RoPE.
    Each section is sliced from its component's angles, which equals the JAX
    package's one-hot contraction exactly and needs no index tensor copied to
    the device (so a CUDA graph can capture it).
    """
    if positions.shape[0] != 3:
        raise ValueError(f"mrope positions must be (3, B, S), got {tuple(positions.shape)}")
    inv = _inv_freq(head_dim, theta, positions.device)  # (hd/2,)
    if sum(sections) != inv.shape[0]:
        raise ValueError(f"mrope sections {sections} do not sum to {inv.shape[0]}")
    ang = positions.float()[..., None] * inv  # (3, B, S, hd/2)
    parts, start = [], 0
    for comp, n in enumerate(sections):
        parts.append(ang[comp, ..., start:start + n])
        start += n
    return torch.cat(parts, dim=-1)


def apply_rotary(x, angles):
    """x: (B, S, H, dh), angles: (B, S, dh//2) -> rotated x (same dtype)."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def positions_default(batch: int, seq: int, offset=0, device=None):
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(batch, seq)
