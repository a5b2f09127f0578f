"""Attention-free sequence mixer: RWKV6 ("Finch").

The counterpart of the RWKV6 half of the JAX package's ``models/ssm.py``
(Mamba2 comes with the hybrid family).  The time mix's projections run in
float32 with float32 weights, as there; its WKV recurrence runs through
``ops.rwkv6_scan`` (K5 on the GPU) for any T, so the prefill and every
decode step (T = 1) take the same kernel and the same state layout
(B, H, hd, hd) [key dim, value dim].  The channel mix stays in the model
dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers

_LORA_MIX = 32
_LORA_DECAY = 64


def rwkv6_layer_specs(d_model: int, d_ff: int, head_dim: int):
    """Leaf specs {name: (shape, init, scale)}; "full" fills with ``scale``."""
    D, A, A2 = d_model, _LORA_MIX, _LORA_DECAY
    H = D // head_dim
    s = D ** -0.5
    return {
        "ln1_w": ((D,), "ones", None), "ln1_b": ((D,), "zeros", None),
        "ln2_w": ((D,), "ones", None), "ln2_b": ((D,), "zeros", None),
        "tm": {
            "maa_x": ((D,), "zeros", None),
            "maa_wkvrg": ((5, D), "zeros", None),
            "maa_w1": ((D, 5 * A), "normal", s),
            "maa_w2": ((5, A, D), "normal", A ** -0.5),
            "decay_w0": ((D,), "full", -6.0),
            "decay_w1": ((D, A2), "normal", s),
            "decay_w2": ((A2, D), "normal", A2 ** -0.5),
            "u": ((H, head_dim), "normal", 0.5),
            "wr": ((D, D), "normal", s), "wk": ((D, D), "normal", s),
            "wv": ((D, D), "normal", s), "wg": ((D, D), "normal", s),
            "wo": ((D, D), "normal", s),
            "lnx_w": ((D,), "ones", None), "lnx_b": ((D,), "zeros", None),
        },
        "cm": {
            "maa_k": ((D,), "zeros", None), "maa_r": ((D,), "zeros", None),
            "wk": ((D, d_ff), "normal", s),
            "wv": ((d_ff, D), "normal", d_ff ** -0.5),
            "wr": ((D, D), "normal", s),
        },
    }


def _rwkv6_projections(tm, x, sx):
    """x, sx: (B, T, D) -> (r, k, v, g, w) each (B, T, D) f32 (w = decay)."""
    xf = x.float()
    sxf = sx.float()
    xxx = xf + sxf * tm["maa_x"].float()
    lora = torch.tanh(xxx @ tm["maa_w1"].float())
    B, T, _ = x.shape
    lora = lora.reshape(B, T, 5, _LORA_MIX)
    mix = torch.einsum("btsa,sad->btsd", lora, tm["maa_w2"].float())
    mixes = tm["maa_wkvrg"].float()[None, None] + mix  # (B,T,5,D)
    xw, xk, xv, xr, xg = [xf + sxf * mixes[:, :, i] for i in range(5)]
    # data-dependent decay in (0, 1) (the Finch contribution)
    w = torch.exp(-torch.exp(
        tm["decay_w0"].float()
        + torch.tanh(xw @ tm["decay_w1"].float()) @ tm["decay_w2"].float()))
    r = xr @ tm["wr"].float()
    k = xk @ tm["wk"].float()
    v = xv @ tm["wv"].float()
    g = F.silu(xg @ tm["wg"].float())
    return r, k, v, g, w


def rwkv6_wkv_step(state, r, k, v, w, u):
    """One recurrence step (the plain form the kernel is held to).

    state: (B, H, hd, hd) [key-dim, value-dim]; r/k/v/w: (B, H, hd); u: (H, hd).
    """
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("bhi,bhij->bhj", r, u[None, :, :, None] * kv + state)
    state = w[..., :, None] * state + kv
    return state, out


def _shifted(x, shift_prev):
    """sx = x shifted one step right (``shift_prev`` first) minus x."""
    B, T, D = x.shape
    prev = shift_prev if shift_prev is not None else x.new_zeros((B, D))
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1) - x


def rwkv6_time_mix(tm, x, head_dim: int, state=None, shift_prev=None, state_out=None):
    """x: (B,T,D). Returns (y, (wkv_state, last_x)).

    ``state_out``, if given, receives the final WKV state (it may be
    ``state`` itself: the decode cache, updated in place).
    """
    B, T, D = x.shape
    H = D // head_dim
    r, k, v, g, w = _rwkv6_projections(tm, x, _shifted(x, shift_prev))
    # (B, H, T, hd) views of the (B, T, D) projections: no copy
    rh, kh, vh, wh = (t.view(B, T, H, head_dim).transpose(1, 2) for t in (r, k, v, w))
    s0 = (state.float() if state is not None
          else torch.zeros((B, H, head_dim, head_dim), dtype=torch.float32, device=x.device))
    out, s_final = ops.rwkv6_scan(rh, kh, vh, wh, tm["u"].float(), s0, s_out=state_out)
    y = out.transpose(1, 2).reshape(B, T, D)  # (B,T,D) f32
    y = layers.group_norm_heads(y, tm["lnx_w"], tm["lnx_b"], H)
    y = (y.float() * g) @ tm["wo"].float()
    return y.to(x.dtype), (s_final, x[:, -1])


def rwkv6_channel_mix(cm, x, shift_prev=None):
    sx = _shifted(x, shift_prev)
    xk = x + sx * cm["maa_k"]
    xr = x + sx * cm["maa_r"]
    k = torch.square(F.relu(xk @ cm["wk"]))
    y = torch.sigmoid(xr @ cm["wr"]) * (k @ cm["wv"])
    return y.to(x.dtype), x[:, -1]


def rwkv6_block(p, x, head_dim: int, cache=None, state_out=None):
    """Full RWKV6 layer (time mix + channel mix). cache: dict or None.

    Returns (x, {"wkv", "tm_shift", "cm_shift"}); ``state_out`` as in
    ``rwkv6_time_mix``.
    """
    c = cache or {}
    h, (wkv_state, tm_shift) = rwkv6_time_mix(
        p["tm"], layers.layer_norm(x, p["ln1_w"], p["ln1_b"]), head_dim,
        state=c.get("wkv"), shift_prev=c.get("tm_shift"), state_out=state_out)
    x = x + h
    h, cm_shift = rwkv6_channel_mix(
        p["cm"], layers.layer_norm(x, p["ln2_w"], p["ln2_b"]),
        shift_prev=c.get("cm_shift"))
    x = x + h
    return x, {"wkv": wkv_state, "tm_shift": tm_shift, "cm_shift": cm_shift}
