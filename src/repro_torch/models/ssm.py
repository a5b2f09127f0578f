"""Attention-free sequence mixers: RWKV6 ("Finch") and Mamba2 (SSD).

The counterpart of the JAX package's ``models/ssm.py``.

RWKV6: the time mix's projections run in float32 with float32 weights, as
there; its WKV recurrence runs through ``ops.rwkv6_scan`` (K5 on the GPU)
for any T, so the prefill and every decode step (T = 1) take the same kernel
and the same state layout (B, H, hd, hd) [key dim, value dim].  The channel
mix stays in the model dtype.  Under autograd the recurrence goes through
``Rwkv6Scan``: its forward keeps the state entering every 16 steps, and its
backward is ``ops.rwkv6_scan_bwd`` (K5's backward kernel on the GPU, the
reverse scan written out on the CPU), the counterpart of the JAX package's
autodiff of its ``lax.scan``.

Mamba2 (zamba2's backbone): the JAX package steps its recurrence with
``lax.scan`` over T and has no Pallas kernel for it.  Here a decode step
(T = 1) takes the one-step recurrence, and a prompt (T > 1) the same
recurrence in its chunked (SSD) form, in float32: within a chunk of 64 steps
the decays are cumulative sums of log-decays and the outputs one masked
product; between chunks one state is carried.  A step loop would launch a
few kernels for each of T steps of each layer.  Both forms return the
reference's (conv, ssm) state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import checkpoint_shape
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


class Rwkv6Scan(torch.autograd.Function):
    """The WKV recurrence of (B, H, T, hd) r/k/v/w, differentiated by the
    reverse scan: it saves the inputs and the state entering every 16 steps
    (no (T, hd, hd) residual), and returns (dr, dk, dv, dw) in the (B, T, H,
    hd) memory the projections' views expect.  float32 only, as the model
    feeds it."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        if any(t.dtype != torch.float32 for t in (r, k, v, w)):
            raise ValueError("Rwkv6Scan: the WKV scan trains in float32 (the model "
                             f"feeds it float32); got {r.dtype}")
        ctx.set_materialize_grads(False)
        # the card's backward recomputes each chunk from these; the CPU's from
        # s0.  Shaped from s0 (B, H, hd, hd) f32, so a DTensor keeps its shards
        n = checkpoint_shape(*r.shape)[2]
        ckpt = (torch.empty_like(s0[:, :, None].expand(-1, -1, n, -1, -1))
                if r.device.type == "cuda" or ops.is_fake(r) else None)
        out, s_final = ops.rwkv6_scan(r, k, v, w, u, s0, checkpoints=ckpt)
        ctx.save_for_backward(r, k, v, w, u, s0, ckpt)
        return out, s_final

    @staticmethod
    def backward(ctx, dout, ds_final):
        r, k, v, w, u, s0, ckpt = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(r)
        return ops.rwkv6_scan_bwd(r, k, v, w, u, s0, dout, ds_final, checkpoints=ckpt)


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
    u = tm["u"].float()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (rh, kh, vh, wh, u, s0)):
        out, s_final = Rwkv6Scan.apply(rh, kh, vh, wh, u, s0)
        if state_out is not None:   # the copy keeps the state's gradient
            s_final = state_out.copy_(s_final)
    else:
        out, s_final = ops.rwkv6_scan(rh, kh, vh, wh, u, s0, s_out=state_out)
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


# =============================================================================
# Mamba2 (SSD, scalar-identity A per head), used by zamba2
# =============================================================================

CONV_WIDTH = 4
SSD_CHUNK = 64


def mamba2_layer_specs(d_model: int, d_inner: int, ssm_state: int, head_dim: int):
    """Leaf specs {name: (shape, init, scale[, dtype])} of one Mamba2 layer."""
    nh = d_inner // head_dim
    S = ssm_state
    conv_dim = d_inner + 2 * S
    f32 = torch.float32
    return {
        "norm_w": ((d_model,), "ones", None),
        "in_proj": ((d_model, 2 * d_inner + 2 * S + nh), "normal", d_model ** -0.5),
        "conv_w": ((CONV_WIDTH, conv_dim), "normal", 0.2),
        "conv_b": ((conv_dim,), "zeros", None),
        "A_log": ((nh,), "zeros", None, f32),
        "D_skip": ((nh,), "ones", None, f32),
        "dt_bias": ((nh,), "zeros", None, f32),
        "gnorm_w": ((d_inner,), "ones", None),
        "out_proj": ((d_inner, d_model), "normal", d_inner ** -0.5),
    }


def _causal_depthwise_conv(x, w, b, conv_state=None):
    """x: (B,T,C), w: (W,C). Returns (y (B,T,C), new_state (B,W-1,C))."""
    W = w.shape[0]
    B, T, C = x.shape
    prev = (conv_state.to(x.dtype) if conv_state is not None
            else x.new_zeros((B, W - 1, C)))
    xp = torch.cat([prev, x], dim=1)  # (B, T+W-1, C)
    y = sum(xp[:, i: i + T] * w[i] for i in range(W)) + b
    return F.silu(y), xp[:, -(W - 1):]


def mamba2_step(h, x, B_t, C_t, decay, dt):
    """One recurrence step (the reference's scan body), float32.

    h: (B, nh, hd, S); x: (B, nh, hd); B_t, C_t: (B, S); decay, dt: (B, nh).
    Returns (h, y (B, nh, hd)).
    """
    h = decay[..., None, None] * h + (dt[..., None] * x)[..., None] * B_t[:, None, None, :]
    return h, torch.einsum("bnds,bs->bnd", h, C_t)


def ssd_chunked(x, B_t, C_t, log_decay, dt, h0, chunk: int = SSD_CHUNK):
    """The recurrence of ``mamba2_step`` over T steps in its chunked form.

    x: (B, T, nh, hd); B_t, C_t: (B, T, S); log_decay (A * dt) and dt:
    (B, T, nh); h0: (B, nh, hd, S); all float32.  Returns (y (B, T, nh, hd),
    h_final).  T is padded to a multiple of ``chunk`` with steps of no decay
    and no input, which carry the state through unchanged.  Heads lead the
    steps in every (B, chunks, nh, chunk, chunk) tensor, so the elementwise
    passes over them run on contiguous rows and the products are batched
    matmuls with no transposed copy.
    """
    Bsz, T, nh, hd = x.shape
    S = B_t.shape[-1]
    pad = (-T) % chunk
    xdt = x * dt[..., None]
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        B_t, C_t = (F.pad(t, (0, 0, 0, pad)) for t in (B_t, C_t))
        log_decay = F.pad(log_decay, (0, 0, 0, pad))
    nc, L = (T + pad) // chunk, chunk
    xdt = xdt.view(Bsz, nc, L, nh, hd).transpose(2, 3)             # (B, nc, nh, L, hd)
    Bc, Cc = B_t.view(Bsz, nc, 1, L, S), C_t.view(Bsz, nc, 1, L, S)
    cum = torch.cumsum(log_decay.view(Bsz, nc, L, nh).transpose(2, 3), dim=-1)  # (B, nc, nh, L)
    # decay from step u to step t, exp(cum_t - cum_u) for u <= t; the upper
    # triangle is -inf before the exp, so nothing there can overflow
    w = cum[..., :, None] - cum[..., None, :]                       # (B, nc, nh, t, u)
    upper = torch.ones(L, L, dtype=torch.bool, device=x.device).triu(1)
    w = w.masked_fill_(upper, float("-inf")).exp_()
    cb = Cc @ Bc.transpose(-1, -2)
    # in place when nothing differentiates through w (serving); under
    # autograd exp's output is kept for its backward
    w = w * cb if w.requires_grad else w.mul_(cb)
    y = w @ xdt                                                     # within the chunk
    # each chunk's own contribution to the state at its end
    to_end = torch.exp(cum[..., -1:] - cum)                         # (B, nc, nh, L)
    states = (xdt * to_end[..., None]).transpose(-1, -2) @ Bc      # (B, nc, nh, hd, S)
    chunk_decay = torch.exp(cum[..., -1])                           # (B, nc, nh)
    h = h0
    h_in = []
    for c in range(nc):  # the state entering each chunk
        h_in.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                                 # (B, nc, nh, hd, S)
    y = y + (Cc @ h_in.transpose(-1, -2)) * torch.exp(cum)[..., None]
    return y.transpose(2, 3).reshape(Bsz, nc * L, nh, hd)[:, :T], h


def mamba2_mix(p, x, *, head_dim: int, ssm_state: int, cache=None):
    """x: (B,T,D). Returns (y, {"conv": (B, 3, C), "ssm": (B, nh, hd, S) f32})."""
    B, T, D = x.shape
    c = cache or {}
    zxbcdt = x @ p["in_proj"]
    d_inner = p["out_proj"].shape[0]
    nh = d_inner // head_dim
    S = ssm_state
    z, xBC, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * S, nh], dim=-1)
    xBC, conv_state = _causal_depthwise_conv(xBC, p["conv_w"], p["conv_b"], c.get("conv"))
    xs, Bs, Cs = torch.split(xBC, [d_inner, S, S], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                     # (B,T,nh)
    A = -torch.exp(p["A_log"].float())                             # (nh,)
    xh = xs.float().reshape(B, T, nh, head_dim)
    h0 = (c["ssm"].float() if c.get("ssm") is not None
          else torch.zeros((B, nh, head_dim, S), dtype=torch.float32, device=x.device))
    if T == 1:
        h, y = mamba2_step(h0, xh[:, 0], Bs[:, 0].float(), Cs[:, 0].float(),
                           torch.exp(A * dt[:, 0]), dt[:, 0])
        y = y[:, None]
    else:
        y, h = ssd_chunked(xh, Bs.float(), Cs.float(), A * dt, dt, h0)
    y = y + p["D_skip"][:, None] * xh                              # (B,T,nh,hd)
    y = y.reshape(B, T, d_inner)
    y = layers.rms_norm(y * F.silu(z.float()), p["gnorm_w"])
    y = y.to(x.dtype) @ p["out_proj"]
    return y, {"conv": conv_state, "ssm": h}


def mamba2_block(p, x, *, head_dim: int, ssm_state: int, cache=None):
    h, new_cache = mamba2_mix(p, layers.rms_norm(x, p["norm_w"]), head_dim=head_dim,
                              ssm_state=ssm_state, cache=cache)
    return x + h, new_cache
