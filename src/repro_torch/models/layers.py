"""Core layers: norms, MLP variants, embeddings. Plain functions on tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, weight, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight).to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dtype)


def group_norm_heads(x, weight, bias, num_heads: int, eps: float = 1e-5):
    """Per-head group norm over (..., H*dh) (used by RWKV6 output)."""
    *lead, d = x.shape
    dtype = x.dtype
    x = x.reshape(*lead, num_heads, d // num_heads).float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x.reshape(*lead, d)
    return (x * weight + bias).to(dtype)


def dense(x, w, b=None):
    if hasattr(w, "wq"):  # QTensor (TD2 rsm_int8 serving format)
        from repro_torch.kernels import ops  # local import avoids a cycle

        *lead, d = x.shape
        y = ops.int8_matmul(x.reshape(-1, d), w.wq, w.scales).reshape(
            *lead, w.wq.shape[1]
        )
    else:
        y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


# --- MLP variants -------------------------------------------------------------


def mlp_swiglu(x, wi_gate, wi_up, wo):
    h = F.silu(dense(x, wi_gate)) * dense(x, wi_up)
    return dense(h, wo)


def mlp_relu2(x, wi, wo):
    """Squared-ReLU MLP (nemotron/minitron)."""
    h = torch.square(F.relu(dense(x, wi)))
    return dense(h, wo)


def mlp_gelu(x, wi, bi, wo, bo):
    h = F.gelu(dense(x, wi, bi), approximate="tanh")
    return dense(h, wo, bo)


def apply_mlp(p, x, kind: str):
    if kind == "swiglu":
        return mlp_swiglu(x, p["wi_gate"], p["wi_up"], p["wo"])
    if kind == "relu2":
        return mlp_relu2(x, p["wi"], p["wo"])
    if kind == "gelu":
        return mlp_gelu(x, p["wi"], p["bi"], p["wo"], p["bo"])
    raise ValueError(kind)


def mlp_specs(d_model: int, d_ff: int, kind: str):
    """Leaf specs of one MLP: {name: (shape, init, scale)} (see transformer)."""
    s_in = d_model ** -0.5
    s_out = d_ff ** -0.5
    if kind == "swiglu":
        return {
            "wi_gate": ((d_model, d_ff), "normal", s_in),
            "wi_up": ((d_model, d_ff), "normal", s_in),
            "wo": ((d_ff, d_model), "normal", s_out),
        }
    if kind == "relu2":
        return {
            "wi": ((d_model, d_ff), "normal", s_in),
            "wo": ((d_ff, d_model), "normal", s_out),
        }
    if kind == "gelu":
        return {
            "wi": ((d_model, d_ff), "normal", s_in),
            "bi": ((d_ff,), "zeros", None),
            "wo": ((d_ff, d_model), "normal", s_out),
            "bo": ((d_model,), "zeros", None),
        }
    raise ValueError(kind)


def embed(tokens, table):
    return table[tokens]


class _UnembedBF16(torch.autograd.Function):
    """bf16 (N, D) @ (D, V) with float32 output, and its two products back.

    The backward rounds the float32 logits' gradient to bf16 and returns
    bf16 gradients, as the JAX package's ``preferred_element_type`` einsum
    gives gradients in its operands' dtype.
    """

    @staticmethod
    def forward(ctx, x, table):
        ctx.save_for_backward(x, table)
        return torch.mm(x, table, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        x, table = ctx.saved_tensors
        dy = dy.to(torch.bfloat16)
        return torch.mm(dy, table.t()), torch.mm(x.t(), dy)


def unembed(x, table):
    """x: (..., D) @ (D, V) -> logits in f32.

    A bf16 table on the GPU is multiplied as it is, with float32 output
    (``out_dtype``), through ``_UnembedBF16``: upcasting a 256000 x 3072
    table would copy 3 GB on every step, and ``mm.dtype`` has no derivative
    of its own.  Outside autograd (serving) the Function builds no graph.
    The dry-run's fake tensors take the card's path.
    """
    from repro_torch.kernels import ops  # local import avoids a cycle

    if (x.is_cuda or ops.is_fake(x)) and x.dtype == table.dtype == torch.bfloat16:
        *lead, d = x.shape
        y = _UnembedBF16.apply(x.reshape(-1, d), table)
        return y.reshape(*lead, table.shape[1])
    return torch.matmul(x.float(), table.float())
