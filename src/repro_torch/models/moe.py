"""Mixture-of-Experts FFN: top-k router + capacity-based scatter dispatch.

The counterpart of the JAX package's ``models/moe.py``:
  * router top-k over E experts (float32 logits), gates renormalized over the
    chosen k, and the Switch-style load-balance loss;
  * position-in-expert from a cumulative sum over the slot-major expert mask
    (the top-1 choice of every token before any top-2 choice); tokens past
    ``capacity`` are dropped to a trash row;
  * tokens scattered into an (E*C + 1, D) buffer, the expert FFN as three
    grouped GEMMs (``ops.moe_gmm``, K4 on the GPU) over its (E, C, D) view
    with ``group_sizes`` = the live rows per expert, and the gated combine.

Training: when grad mode is on and an operand requires grad, each grouped
GEMM goes through ``MoeGmm``, whose forward is ``ops.moe_gmm`` and whose
backward is ``ops.moe_gmm_bwd`` (K4's backward kernel on the GPU, its plain
version on the CPU): the counterpart of the JAX package's autodiff of its
three expert einsums.  Under ``torch.no_grad`` (every serving call) nothing
changes.

The dispatch never reads a device value on the host (no one-hot of a
range-checked index, no bincount, no boolean-mask indexing, no ``.item()``),
and the capacity comes from static shapes, so a CUDA graph can capture a
decode step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx
from repro_torch.kernels import ops
from repro_torch.models import layers


def moe_specs(d_model: int, d_ff: int, num_experts: int):
    """Leaf specs {name: (shape, init, scale, dtype)}; the router is float32,
    the experts take the model dtype (None)."""
    E = num_experts
    return {
        "router": ((d_model, E), "normal", d_model ** -0.5, torch.float32),
        "wi_gate": ((E, d_model, d_ff), "normal", d_model ** -0.5, None),
        "wi_up": ((E, d_model, d_ff), "normal", d_model ** -0.5, None),
        "wo": ((E, d_ff, d_model), "normal", d_ff ** -0.5, None),
    }


def moe_block_specs(cfg):
    p = {"moe": moe_specs(cfg.d_model, cfg.d_ff, cfg.num_experts)}
    if cfg.moe_dense_residual:
        p["dense_mlp"] = layers.mlp_specs(cfg.d_model, cfg.d_ff, "swiglu")
    return p


def capacity(num_tokens: int, num_experts: int, k: int, factor: float) -> int:
    c = int(num_tokens * k * factor / num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor 8


def _expert_mask(idx, E: int):
    """(..., E) int32 one-hot of expert ids, by comparison with arange(E)."""
    return (idx[..., None] == torch.arange(E, device=idx.device)).to(torch.int32)


def route(router_w, x, k: int):
    """x: (T, D) -> (gates (T,k) f32, idx (T,k) int64, aux_loss scalar)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch load balance: E * sum_e fraction_tokens_e * mean_prob_e
    E = router_w.shape[1]
    me = probs.mean(dim=0)
    ce = _expert_mask(idx[:, 0], E).float().mean(dim=0)  # top-1 assignment
    aux = E * torch.sum(me * ce)
    return gates, idx, aux


class MoeGmm(torch.autograd.Function):
    """out[e] = x[e] @ w[e] over the live rows, differentiated by the
    hand-written backward: it saves x, w and group_sizes (no (E, C, F)
    residual) and computes only the gradients autograd asks for."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return ops.moe_gmm(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dx, dw = ops.moe_gmm_bwd(x, w, group_sizes, dy, need_dx=ctx.needs_input_grad[0],
                                 need_dw=ctx.needs_input_grad[1])
        return dx, dw, None


def _gmm(x, w, group_sizes):
    """``ops.moe_gmm``, through ``MoeGmm`` where autograd needs its gradient."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGmm.apply(x, w, group_sizes)
    return ops.moe_gmm(x, w, group_sizes)


def moe_ffn(p, x, *, experts_per_token: int, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (out (B, S, D), aux_loss)."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    E = p["router"].shape[1]
    k = experts_per_token
    C = capacity(T, E, k, capacity_factor)

    gates, idx, aux = route(p["router"], xf, k)

    # position-in-expert, slot-major: slot j of every token before slot j+1
    idx_km = idx.T.reshape(k * T)                                # (kT,)
    mask = _expert_mask(idx_km, E)                               # (kT, E)
    pos = torch.cumsum(mask, dim=0) - 1
    pos_in_e = torch.gather(pos, 1, idx_km[:, None])[:, 0]
    keep = pos_in_e < C
    slot = torch.where(keep, idx_km * C + pos_in_e, E * C)       # drop -> trash
    # live rows per expert, on the device: min(tokens routed to e, C)
    group_sizes = torch.clamp(mask.sum(dim=0), max=C).to(torch.int32)

    # dispatch: every kept slot is written once, the trash row takes the rest
    xk = xf[None].expand(k, T, D).reshape(k * T, D)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, xk)
    # capacity rows over the data axis under a mesh (``ctx.constrain``): the
    # scatter then moves only real token rows between shards
    xe = ctx.constrain(buf[: E * C].view(E, C, D), (None, "dp", None), role="moe")

    h = F.silu(_gmm(xe, p["wi_gate"], group_sizes)) * _gmm(xe, p["wi_up"], group_sizes)
    ye = _gmm(h, p["wo"], group_sizes)                           # (E, C, D)
    ye = ctx.constrain(ye, (None, "dp", None), role="moe")

    # combine: gather back in the model dtype, weight by gate, sum over slots
    yflat = torch.cat([ye.reshape(E * C, D), ye.new_zeros((1, D))])
    yk = yflat[slot].reshape(k, T, D)
    gk = (gates.T.reshape(k * T) * keep).reshape(k, T)
    out = torch.einsum("ktd,kt->td", yk.float(), gk.to(yk.dtype).float())
    return out.reshape(B, S, D).to(x.dtype), aux


def apply_moe_block(p, x, cfg):
    """MoE FFN (+ arctic's dense residual MLP). Returns (out, aux)."""
    out, aux = moe_ffn(p["moe"], x, experts_per_token=cfg.experts_per_token,
                       capacity_factor=cfg.capacity_factor)
    if cfg.moe_dense_residual:
        out = out + layers.apply_mlp(p["dense_mlp"], x, "swiglu")
    return out, aux
