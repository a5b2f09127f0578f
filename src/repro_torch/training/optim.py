"""AdamW + cosine schedule + global-norm clipping, on dicts of tensors.

The counterpart of the JAX package's ``training/optim.py``, with the same
arithmetic.  The optimizer state is {"m": tree, "v": tree, "step": int}: m
and v mirror the parameters in float32 (or bfloat16, the dry-run's
large-model configuration), ``step`` counts the updates taken.
``adamw_update`` updates the parameters, m and v IN PLACE (the JAX package
returns new trees from donated buffers) with at most two float32
temporaries of one leaf at a time (three for bfloat16 m and v): at full
width (minitron-4b, a
786 M-entry embedding) the reference's expression would make about six
3.1 GB temporaries of that leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, in the JAX package's order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params, dtype=torch.float32) -> Dict[str, Any]:
    """Zero m and v beside every parameter, on its device.  dtype: float32
    default; bfloat16 is the large-model memory configuration the
    production dry-runs use (``launch/specs.py:opt_struct``)."""
    def zeros(p):
        if not torch.is_tensor(p) or not p.is_floating_point():
            raise ValueError(f"init_opt_state: {type(p).__name__} leaf is not a float "
                             "tensor (an rsm_int8 QTensor tree is not trainable)")
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    return {"m": _map(zeros, params), "v": _map(zeros, params), "step": 0}


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Warmup then cosine decay, in float32 as the JAX package computes it;
    a 0-d float32 tensor on the CPU."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * prog))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d, on the
    leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """One AdamW step. Returns (params, opt_state, stats).

    ``params`` and ``opt_state``'s m and v are updated in place and returned;
    ``stats`` holds 0-d tensors ``grad_norm`` (on the device) and ``lr``.
    The step's scalars (lr, bias corrections) are float32, as the JAX
    package's; the clip scale stays on the device, so no value is read back.
    m and v in bfloat16 are updated in float32 and rounded back, as the
    JAX package rounds them; that takes one float32 temporary more.
    """
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule_lr(cfg, step)
    step32 = torch.tensor(step, dtype=torch.float32)
    b1c = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** step32)
    b2c = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** step32)
    lr_f = float(lr)
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(opt_state["m"])
    flat_v = tree_leaves(opt_state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("adamw_update: params, grads, m and v must be one tree")
    with torch.no_grad():
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            if not torch.is_tensor(p) or not p.is_floating_point():
                raise ValueError("adamw_update: an rsm_int8 QTensor tree is not trainable")
            if m.dtype not in (torch.float32, torch.bfloat16) or v.dtype != m.dtype:
                raise ValueError("adamw_update: m and v must be both float32 or both "
                                 "bfloat16")
            # temporary 1, laid out as p (a sharded DTensor gradient is then
            # reduced to p's shards here)
            g32 = torch.empty_like(p, dtype=torch.float32).copy_(g).mul_(scale)
            if m.dtype == torch.float32:
                m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
                v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
                m32, v32 = m, v
            else:                                             # temporaries 2, 3
                m32 = m.float().mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
                v32 = v.float().mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
                m.copy_(m32)
                v.copy_(v32)
            # delta = (m / b1c) / (sqrt(v / b2c) + eps), the root into g32
            denom = torch.div(v32, b2c, out=g32).sqrt_().add_(cfg.eps)
            del v32
            delta = (torch.div(m, b1c) if m32 is m else m32.div_(b1c)).div_(denom)
            if p.ndim >= 2:   # decoupled weight decay on matrices only
                delta.add_(p, alpha=cfg.weight_decay)
            # p - lr * delta (the same bits as p + (-lr) * delta), rounded
            # once to p's dtype
            p.copy_(delta.mul_(-lr_f).add_(p))
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, stats


def opt_state_from_numpy(state, device=None) -> Dict[str, Any]:
    """The port's optimizer state from the JAX package's (numpy leaves and a
    numpy or int ``step``)."""
    device = resolve_device(device)

    def conv(a):
        return torch.from_numpy(np.array(np.asarray(a), dtype=np.float32)).to(device)

    return {"m": _map(conv, state["m"]), "v": _map(conv, state["v"]),
            "step": int(np.asarray(state["step"]))}


def opt_state_to_numpy(state) -> Dict[str, Any]:
    """numpy leaves (m, v float32) and an int32 ``step``, the JAX package's form."""
    def conv(t):
        return t.detach().float().cpu().numpy()

    return {"m": _map(conv, state["m"]), "v": _map(conv, state["v"]),
            "step": np.asarray(state["step"], np.int32)}
