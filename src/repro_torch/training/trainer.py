"""Training loop: loss, train step, gradient accumulation.

The counterpart of the JAX package's ``training/trainer.py``.  The step is
eager PyTorch on one device (the JAX package jits it; nothing here needs to): the
gradients come from ``torch.autograd.grad`` over the parameter leaves, whose
``requires_grad`` is on only inside the step, and ``adamw_update`` then
updates the parameters and the optimizer state in place.

On CUDA the forward of every family reaches a kernel, and every kernel on
the training path has a hand-written backward, so all ten archs train on
the card: attention (K1) through ``FlashAttention`` (``models/attention.py``),
the grouped expert GEMM (K4, moe) through ``MoeGmm`` (``models/moe.py``) and
the WKV scan (K5, rwkv6) through ``Rwkv6Scan`` (``models/ssm.py``).  On the
CPU the same Functions run the kernels' plain versions.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import resolve_device
from repro_torch.models import transformer
from repro_torch.training.optim import AdamWConfig, adamw_update, init_opt_state, tree_leaves

def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves, in ``tree_leaves`` order, from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def batch_to(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


class _PickLabels(torch.autograd.Function):
    """``logp`` at each label, (..., V) -> (...): ``torch.gather``'s value
    and gradient, the gradient made by ``zeros_like(logp)`` so that it takes
    logp's layout (a DTensor sharded over the vocabulary keeps its shards in
    the dry-run, where ``gather``'s own backward would build the whole
    (..., V) gradient from the labels' layout)."""

    @staticmethod
    def forward(ctx, logp, labels):
        ctx.save_for_backward(logp, labels)
        return torch.gather(logp, -1, labels[..., None])[..., 0]

    @staticmethod
    def backward(ctx, dll):
        logp, labels = ctx.saved_tensors
        g = torch.zeros_like(logp)
        return g.scatter_add_(-1, labels[..., None], dll[..., None].to(g.dtype)), None


def lm_loss(params, cfg: ModelConfig, batch, *, remat: bool = False,
            aux_weight: float = 1e-2):
    """Mean next-token cross-entropy (+ MoE load-balance aux)."""
    out = transformer.forward(params, cfg, batch, remat=remat)
    logits = out["logits"].float()
    labels = batch["labels"]
    logp = torch.log_softmax(logits, dim=-1)
    ll = _PickLabels.apply(logp, labels.long())
    mask = batch.get("loss_mask")
    if mask is None:
        loss = -ll.mean()
    else:
        loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux_weight * out["aux_loss"], {
        "ce_loss": loss, "aux_loss": out["aux_loss"]}


def loss_and_grads(params, cfg: ModelConfig, batch, *, remat: bool = False):
    """(loss, {"ce_loss", "aux_loss"}, grads): ``lm_loss`` and its gradient
    with respect to every parameter leaf, in the parameters' tree and dtypes
    (the JAX package's value_and_grad of lm_loss).  A leaf the loss does
    not reach gets zeros, as in JAX."""
    leaves = tree_leaves(params)
    if not all(torch.is_tensor(p) and p.is_floating_point() for p in leaves):
        raise ValueError(f"{cfg.name}: an rsm_int8 tree (QTensor leaves) is not "
                         "trainable; train the float parameters")
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = lm_loss(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            _unflatten(params, iter(grads)))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, remat: bool = False,
                    microbatches: int = 1, device=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, stats).

    ``device``: where the step runs (the GPU unless the caller names the
    CPU); the batch (numpy arrays or tensors) is moved there.  ``params``
    and ``opt_state`` must live there already and are updated in place.
    ``stats`` holds 0-d tensors: loss, ce_loss, aux_loss, grad_norm, lr.
    """
    device = resolve_device(device)

    def train_step(params, opt_state, batch):
        batch = batch_to(batch, device)
        if microbatches > 1:
            # gradient accumulation over the batch axis (usually axis 0; the
            # M-RoPE position ids carry batch on axis 1: (3, B, S))
            B = batch["labels"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into {microbatches} "
                                 "microbatches")
            n = B // microbatches

            def split(x, i):
                if x.shape[0] == B:
                    return x[i * n:(i + 1) * n]
                if x.ndim < 2 or x.shape[1] != B:
                    raise ValueError(f"cannot split a batch leaf of shape {tuple(x.shape)}")
                return x[:, i * n:(i + 1) * n]

            # zeros_like: a sharded (DTensor) parameter gets a sharded sum
            g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in tree_leaves(params)]
            loss, auxs = 0.0, []
            for i in range(microbatches):
                l_i, aux, grads = loss_and_grads(
                    params, cfg, {k: split(v, i) for k, v in batch.items()}, remat=remat)
                for acc, g in zip(g_acc, tree_leaves(grads)):
                    acc.add_(g)
                loss = loss + l_i
                auxs.append(aux)
            grads = _unflatten(params, (g.div_(microbatches) for g in g_acc))
            loss = loss / microbatches
            aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        else:
            loss, aux, grads = loss_and_grads(params, cfg, batch, remat=remat)
        params, opt_state, ostats = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **aux, **ostats}

    return train_step


def train_loop(cfg: ModelConfig, opt_cfg: AdamWConfig, data_iter, steps: int, *,
               params=None, log_every: int = 10, seed: int = 0, callback=None,
               device=None) -> Dict[str, Any]:
    """Single-device training driver (smoke scale / examples).

    ``params`` defaults to ``init_params(cfg, seed, device)``; a given tree
    is trained in place.
    """
    device = resolve_device(device)
    if params is None:
        params = transformer.init_params(cfg, seed, device)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, device=device)
    history = []
    for step in range(steps):
        params, opt_state, stats = step_fn(params, opt_state, next(data_iter))
        if step % log_every == 0 or step == steps - 1:
            rec = {k: float(v) for k, v in stats.items()}
            rec["step"] = step
            history.append(rec)
            if callback:
                callback(rec)
    return {"params": params, "opt_state": opt_state, "history": history}
