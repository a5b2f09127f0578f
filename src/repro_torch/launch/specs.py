"""Fake-tensor input specs + step builders for every (arch x shape).

The counterpart of the JAX package's ``launch/specs.py``.  Each ``*_struct``
returns fake tensors (``FakeTensorMode``: shapes, dtypes and a device, no
memory) of the JAX package's shapes and dtypes for the arguments of the
step a shape exercises:

  train_4k                  -> train_step(params, opt_state, batch)
  prefill_32k               -> prefill_step(params, batch)
  decode_32k / long_500k    -> serve_step(params, cache, tokens)

Modality frontends are stubs, as there: audio supplies (B, 1500, D) frame
embeddings, VLM supplies merged token+patch embeddings + M-RoPE ids.

Every struct is made under ``mode`` (a ``FakeTensorMode``), on ``device``;
the dry-run passes one mode for all of a step's arguments, since fake
tensors of two modes do not mix.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.training.optim import AdamWConfig, init_opt_state
from repro_torch.training.trainer import make_train_step


def _empty(mode, shape, dtype, device):
    with mode:
        return torch.empty(shape, dtype=dtype, device=device)


def params_struct(cfg: ModelConfig, mode: FakeTensorMode, device="cpu"):
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return _empty(mode, spec.shape, spec.dtype or cfg.torch_dtype, device)

    return make(transformer.param_specs(cfg))


def opt_struct(cfg: ModelConfig, mode: FakeTensorMode, device="cpu",
               opt_dtype=torch.bfloat16):
    with mode:
        return init_opt_state(params_struct(cfg, mode, device), dtype=opt_dtype)


def cache_struct(cfg: ModelConfig, batch: int, max_seq: int, mode: FakeTensorMode,
                 device="cpu"):
    with mode:
        return transformer.init_cache(cfg, batch, max_seq, device=device)


def batch_struct(cfg: ModelConfig, shape: ShapeConfig, *, with_labels: bool,
                 mode: FakeTensorMode, device="cpu"):
    B, S = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return _empty(mode, shp, dtype, device)

    batch: Dict[str, Any] = {"tokens": sds((B, S), torch.int32)}
    if with_labels:
        batch["labels"] = sds((B, S), torch.int32)
    if cfg.family == "audio":
        batch["frames"] = sds((B, cfg.encoder_seq, cfg.d_model), cfg.torch_dtype)
    if cfg.family == "vlm":
        # stub frontend: merged token+patch embeddings and 3-component M-RoPE
        # position ids (t/h/w)
        batch["embeds"] = sds((B, S, cfg.d_model), cfg.torch_dtype)
        batch["positions"] = sds((3, B, S), torch.int32)
        del batch["tokens"]
    return batch


def microbatches_for(cfg: ModelConfig, shape: ShapeConfig, dp: int) -> int:
    """Grad-accum factor: keep per-device microbatch tokens <= ~8k."""
    tokens_per_dev = shape.global_batch * shape.seq_len // max(dp, 1)
    mb = max(1, tokens_per_dev // 8192)
    # must divide the per-step batch
    while shape.global_batch % mb or (shape.global_batch // mb) % dp:
        mb -= 1
    return max(mb, 1)


def step_and_specs(
    cfg: ModelConfig, shape: ShapeConfig, *, dp: int = 1, mode: FakeTensorMode,
    device="cpu", opt_dtype=torch.bfloat16, microbatches: int | None = None,
) -> Tuple[Callable, Tuple, str]:
    """Returns (step_fn, arg_structs, kind)."""
    if shape.kind == "train":
        if microbatches is None:
            microbatches = microbatches_for(cfg, shape, dp)
        step = make_train_step(cfg, AdamWConfig(), remat=True,
                               microbatches=microbatches, device=device)
        args = (
            params_struct(cfg, mode, device),
            opt_struct(cfg, mode, device, opt_dtype),
            batch_struct(cfg, shape, with_labels=True, mode=mode, device=device),
        )
        return step, args, "train"

    if shape.kind == "prefill":
        def prefill_step(params, batch, cache=None):
            return transformer.prefill(params, cfg, batch, max_seq=shape.seq_len,
                                       cache=cache)

        args = (params_struct(cfg, mode, device),
                batch_struct(cfg, shape, with_labels=False, mode=mode, device=device))
        return prefill_step, args, "prefill"

    # decode: one new token against a full cache
    def serve_step(params, cache, tokens):
        return transformer.decode_step(params, cfg, cache, tokens)

    B = shape.global_batch
    args = (params_struct(cfg, mode, device),
            cache_struct(cfg, B, shape.seq_len, mode, device),
            _empty(mode, (B,), torch.int32, device))
    return serve_step, args, "decode"
