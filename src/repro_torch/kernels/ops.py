"""Public entry points of the kernels, with the JAX package's keyword arguments.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/ref.py``); a CUDA tensor goes to the hand-written kernel or the
wrapper raises.  The block-size arguments size the TPU kernels' tiles in the
JAX package; the CUDA kernels pick their tiles from the shapes, so here they
are accepted for call compatibility and have no effect.

A tensor that holds no data (``is_fake``: a FakeTensor, or a DTensor of
them, as the dry-run traces) goes to ``kernels/fake.py``: outputs of the
kernel's shapes, its operations counted, nothing launched or run.  A DTensor
over real shards goes through the same module's redistribution by the
kernel's sharding rule, and the wrapper runs on its local shards.  A plain
tensor is told apart by its type alone, so the card's path pays one
comparison.

``launch_counts`` and ``reset_launch_counts`` read and clear the plain
integer each wrapper adds one to where it launches its kernel.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro_torch.kernels import fake as _fake
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd as _flash_bwd
from repro_torch.kernels.int8_matmul import int8_matmul as _int8
from repro_torch.kernels.int8_matmul import quantize_int8  # noqa: F401 (re-export)
from repro_torch.kernels.moe_gmm import moe_gmm as _gmm
from repro_torch.kernels.moe_gmm_bwd import moe_gmm_bwd as _gmm_bwd
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _rwkv6
from repro_torch.kernels.rwkv6_scan_bwd import rwkv6_scan_bwd as _rwkv6_bwd

_WRAPPERS = {"flash_attention": _flash, "flash_attention_bwd": _flash_bwd,
             "decode_attention": _decode, "int8_matmul": _int8, "moe_gmm": _gmm,
             "moe_gmm_bwd": _gmm_bwd, "rwkv6_scan": _rwkv6, "rwkv6_scan_bwd": _rwkv6_bwd}


def is_fake(t) -> bool:
    """True for a tensor that holds no data: a FakeTensor, or a DTensor whose
    local shard is one."""
    if type(t) is torch.Tensor:
        return False
    if isinstance(t, DTensor):
        t = t._local_tensor     # no dispatch: a tracer sees nothing here
    return isinstance(t, FakeTensor)


def _routed(t) -> bool:
    """A FakeTensor or a DTensor: ``kernels/fake.py`` takes the call."""
    return type(t) is not torch.Tensor and isinstance(t, (FakeTensor, DTensor))


def flash_attention(q, k, v, *, causal=True, window=None, block_q=128,
                    block_kv=128, return_lse=False):
    """``return_lse``, beyond the JAX package's arguments: also return the
    row log-sum-exp (B, H, Sq) f32 that ``flash_attention_bwd`` reads."""
    if _routed(q):
        return _fake.flash_attention(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse, real=not is_fake(q))
    return _flash(q, k, v, causal=causal, window=window, return_lse=return_lse)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None):
    """(dq, dk, dv) of ``flash_attention`` from its output ``o`` and ``lse``;
    the JAX package has no kernel of its own here (its attention backward is
    the custom VJP's rule, ``models/attention.py``)."""
    if _routed(q):
        return _fake.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         window=window, real=not is_fake(q))
    return _flash_bwd(q, k, v, o, lse, do, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, lengths, *, window=None, block_s=512):
    if _routed(q):
        return _fake.decode_attention(q, k_cache, v_cache, lengths, window=window,
                                      real=not is_fake(q))
    return _decode(q, k_cache, v_cache, lengths, window=window)


def int8_matmul(x, w_q, scales, *, block_m=128, block_n=128, block_d=512):
    if _routed(x):
        return _fake.int8_matmul(x, w_q, scales, real=not is_fake(x))
    return _int8(x, w_q, scales)


def moe_gmm(x, w, group_sizes=None, *, block_c=128, block_f=128, block_d=256):
    if _routed(x):
        return _fake.moe_gmm(x, w, group_sizes, real=not is_fake(x))
    return _gmm(x, w, group_sizes)


def moe_gmm_bwd(x, w, group_sizes, dy, *, need_dx=True, need_dw=True):
    """(dx, dw) of ``moe_gmm`` from dy (E, C, F), None where not asked for;
    the JAX package has no kernel of its own here (autodiff of its expert
    einsums, ``models/moe.py``)."""
    if _routed(x):
        return _fake.moe_gmm_bwd(x, w, group_sizes, dy, need_dx=need_dx, need_dw=need_dw,
                                 real=not is_fake(x))
    return _gmm_bwd(x, w, group_sizes, dy, need_dx=need_dx, need_dw=need_dw)


def rwkv6_scan(r, k, v, w, u, s0, *, chunk=64, s_out=None, checkpoints=None):
    """``s_out``, beyond the JAX package's arguments: where the final state
    goes (it may be ``s0``, for an in-place update of a decode cache);
    ``checkpoints``: where the state entering every 16 steps goes, for
    ``rwkv6_scan_bwd``."""
    if _routed(r):
        return _fake.rwkv6_scan(r, k, v, w, u, s0, s_out=s_out, checkpoints=checkpoints,
                                real=not is_fake(r))
    return _rwkv6(r, k, v, w, u, s0, s_out=s_out, checkpoints=checkpoints)


def rwkv6_scan_bwd(r, k, v, w, u, s0, dout, ds_final=None, *, checkpoints=None):
    """(dr, dk, dv, dw, du, ds0) of ``rwkv6_scan`` from dout and the final
    state's gradient; the JAX package has no kernel of its own here (autodiff
    of its ``lax.scan``, ``models/ssm.py``).  On the card it reads the
    forward's ``checkpoints``."""
    if _routed(r):
        return _fake.rwkv6_scan_bwd(r, k, v, w, u, s0, dout, ds_final,
                                    checkpoints=checkpoints, real=not is_fake(r))
    return _rwkv6_bwd(r, k, v, w, u, s0, dout, ds_final, checkpoints=checkpoints)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
