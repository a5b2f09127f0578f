"""K1 wrapper: prefill flash attention (kernel in csrc/flash_attention.cu).

The counterpart of the JAX package's ``kernels/flash_attention.py``: q
(B, H, Sq, dh), k/v (B, K, T, dh), causal and sliding-window masks, GQA with
query head h reading kv head h // (H / K).  The kernel reads every operand by
stride, so a transposed view of the model's (B, S, H, dh) activations costs
no copy; the output is allocated in (B, Sq, H, dh) memory and returned as a
(B, H, Sq, dh) view, so the model's transpose back is free as well.

``plan`` chooses the kernel's path from the dtype and the layout: bf16 in a
layout the 16-byte copies can take (every (b, s, head) stride a multiple of
8 elements, 16-byte aligned bases: the model's layouts) runs "mma", the
FlashAttention-2 kernel on the tensor cores; float32 always runs "fma", true
float32 on the CUDA cores for the 2e-4 parity tests, as does bf16 in any
other layout.

``return_lse`` also returns the row log-sum-exp of the scaled, masked
scores, (B, H, Sq) float32 in natural-log units, which the backward
(``flash_attention_bwd``) reads; without it the kernel writes none.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {"flash_attention_fwd": (
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I] + [_L] * 12
    + [_I, _I, _F, _P, _P], ctypes.c_int)}
HEAD_DIMS = (32, 64, 80, 128)
PATHS = {"fma": 0, "mma": 1}   # csrc/flash_attention.cu FLASH_PATH_*


def _bsh(t: torch.Tensor):
    """Element strides of (batch, sequence, head) for a (B, heads, S, dh) tensor."""
    s = t.stride()
    return s[0], s[2], s[1]


def plan(dtype: torch.dtype, copy_aligned: bool) -> str:
    """"mma" (bf16 in 16-byte-copyable layout) or "fma" (everything else)."""
    return "mma" if dtype == torch.bfloat16 and copy_aligned else "fma"


def _copy_aligned(*ts: torch.Tensor) -> bool:
    """Every row of every head starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in _bsh(t)) for t in ts)


def plan_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``plan`` for the tensors of one call on the card."""
    return plan(q.dtype, _copy_aligned(q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, return_lse: bool = False):
    """q: (B, H, Sq, dh); k, v: (B, K, T, dh). Returns (B, H, Sq, dh), and
    with ``return_lse`` also the lse (B, H, Sq) float32."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype, "
                         f"float32 or bfloat16; got {q.dtype} {k.dtype} {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q (B, H, Sq, dh), k and v (B, K, T, dh)")
    B, H, Sq, dh = q.shape
    K, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or H % K:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} {tuple(k.shape)} "
                         "do not agree")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    path = plan_call(q, k, v)
    lib = build.library("flash_attention", _SIGNATURES)
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[q.dtype], PATHS[path], B, H, K, Sq, T, dh,
        *_bsh(q), *_bsh(k), *_bsh(v), *_bsh(out),
        int(causal), -1 if window is None else int(window), dh ** -0.5,
        None if lse is None else lse.data_ptr(), build.current_stream())
    build.check(lib, code, f"flash_attention ({path})")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
