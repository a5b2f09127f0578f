"""K1 wrapper: prefill flash attention (kernel in csrc/flash_attention.cu).

The counterpart of the JAX package's ``kernels/flash_attention.py``: q
(B, H, Sq, dh), k/v (B, K, T, dh), causal and sliding-window masks, GQA with
query head h reading kv head h // (H / K).  The kernel reads every operand by
stride, so a transposed view of the model's (B, S, H, dh) activations costs
no copy; the output is allocated in (B, Sq, H, dh) memory and returned as a
(B, H, Sq, dh) view, so the model's transpose back is free as well.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {"flash_attention_fwd": (
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I] + [_L] * 12
    + [_I, _I, _F, _P], ctypes.c_int)}
HEAD_DIMS = (32, 64, 128)


def _bsh(t: torch.Tensor):
    """Element strides of (batch, sequence, head) for a (B, heads, S, dh) tensor."""
    return t.stride(0), t.stride(2), t.stride(1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, H, Sq, dh); k, v: (B, K, T, dh). Returns (B, H, Sq, dh)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
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
    lib = build.library("flash_attention", _SIGNATURES)
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[q.dtype], B, H, K, Sq, T, dh,
        *_bsh(q), *_bsh(k), *_bsh(v), *_bsh(out),
        int(causal), -1 if window is None else int(window), dh ** -0.5,
        build.current_stream())
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
