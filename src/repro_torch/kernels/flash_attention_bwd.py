"""K1 backward wrapper: attention gradients (kernels in csrc/flash_attention_bwd.cu).

The counterpart of the block-wise flash backward of the JAX package's
attention (``models/attention.py:_attention_bwd_rule``) in K1's layout: q, o,
do (B, H, Sq, dh), k/v (B, K, T, dh), lse (B, H, Sq) float32 from
``flash_attention(..., return_lse=True)``; causal and sliding-window masks,
GQA with query head h reading kv head h // (H / K).  Returns (dq, dk, dv) in
the inputs' dtype, dk and dv summed over each kv head's query heads.

The kernels read q, k, v, o and do by stride (only the head dim must be
contiguous), so the model's (B, S, heads, dh) activations and gradients
cost no copy; dq, dk and dv are allocated in (B, S, heads, dh) memory and
returned as (B, heads, S, dh) views.  lse is read as a contiguous (B, H, Sq)
array.  Every dtype and layout takes the one float32 FMA path.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {"flash_attention_bwd": (
    [_P] * 10 + [_I] * 7 + [_L] * 24 + [_I, _I, _F, _P], ctypes.c_int)}
HEAD_DIMS = (32, 64, 80, 128)


def _bsh(t: torch.Tensor):
    """Element strides of (batch, sequence, head) for a (B, heads, S, dh) tensor."""
    return t.stride(0), t.stride(2), t.stride(1)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window=None):
    """q, o, do: (B, H, Sq, dh); k, v: (B, K, T, dh); lse: (B, H, Sq) f32.

    Returns (dq (B, H, Sq, dh), dk (B, K, T, dh), dv (B, K, T, dh)).
    """
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                           window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    if q.dtype not in build.DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise ValueError("flash_attention_bwd: q, k, v, o, do must share one dtype, "
                         f"float32 or bfloat16; got {[t.dtype for t in (q, k, v, o, do)]}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or o.shape != q.shape \
            or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: q, o, do (B, H, Sq, dh), k and v "
                         "(B, K, T, dh)")
    B, H, Sq, dh = q.shape
    K, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or H % K:
        raise ValueError(f"flash_attention_bwd: shapes {tuple(q.shape)} {tuple(k.shape)} "
                         "do not agree")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {dh} not in {HEAD_DIMS}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be ({B}, {H}, {Sq}) float32, "
                         "contiguous")
    if any(t.device != q.device for t in (k, v, o, do, lse)):
        raise ValueError("flash_attention_bwd: every operand must be on one device")
    if any(t.stride(3) != 1 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd: the head dim must be contiguous")
    dq = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, T, K, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, T, K, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = build.library("flash_attention_bwd", _SIGNATURES)
    code = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        build.DTYPE_CODES[q.dtype], B, H, K, Sq, T, dh,
        *_bsh(q), *_bsh(k), *_bsh(v), *_bsh(o), *_bsh(do), *_bsh(dq), *_bsh(dk), *_bsh(dv),
        int(causal), -1 if window is None else int(window), dh ** -0.5,
        build.current_stream())
    build.check(lib, code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
