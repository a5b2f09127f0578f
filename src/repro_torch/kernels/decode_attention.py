"""K2 wrapper: decode attention over the KV cache (kernel in csrc/decode_attention.cu).

The counterpart of the JAX package's ``kernels/decode_attention.py``: q
(B, K, G, dh), caches (B, K, S, dh), ``lengths`` (B,) valid entries
including the current token, an optional sliding window.  The kernel reads
the caches by stride, so a transposed view of the model's (B, S, K, dh)
cache costs no copy, and reads ``lengths`` on the device, so the launch
needs no host sync and a CUDA graph can capture it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {"decode_attention_fwd": (
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_L] * 12 + [_I, _F, _P],
    ctypes.c_int)}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8     # query rows per kv head the kernel serves (csrc MAXG)


def _bhr(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, window=None) -> torch.Tensor:
    """q: (B, K, G, dh); caches: (B, K, S, dh); lengths: (B,) incl. current.

    Returns (B, K, G, dh).
    """
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if (q.dtype not in build.DTYPE_CODES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise ValueError("decode_attention: q and caches must share one dtype, "
                         f"float32 or bfloat16; got {q.dtype} {k_cache.dtype} "
                         f"{v_cache.dtype}")
    if lengths.dtype != torch.int32 or lengths.ndim != 1:
        raise ValueError("decode_attention: lengths must be (B,) int32")
    if q.ndim != 4 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("decode_attention: q (B, K, G, dh), caches (B, K, S, dh)")
    B, K, G, dh = q.shape
    if (k_cache.shape[0] != B or k_cache.shape[1] != K or k_cache.shape[3] != dh
            or lengths.shape[0] != B):
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)} "
                         f"{tuple(k_cache.shape)} {tuple(lengths.shape)} do not agree")
    if dh not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {dh} not in {HEAD_DIMS} "
                         f"or group {G} > {MAX_GROUP}")
    if not (q.device == k_cache.device == v_cache.device == lengths.device):
        raise ValueError("decode_attention: all operands must be on one device")
    # the kernel reads key rows with 16-byte loads
    per16 = 16 // q.element_size()
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.stride(3) != 1 or c.data_ptr() % 16
                or any(s % per16 for s in c.stride()[:3])):
            raise ValueError(f"decode_attention: {name} rows must be contiguous "
                             "and 16-byte aligned")
    if q.stride(3) != 1 or not lengths.is_contiguous():
        raise ValueError("decode_attention: q's head dim and lengths must be contiguous")
    out = torch.empty((B, K, G, dh), dtype=q.dtype, device=q.device)
    lib = build.library("decode_attention", _SIGNATURES)
    code = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), build.DTYPE_CODES[q.dtype], B, K, G, dh,
        *_bhr(q), *_bhr(k_cache), *_bhr(v_cache), *_bhr(out),
        -1 if window is None else int(window), dh ** -0.5,
        build.current_stream())
    build.check(lib, code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
