"""K4 wrapper: grouped (expert) GEMM (kernel in csrc/moe_gmm.cu).

The counterpart of the JAX package's ``kernels/moe_gmm.py``: out[e] =
x[e] @ w[e] for x (E, C, D) and w (E, D, F), f32 or bf16, accumulated in
float32, in x's dtype.  Rows at or past ``group_sizes[e]`` count as zero.
The kernel reads ``group_sizes`` on the device, so the launch needs no host
sync and a CUDA graph can capture it, and it reads x and w by stride.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"moe_gmm_fwd": ([_P, _P, _P, _P] + [_I] * 5 + [_L] * 4 + [_P], ctypes.c_int)}


def moe_gmm(x: torch.Tensor, w: torch.Tensor, group_sizes=None) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F); group_sizes: (E,) int or None -> (E, C, F)."""
    if x.device.type == "cpu":
        return ref.moe_gmm_ref(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: unsupported device {x.device}")
    if x.dtype not in build.DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError("moe_gmm: x and w must share one dtype, float32 or "
                         f"bfloat16; got {x.dtype} {w.dtype}")
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError("moe_gmm: x (E, C, D), w (E, D, F)")
    E, C, D = x.shape
    F = w.shape[2]
    if w.shape[:2] != (E, D):
        raise ValueError(f"moe_gmm: shapes {tuple(x.shape)} {tuple(w.shape)} do not agree")
    if group_sizes is not None:
        if group_sizes.shape != (E,):
            raise ValueError(f"moe_gmm: group_sizes must be ({E},)")
        group_sizes = group_sizes.to(torch.int32).contiguous()
    if not (x.device == w.device and (group_sizes is None
                                      or group_sizes.device == x.device)):
        raise ValueError("moe_gmm: x, w and group_sizes must be on one device")
    if x.stride(2) != 1 or w.stride(2) != 1:
        raise ValueError("moe_gmm: the last axis of x and w must be contiguous")
    if x.dtype == torch.bfloat16 and any(
            s % 8 for s in (D, F, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
                            x.data_ptr() // 2, w.data_ptr() // 2)):
        raise ValueError("moe_gmm: bf16 needs D, F and the row strides to be "
                         "multiples of 8 and 16-byte aligned x and w")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    lib = build.library("moe_gmm", _SIGNATURES)
    code = lib.moe_gmm_fwd(
        x.data_ptr(), w.data_ptr(),
        group_sizes.data_ptr() if group_sizes is not None else None, out.data_ptr(),
        build.DTYPE_CODES[x.dtype], E, C, D, F, x.stride(0), x.stride(1), w.stride(0),
        w.stride(1), build.current_stream())
    build.check(lib, code, "moe_gmm")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
