"""K4 wrapper: grouped (expert) GEMM (kernel in csrc/moe_gmm.cu).

The counterpart of the JAX package's ``kernels/moe_gmm.py``: out[e] =
x[e] @ w[e] for x (E, C, D) and w (E, D, F), f32 or bf16, accumulated in
float32, in x's dtype.  Rows at or past ``group_sizes[e]`` count as zero.
The kernel reads ``group_sizes`` on the device, so the launch needs no host
sync and a CUDA graph can capture it, and it reads x and w by stride.

``plan`` chooses the kernel's path from the dtype, the shape and the
layout, the same way for every call of that dtype, shape and layout
(nothing is tried and nothing falls back):
  fma    float32, always (true float32 FMAs for the parity tests).
  wgmma  bf16 with C >= WGMMA_MIN_C (prefill: 128-row warpgroup tiles) and
         operands TMA can address: TMA ring + wgmma tensor cores over the
         live tiles, a persistent grid of one block per SM.
  mma    bf16 otherwise (decode's C <= 32, or a layout TMA cannot take):
         WMMA (mma.sync) tiles, dead row tiles skipped.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"moe_gmm_fwd": ([_P, _P, _P, _P] + [_I] * 5 + [_L] * 4 + [_I, _I, _P],
                               ctypes.c_int)}
PATHS = {"fma": 0, "mma": 1, "wgmma": 2}   # csrc/moe_gmm.cu GMM_PATH_*
WGMMA_MIN_C = 33     # C at or above takes the wgmma path in bf16
WGMMA_MAX_E = 1024   # experts the wgmma path's shared-memory tile list holds
_WG_BM, _WG_BN = 128, 256   # wgmma: output tile


def plan(E: int, C: int, D: int, F: int, dtype: torch.dtype,
         tma_ok: bool = True) -> str:
    """The path of an (E, C, D) x (E, D, F) call.

    ``tma_ok``: x and w are 16-byte aligned, their row and expert strides are
    multiples of 8 elements and ordered as a tensor map needs them
    (``tma_addressable``).
    """
    if dtype == torch.float32:
        return "fma"
    if C >= WGMMA_MIN_C and E <= WGMMA_MAX_E and D % 8 == 0 and F % 8 == 0 and tma_ok:
        return "wgmma"
    return "mma"


def tma_addressable(x: torch.Tensor, w: torch.Tensor) -> bool:
    """x (E, C, D) and w (E, D, F) as 3-D tensor maps: 16-byte aligned bases,
    unit last strides, row and expert strides multiples of 8 elements, each
    stride at least the extent of the axes inside it."""
    E, C, D = x.shape
    F = w.shape[2]
    sxe, sxc, sxd = x.stride()
    swe, swd, swf = w.stride()
    return (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 and sxd == 1 and swf == 1
            and all(s % 8 == 0 for s in (sxe, sxc, swe, swd))
            and sxc >= D and sxe >= C * sxc and swd >= F and swe >= D * swd)


def plan_call(x: torch.Tensor, w: torch.Tensor) -> str:
    """``plan`` for the tensors of one call (the layout is read only where it
    decides the path)."""
    E, C, D = x.shape
    tma_ok = x.dtype == torch.bfloat16 and C >= WGMMA_MIN_C and tma_addressable(x, w)
    return plan(E, C, D, w.shape[2], x.dtype, tma_ok)


def wgmma_grid(E: int, C: int, F: int, sms: int) -> int:
    """Persistent blocks of the wgmma path: one per SM, or one per tile when
    every row tile of every expert is fewer."""
    return max(1, min(sms, E * -(-C // _WG_BM) * -(-F // _WG_BN)))


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
    path = plan_call(x, w)
    sms = build.sm_count(x.device.index)
    lib = build.library("moe_gmm", _SIGNATURES)
    code = lib.moe_gmm_fwd(
        x.data_ptr(), w.data_ptr(),
        group_sizes.data_ptr() if group_sizes is not None else None, out.data_ptr(),
        build.DTYPE_CODES[x.dtype], E, C, D, F, x.stride(0), x.stride(1), w.stride(0),
        w.stride(1), PATHS[path], wgmma_grid(E, C, F, sms), build.current_stream())
    build.check(lib, code, f"moe_gmm ({path})")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
