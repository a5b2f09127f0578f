"""K3 wrapper: weight-only int8 GEMM (kernel in csrc/int8_matmul.cu).

The counterpart of the JAX package's ``kernels/int8_matmul.py``: x (M, D)
f32/bf16 times w_q (D, N) int8, accumulated in float32, times the
per-output-channel f32 ``scales``, in x's dtype.  ``quantize_int8`` makes
w_q and scales bit for bit as the JAX package does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"int8_matmul_fwd": (
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _P], ctypes.c_int)}
_BK = 32          # depth of one step of the kernel's D loop
_BN = 128         # output columns of one block


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan(M: int, N: int, D: int, sms: int):
    """(rows per thread, splits of D, D per split) for an (M, D) x (D, N) call.

    Large M takes 128-row tiles; skinny M (decode) 16-row tiles.  When the
    (M, N) tiles cannot give every SM two blocks, D is split across blocks.
    """
    rows_per_thread = 8 if M > 64 else 1
    bm = 16 * rows_per_thread
    tiles = -(-N // _BN) * -(-M // bm)
    steps = -(-D // _BK)
    splits = 1
    if tiles < 2 * sms:
        splits = max(1, min(-(-2 * sms // tiles), steps // 2))
    steps_per_split = -(-steps // splits)
    splits = -(-steps // steps_per_split)
    return rows_per_thread, splits, steps_per_split * _BK


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x: (M, D) bf16/f32; w_q: (D, N) int8; scales: (N,) f32 -> (M, N)."""
    if x.device.type == "cpu":
        return ref.int8_matmul_ref(x, w_q, scales)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"int8_matmul: x must be float32 or bfloat16, got {x.dtype}")
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError("int8_matmul: w_q must be int8 and scales float32")
    if x.ndim != 2 or w_q.ndim != 2 or scales.ndim != 1:
        raise ValueError("int8_matmul: x (M, D), w_q (D, N), scales (N,)")
    M, D = x.shape
    N = w_q.shape[1]
    if w_q.shape[0] != D or scales.shape[0] != N:
        raise ValueError(f"int8_matmul: shapes {tuple(x.shape)} {tuple(w_q.shape)} "
                         f"{tuple(scales.shape)} do not agree")
    if not (w_q.device == x.device == scales.device):
        raise ValueError("int8_matmul: x, w_q and scales must be on one device")
    if x.stride(1) != 1 or not w_q.is_contiguous() or not scales.is_contiguous():
        raise ValueError("int8_matmul: x needs unit column stride, w_q and "
                         "scales must be contiguous")
    if w_q.data_ptr() % 16:
        raise ValueError("int8_matmul: w_q must be 16-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rows_per_thread, splits, k_per_split = _plan(M, N, D, _sm_count(x.device))
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib = build.library("int8_matmul", _SIGNATURES)
    code = lib.int8_matmul_fwd(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        build.DTYPE_CODES[x.dtype], M, N, D, x.stride(0), splits, k_per_split,
        rows_per_thread, build.current_stream())
    build.check(lib, code, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def quantize_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8 quantization.

    w: (..., D, N) -- contraction dim D, output channels N (leading dims are
    stacked layers).  Returns (w_q int8 same shape, scales (..., N) f32),
    bit-identical to the JAX package's ``quantize_int8``.
    """
    wf = w.float()
    absmax = wf.abs().amax(dim=-2)                       # (..., N)
    # divide by a tensor, not the Python scalar: on CUDA, PyTorch turns
    # division by a scalar into multiplication by its rounded reciprocal,
    # which changes the last bit of some scales
    scales = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)
    # torch.round rounds half to even, as jnp.round
    w_q = torch.clamp(torch.round(wf / scales[..., None, :]), -127, 127).to(torch.int8)
    return w_q, scales
