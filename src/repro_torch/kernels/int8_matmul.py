"""K3 wrapper: weight-only int8 GEMM (kernel in csrc/int8_matmul.cu).

The counterpart of the JAX package's ``kernels/int8_matmul.py``: x (M, D)
f32/bf16 times w_q (D, N) int8, accumulated in float32, times the
per-output-channel f32 ``scales``, in x's dtype.  ``quantize_int8`` makes
w_q and scales bit for bit as the JAX package does.

``plan`` chooses the kernel's path from the dtype and the shape, the same
way for every call of that dtype and shape (nothing is tried and nothing
falls back):
  fma     float32, always (true float32 FMAs for the 1e-3 parity tests); and
          bf16 shapes the two below cannot take (N not a multiple of 16, or
          x rows not 16-byte aligned), e.g. the ragged (300, 520, 136).
  stream  bf16 with M <= STREAM_MAX_M (decode): a weight stream on the CUDA
          cores, D split across blocks to fill the SMs.
  wgmma   bf16 with M > STREAM_MAX_M (prefill): TMA ring + wgmma tensor cores.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"int8_matmul_fwd": (
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I, _P], ctypes.c_int)}
PATHS = {"fma": 0, "stream": 1, "wgmma": 2}   # csrc/int8_matmul.cu INT8_PATH_*
STREAM_MAX_M = 8      # M at or below takes the stream path in bf16
_BK = 32              # fma: depth of one step of the D loop
_BN = 128             # fma: output columns of one block
_STRIP = 512          # stream: output columns of one block (32 lanes x 16)
_STREAM_ROWS = 64     # stream: rows of one block step (8 warps x 8); splits are multiples
_STREAM_MAX_ROWS = 4096   # stream: rows of one split (its x slice fits the sum buffer)
_WG_TILE = 128        # wgmma: output tile is 128 x 128


class Plan(NamedTuple):
    path: str          # "fma", "stream" or "wgmma"
    splits: int        # blocks along D (a second kernel adds them, in order)
    k_per_split: int   # rows of D per split; splits * k_per_split >= D
    tile: int          # fma: rows per thread (1 or 8); stream: M padded (1, 2, 4, 8);
                       # wgmma: blocks per SM (1 or 2)


def _fma_plan(M: int, N: int, D: int, sms: int) -> Plan:
    """Large M takes 128-row tiles; skinny M 16-row tiles.  When the (M, N)
    tiles cannot give every SM two blocks, D is split across blocks."""
    rows_per_thread = 8 if M > 64 else 1
    bm = 16 * rows_per_thread
    tiles = -(-N // _BN) * -(-M // bm)
    steps = -(-D // _BK)
    splits = 1
    if tiles < 2 * sms:
        splits = max(1, min(-(-2 * sms // tiles), steps // 2))
    steps_per_split = -(-steps // splits)
    splits = -(-steps // steps_per_split)
    return Plan("fma", splits, steps_per_split * _BK, rows_per_thread)


def _stream_plan(M: int, N: int, D: int, sms: int) -> Plan:
    """About two blocks per SM: N in 512-column strips, D in splits of a
    multiple of 64 rows (at most 4096)."""
    strips = -(-N // _STRIP)
    groups = -(-D // _STREAM_ROWS)
    want = max(1, min(-(-2 * sms // strips), groups))
    k_per_split = min(-(-groups // want) * _STREAM_ROWS, _STREAM_MAX_ROWS)
    tile = 1 << (M - 1).bit_length()          # 1, 2, 4 or 8
    return Plan("stream", -(-D // k_per_split), k_per_split, tile)


def plan(M: int, N: int, D: int, dtype: torch.dtype, sms: int = 132,
         x_row_aligned: bool = True) -> Plan:
    """The path and the D split of an (M, D) x (D, N) call.

    ``x_row_aligned``: x's base and row stride are 16-byte aligned, as TMA
    needs them.  ``sms`` is the card's SM count (132 on an H100 SXM).
    """
    if dtype == torch.float32 or N % 16:
        return _fma_plan(M, N, D, sms)
    if M <= STREAM_MAX_M:
        return _stream_plan(M, N, D, sms)
    if x_row_aligned:
        # two blocks per SM once the grid has two 128 x 128 tiles per SM
        tiles = -(-M // _WG_TILE) * -(-N // _WG_TILE)
        return Plan("wgmma", 1, D, 2 if tiles >= 2 * sms else 1)
    return _fma_plan(M, N, D, sms)


def plan_call(x: torch.Tensor, w_q: torch.Tensor) -> Plan:
    """``plan`` for the tensors of one call on the card."""
    M, D = x.shape
    aligned = x.data_ptr() % 16 == 0 and (x.stride(0) * x.element_size()) % 16 == 0
    return plan(M, w_q.shape[1], D, x.dtype, build.sm_count(x.device.index), aligned)


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
    p = plan_call(x, w_q)
    partial = (torch.empty((p.splits, M, N), dtype=torch.float32, device=x.device)
               if p.splits > 1 else None)
    lib = build.library("int8_matmul", _SIGNATURES)
    code = lib.int8_matmul_fwd(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        build.DTYPE_CODES[x.dtype], M, N, D, x.stride(0), PATHS[p.path], p.splits,
        p.k_per_split, p.tile, build.current_stream())
    build.check(lib, code, f"int8_matmul ({p.path})")
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
