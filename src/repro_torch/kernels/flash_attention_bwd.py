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
array.

``plan`` chooses the path as K1's forward does: bf16 in a layout the
16-byte copies can take (every (b, s, head) stride of q, k, v, o and do a
multiple of 8 elements, 16-byte aligned bases: the model's layouts) runs
"mma", FlashAttention-2's backward on the tensor cores; float32 always runs
"fma", true float32 on the CUDA cores for the 2e-4 parity tests, as does
bf16 in any other layout.  ``dq_plan`` splits the mma path's dq pass over
the kv range when its (q tile, head, batch) blocks alone would leave SMs
idle, from the static shapes and the SM count alone; the splits' partial dq
are summed in a fixed order, so two calls give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import _bsh, _copy_aligned

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {"flash_attention_bwd": (
    [_P] * 10 + [_I] * 8 + [_L] * 24 + [_I, _I, _F, _I, _I, _P, _P], ctypes.c_int)}
HEAD_DIMS = (32, 64, 80, 128)
PATHS = {"fma": 0, "mma": 1}   # csrc/flash_attention_bwd.cu BWD_PATH_*
TILE = 64            # q rows and kv rows of a tile (csrc MQ, MKV); a split is a multiple
BLOCKS_PER_SM = 2    # the dq split aims at this many blocks per SM (two fit: 102 KB each)


class DqPlan(NamedTuple):
    splits: int    # blocks along the kv axis for each (q tile, q head, batch)
    chunk: int     # keys per split, a multiple of TILE; splits * chunk >= T


def plan(dtype: torch.dtype, copy_aligned: bool) -> str:
    """"mma" (bf16 in 16-byte-copyable layout) or "fma" (everything else)."""
    return "mma" if dtype == torch.bfloat16 and copy_aligned else "fma"


def plan_call(q, k, v, o, do) -> str:
    """``plan`` for the tensors of one call on the card."""
    return plan(q.dtype, _copy_aligned(q, k, v, o, do))


@functools.lru_cache(maxsize=None)
def dq_plan(B: int, H: int, Sq: int, T: int, sms: int = 132) -> DqPlan:
    """One split where the B*H*(q tiles) blocks fill the card; else the kv
    tiles cut into chunks so that the blocks give every SM about
    BLOCKS_PER_SM, from the shapes and the SM count alone."""
    blocks = B * H * -(-Sq // TILE)
    kv_tiles = -(-T // TILE)
    if blocks >= sms:
        return DqPlan(1, kv_tiles * TILE)
    want = min(-(-BLOCKS_PER_SM * sms // blocks), kv_tiles)
    chunk = -(-kv_tiles // want) * TILE
    return DqPlan(-(-T // chunk), chunk)


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
    path = plan_call(q, k, v, o, do)
    split = (dq_plan(B, H, Sq, T, build.sm_count(q.device.index)) if path == "mma"
             else DqPlan(1, T))
    partial = (torch.empty((split.splits, B, H, Sq, dh), dtype=torch.float32,
                           device=q.device) if split.splits > 1 else None)
    lib = build.library("flash_attention_bwd", _SIGNATURES)
    code = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        build.DTYPE_CODES[q.dtype], PATHS[path], B, H, K, Sq, T, dh,
        *_bsh(q), *_bsh(k), *_bsh(v), *_bsh(o), *_bsh(do), *_bsh(dq), *_bsh(dk), *_bsh(dv),
        int(causal), -1 if window is None else int(window), dh ** -0.5,
        split.splits, split.chunk, None if partial is None else partial.data_ptr(),
        build.current_stream())
    build.check(lib, code, f"flash_attention_bwd ({path})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
