"""K5 wrapper: the RWKV6 WKV recurrence (kernel in csrc/rwkv6_scan.cu).

The counterpart of the JAX package's ``kernels/rwkv6_scan.py``: r/k/v/w
(B, H, T, dh) f32 or bf16, u (H, dh), initial state s0 (B, H, dh, dh); returns
out (B, H, T, dh) in r's dtype and the final state in f32.  The kernel reads
r/k/v/w by stride, so (B, H, T, dh) views of the model's (B, T, H, dh)
projections cost no copy; out is allocated in (B, T, H, dh) memory and
returned as a (B, H, T, dh) view.  The final state goes to ``s_out`` when it
is given (it may be ``s0`` itself: the decode cache, updated in place).
Under autograd the caller also passes ``checkpoints``
((B, H, ceil(T / CHECKPOINT_EVERY), dh, dh) f32, ``checkpoint_shape``): the
kernel writes the state entering every chunk of CHECKPOINT_EVERY steps
there, which K5's backward (``rwkv6_scan_bwd``) recomputes each chunk from.
The serving calls pass none.

``plan`` splits each head's value columns across blocks from the static
shapes and the SM count alone, never from T or the state.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"rwkv6_scan_fwd": ([_P] * 8 + [_I] * 6 + [_L] * 19 + [_P, _P],
                                   ctypes.c_int)}
HEAD_DIMS = (16, 32, 64)
COLUMN_SLICES = (8, 16, 32)   # value columns of one block: at most a warp's lanes, so
                               # a warp's r/k/w reads share one row group's address
BLOCKS_PER_SM = 2              # the plan aims at this many blocks per SM
ROWS_PER_GROUP = 16            # key rows of the state one thread holds per column (csrc R)
CHECKPOINT_EVERY = ref.WKV_CHECKPOINT_EVERY   # steps between the states kept for the backward


class Plan(NamedTuple):
    jb: int          # value columns of one block: B * H * (dh / jb) blocks
    row_groups: int  # threads that share one column, ROWS_PER_GROUP key rows each


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, dh: int, sms: int = 132) -> Plan:
    """The widest column slice that still gives every SM BLOCKS_PER_SM
    blocks, else the narrowest (8 columns).  A wider slice stages r/k/w once
    for more columns and keeps a warp's reads on one row group, which
    outweighs the fuller waves of narrower slices at rwkv6-3b's prefill."""
    fits = [jb for jb in COLUMN_SLICES if jb <= dh]
    jb = next((jb for jb in reversed(fits) if B * H * (dh // jb) >= BLOCKS_PER_SM * sms),
              fits[0])
    return Plan(jb, dh // ROWS_PER_GROUP)


def checkpoint_shape(B: int, H: int, T: int, dh: int) -> tuple:
    """The ``checkpoints`` tensor of a (B, H, T, dh) call."""
    return (B, H, -(-T // CHECKPOINT_EVERY), dh, dh)


def _bht(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _check_state(name: str, s: torch.Tensor, B: int, H: int, dh: int):
    if s.shape != (B, H, dh, dh) or s.dtype != torch.float32:
        raise ValueError(f"rwkv6_scan: {name} must be ({B}, {H}, {dh}, {dh}) float32")
    if s.stride(3) != 1 or s.stride(2) != dh:
        raise ValueError(f"rwkv6_scan: each (dh, dh) block of {name} must be contiguous")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, s0: torch.Tensor, *, s_out=None, checkpoints=None):
    """r/k/v/w: (B, H, T, dh); u: (H, dh); s0: (B, H, dh, dh).

    Returns (out (B, H, T, dh), s_final (B, H, dh, dh) f32).
    """
    if checkpoints is not None and (
            checkpoints.shape != checkpoint_shape(*r.shape)
            or checkpoints.dtype != torch.float32 or not checkpoints.is_contiguous()):
        raise ValueError(f"rwkv6_scan: checkpoints must be {checkpoint_shape(*r.shape)} "
                         "float32, contiguous")
    if r.device.type == "cpu":
        out, s_final = ref.rwkv6_scan_ref(r, k, v, w, u, s0, checkpoints)
        if s_out is not None:
            s_out.copy_(s_final)
            s_final = s_out
        return out, s_final
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    if r.dtype not in build.DTYPE_CODES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise ValueError("rwkv6_scan: r, k, v, w must share one dtype, float32 or "
                         f"bfloat16; got {r.dtype} {k.dtype} {v.dtype} {w.dtype}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError("rwkv6_scan: r, k, v, w must all be (B, H, T, dh)")
    B, H, T, dh = r.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {dh} not in {HEAD_DIMS}")
    if u.shape != (H, dh):
        raise ValueError(f"rwkv6_scan: u must be ({H}, {dh})")
    u = u.to(torch.float32).contiguous()
    s0 = s0.to(torch.float32)
    _check_state("s0", s0, B, H, dh)
    if s_out is None:
        s_out = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    _check_state("s_out", s_out, B, H, dh)
    if any(t.device != r.device for t in (k, v, w, u, s0, s_out)) or (
            checkpoints is not None and checkpoints.device != r.device):
        raise ValueError("rwkv6_scan: all operands must be on one device")
    if any(t.stride(3) != 1 for t in (r, k, v, w)):
        raise ValueError("rwkv6_scan: the head dim of r, k, v, w must be contiguous")
    per16 = 16 // r.element_size()   # the kernel stages rows with 16-byte copies
    if any(t.data_ptr() % 16 or any(st % per16 for st in _bht(t)) for t in (r, k, v, w)):
        raise ValueError("rwkv6_scan: r, k, v, w rows must be 16-byte aligned")
    out = torch.empty((B, T, H, dh), dtype=r.dtype, device=r.device).transpose(1, 2)
    p = plan(B, H, dh, build.sm_count(r.device.index))
    lib = build.library("rwkv6_scan", _SIGNATURES)
    code = lib.rwkv6_scan_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), out.data_ptr(), s_out.data_ptr(), build.DTYPE_CODES[r.dtype],
        B, H, T, dh, p.jb, *_bht(r), *_bht(k), *_bht(v), *_bht(w), *_bht(out),
        s0.stride(0), s0.stride(1), s_out.stride(0), s_out.stride(1),
        None if checkpoints is None else checkpoints.data_ptr(), build.current_stream())
    build.check(lib, code, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return out, s_out


rwkv6_scan.launches = 0
