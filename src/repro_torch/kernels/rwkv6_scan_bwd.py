"""K5 backward wrapper: the reverse WKV scan (kernels in csrc/rwkv6_scan_bwd.cu).

The gradients of ``rwkv6_scan``: from dout (B, H, T, dh) and the final
state's gradient ds_final (B, H, dh, dh) or None, returns (dr, dk, dv, dw,
du (H, dh), ds0 (B, H, dh, dh)).  The JAX package has no kernel here: it
differentiates its ``lax.scan`` over ``rwkv6_wkv_step`` by autodiff.  The
card takes float32 only (the model feeds K5 float32) and needs the forward's
``checkpoints`` (the state entering every CHECKPOINT_EVERY steps), from
which it recomputes each chunk's states.  r/k/v/w and dout are read by
stride (unit head-dim stride); dr, dk, dv and dw are allocated in
(B, T, H, dh) memory and returned as (B, H, T, dh) views, the layout of the
model's (B, T, D) projections.

``plan`` splits each head's value columns across blocks from the shapes
alone, never from the data, and states what the card holds of them: the
threads and shared bytes of a block, the blocks an SM and the waves.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.rwkv6_scan import CHECKPOINT_EVERY, HEAD_DIMS, _bht, checkpoint_shape

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"rwkv6_scan_bwd": ([_P] * 15 + [_I] * 4 + [_L] * 27 + [_P], ctypes.c_int)}
COLUMN_SLICE = 16   # value columns of one block (csrc JB)
THREADS_PER_ROW = 4  # threads of one state row, 4 columns each (csrc JB / QCOLS)
HALF_CHUNK = 8       # states held at once (csrc HALF)
SM_SHARED_BYTES = 233_472   # shared memory of an H100 SM (228 KB)
BLOCK_RESERVED_BYTES = 1024  # shared memory the card reserves for each block
SM_THREADS = 2048


class Plan(NamedTuple):
    jb: int             # value columns of one block
    slices: int         # blocks per head, one cluster, their partial dr, dk, dw summed in order
    chunks: int         # chunks of CHECKPOINT_EVERY steps, recomputed last first
    threads: int        # threads of one block: THREADS_PER_ROW a state row
    smem_bytes: int     # dynamic shared memory of one block
    blocks_per_sm: int  # blocks an SM holds by shared memory and threads
    waves: int          # rounds of blocks on ``sms`` SMs


def smem_bytes(dh: int) -> int:
    """csrc scan_smem_floats: HALF_CHUNK states of dh x COLUMN_SLICE floats, two
    buffers of a chunk's r, k, w (dh wide) and v, dout (the slice's columns),
    and two buffers of a half-chunk's partial dr, dk, dw (dh wide)."""
    chunk_inputs = 3 * CHECKPOINT_EVERY * dh + 2 * CHECKPOINT_EVERY * COLUMN_SLICE
    partials = 3 * HALF_CHUNK * dh
    return 4 * (HALF_CHUNK * dh * COLUMN_SLICE + 2 * chunk_inputs + 2 * partials)


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, T: int, dh: int, sms: int = 132) -> Plan:
    """Slices of COLUMN_SLICE value columns, B * H * slices blocks of 4 dh
    threads, the slices of a head one cluster: at rwkv6-3b's training shape
    (B 2, H 40, dh 64) 320 blocks of 256 threads and 73,728 shared bytes,
    three an SM, one wave on 132 SMs."""
    slices = dh // COLUMN_SLICE
    threads = THREADS_PER_ROW * dh
    smem = smem_bytes(dh)
    per_sm = min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES), SM_THREADS // threads)
    blocks = B * H * slices
    return Plan(COLUMN_SLICE, slices, -(-T // CHECKPOINT_EVERY), threads, smem, per_sm,
                -(-blocks // (per_sm * sms)))


def rwkv6_scan_bwd(r, k, v, w, u, s0, dout, ds_final=None, *, checkpoints=None):
    """r/k/v/w, dout: (B, H, T, dh); u: (H, dh); s0, ds_final: (B, H, dh, dh).

    Returns (dr, dk, dv, dw (B, H, T, dh), du (H, dh), ds0 (B, H, dh, dh)).
    ``checkpoints``: the forward's (``rwkv6_scan(..., checkpoints=)``); the
    plain version on the CPU recomputes every state from s0 instead.
    """
    if r.device.type == "cpu":
        return ref.rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dout, ds_final)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd: unsupported device {r.device}")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, dout)):
        raise ValueError("rwkv6_scan_bwd: r, k, v, w and dout must be float32 (the model "
                         f"feeds K5 float32); got {[t.dtype for t in (r, k, v, w, dout)]}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w, dout)):
        raise ValueError("rwkv6_scan_bwd: r, k, v, w and dout must all be (B, H, T, dh)")
    B, H, T, dh = r.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan_bwd: head dim {dh} not in {HEAD_DIMS}")
    if u.shape != (H, dh):
        raise ValueError(f"rwkv6_scan_bwd: u must be ({H}, {dh})")
    if checkpoints is None or checkpoints.shape != checkpoint_shape(B, H, T, dh) \
            or checkpoints.dtype != torch.float32 or not checkpoints.is_contiguous():
        raise ValueError("rwkv6_scan_bwd: needs the forward's checkpoints, "
                         f"{checkpoint_shape(B, H, T, dh)} float32, contiguous")
    if ds_final is not None and (ds_final.shape != (B, H, dh, dh)
                                 or ds_final.dtype != torch.float32):
        raise ValueError(f"rwkv6_scan_bwd: ds_final must be ({B}, {H}, {dh}, {dh}) float32")
    u = u.to(torch.float32).contiguous()
    ds_final = None if ds_final is None else ds_final.contiguous()
    dout = dout if dout.stride(3) == 1 else dout.contiguous()
    if any(t.device != r.device for t in (k, v, w, u, dout, checkpoints)) or (
            ds_final is not None and ds_final.device != r.device):
        raise ValueError("rwkv6_scan_bwd: all operands must be on one device")
    if any(t.stride(3) != 1 for t in (r, k, v, w)):
        raise ValueError("rwkv6_scan_bwd: the head dim of r, k, v, w must be contiguous")
    p = plan(B, H, T, dh, build.sm_count(r.device.index))
    dr, dk, dv, dw = (torch.empty((B, T, H, dh), dtype=torch.float32, device=r.device)
                      .transpose(1, 2) for _ in range(4))
    du = torch.empty((H, dh), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    # each slice's partial du, summed in slice order by the second kernel
    du_part = torch.empty((p.slices, B, H, dh), dtype=torch.float32, device=r.device)
    lib = build.library("rwkv6_scan_bwd", _SIGNATURES)
    code = lib.rwkv6_scan_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        checkpoints.data_ptr(), dout.data_ptr(),
        None if ds_final is None else ds_final.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ds0.data_ptr(), du_part.data_ptr(), B, H,
        T, dh, *_bht(r), *_bht(k), *_bht(v), *_bht(w), *_bht(dout), *_bht(dr), *_bht(dk),
        *_bht(dv), *_bht(dw), build.current_stream())
    build.check(lib, code, "rwkv6_scan_bwd")
    rwkv6_scan_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


rwkv6_scan_bwd.launches = 0
