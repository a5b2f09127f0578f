"""K4 wrapper: grouped (expert) GEMM (kernel in csrc/moe_gmm.cu).

The counterpart of the JAX package's ``kernels/moe_gmm.py``: out[e] =
x[e] @ w[e] for x (E, C, D) and w (E, D, F), f32 or bf16, accumulated in
float32, in x's dtype.  Rows at or past ``group_sizes[e]`` count as zero.
The kernel reads ``group_sizes`` on the device, so the launch needs no host
sync and a CUDA graph can capture it, and it reads x and w by stride.

``plan`` chooses the kernel's path from the dtype, the shape and the
layout, the same way for every call of that dtype, shape and layout
(nothing is tried and nothing falls back), and the mma path's D splits
from the static shapes and the SM count, never from ``group_sizes``:
  fma    float32, always (true float32 FMAs for the parity tests).
  wgmma  bf16 with C >= WGMMA_MIN_C (prefill: 128-row warpgroup tiles) and
         operands TMA can address: TMA ring + wgmma tensor cores over the
         live tiles, a persistent grid of one block per SM.
  mma    bf16 with C <= MMA_MAX_C (decode), at most MMA_MAX_E experts and
         a w TMA can address: split-D over (live expert, D split, column
         tile) items listed on the device, a TMA ring of weight boxes,
         mma.sync with the weight as the 16-row operand and the x rows as
         n = 8 tiles.
  wmma   bf16 otherwise (a layout TMA cannot take, or more experts than
         the tensor-core paths list): WMMA tiles, dead row tiles skipped.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"moe_gmm_fwd": ([_P] * 5 + [_I] * 5 + [_L] * 4 + [_I] * 4 + [_P],
                               ctypes.c_int)}
PATHS = {"fma": 0, "mma": 1, "wgmma": 2, "wmma": 3}   # csrc/moe_gmm.cu GMM_PATH_*
WGMMA_MIN_C = 33     # C at or above takes the wgmma path in bf16
WGMMA_MAX_E = 1024   # experts the wgmma path's shared-memory tile list holds
_WG_BM, _WG_BN = 128, 256   # wgmma: output tile
MMA_MAX_C = 32       # x rows the mma path takes: four n = 8 tiles
MMA_MAX_E = 1024     # experts its shared-memory list of live experts holds
MMA_BN, MMA_BK = 128, 64    # mma: columns of one item, depth of one ring stage
MMA_ITEMS_PER_SM = 8        # items the split count aims at, per SM
MMA_MIN_STAGES = 4          # a split streams at least this many stages (one ring)
MMA_MAX_COUNTERS = 1 << 16  # (expert, column tile) counters of a split call


class Plan(NamedTuple):
    path: str          # fma / mma / wgmma / wmma
    splits: int        # D splits (mma; 1 on the other paths)
    k_per_split: int   # depth of each split, a multiple of MMA_BK on mma; D elsewhere


@functools.lru_cache(maxsize=None)
def plan(E: int, C: int, D: int, F: int, dtype: torch.dtype, tma_ok: bool = True,
         sms: int = 132) -> Plan:
    """The path of an (E, C, D) x (E, D, F) call, and the mma path's D splits.

    ``tma_ok``: the operands the path copies with TMA (x and w at C > 32,
    w alone below) are 16-byte aligned, with row and expert strides that are
    multiples of 8 elements and ordered as a tensor map needs them
    (``tma_addressable``).  The mma path's splits aim at MMA_ITEMS_PER_SM
    work items per SM when min(E, C) experts are live (C rows admit at most
    C live experts at decode, one routed row each), each split at least one
    ring of stages deep.
    """
    if dtype == torch.float32:
        return Plan("fma", 1, D)
    if C >= WGMMA_MIN_C and E <= WGMMA_MAX_E and D % 8 == 0 and F % 8 == 0 and tma_ok:
        return Plan("wgmma", 1, D)
    if C > MMA_MAX_C or E > MMA_MAX_E or D % 8 or F % 8 or not tma_ok:
        return Plan("wmma", 1, D)
    steps = -(-D // MMA_BK)
    n_tiles = -(-F // MMA_BN)
    want = -(-MMA_ITEMS_PER_SM * sms // (min(E, C) * n_tiles))
    splits = max(1, min(want, steps // MMA_MIN_STAGES))
    if E * n_tiles > MMA_MAX_COUNTERS:
        splits = 1
    per = -(-steps // splits) * MMA_BK
    return Plan("mma", -(-D // per), per)


def mma_grid(E: int, C: int, F: int, p: Plan) -> int:
    """Blocks of the mma path: one per work item of min(E, C) live experts
    (blocks past the live items exit; more live experts loop)."""
    return min(E, C) * -(-F // MMA_BN) * p.splits


def _map_ok(t: torch.Tensor) -> bool:
    """A 3-D tensor as a tensor map: a 16-byte aligned base, a unit last
    stride, the other two multiples of 8 elements, each stride at least the
    extent of the axes inside it."""
    s0, s1, s2 = t.stride()
    return (t.data_ptr() % 16 == 0 and s2 == 1 and s0 % 8 == 0 and s1 % 8 == 0
            and s1 >= t.shape[2] and s0 >= t.shape[1] * s1)


def tma_addressable(x: torch.Tensor, w: torch.Tensor) -> bool:
    """x (E, C, D) and w (E, D, F) as 3-D tensor maps."""
    return _map_ok(x) and _map_ok(w)


def plan_call(x: torch.Tensor, w: torch.Tensor, sms: int = 132) -> Plan:
    """``plan`` for the tensors of one call (the layout is read only where it
    decides the path: x and w for wgmma, w for mma)."""
    E, C, D = x.shape
    tma_ok = x.dtype == torch.bfloat16 and (
        tma_addressable(x, w) if C >= WGMMA_MIN_C else _map_ok(w))
    return plan(E, C, D, w.shape[2], x.dtype, tma_ok, sms)


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
    sms = build.sm_count(x.device.index)
    p = plan_call(x, w, sms)
    # float32 partial sums of the mma path's D splits, summed in the kernel
    part = (torch.empty((p.splits, E, C, F), dtype=torch.float32, device=x.device)
            if p.splits > 1 else None)
    grid = mma_grid(E, C, F, p) if p.path == "mma" else wgmma_grid(E, C, F, sms)
    lib = build.library("moe_gmm", _SIGNATURES)
    code = lib.moe_gmm_fwd(
        x.data_ptr(), w.data_ptr(),
        group_sizes.data_ptr() if group_sizes is not None else None, out.data_ptr(),
        part.data_ptr() if part is not None else None,
        build.DTYPE_CODES[x.dtype], E, C, D, F, x.stride(0), x.stride(1), w.stride(0),
        w.stride(1), PATHS[p.path], grid, p.splits, p.k_per_split, build.current_stream())
    build.check(lib, code, f"moe_gmm ({p.path})")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
