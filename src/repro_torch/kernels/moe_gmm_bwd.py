"""K4 backward wrapper: the gradients of the grouped (expert) GEMM (kernels in
csrc/moe_gmm_bwd.cu).

For out[e] = x[e] @ w[e] with x (E, C, D), w (E, D, F) and rows at or past
``group_sizes[e]`` counting as zero, from dy (E, C, F):
  dx[e] = dy[e] @ w[e]^T, rows at or past group_sizes[e] zero, in x's dtype;
  dw[e] = x~[e]^T @ dy[e], x~ = x with those rows zeroed, in w's dtype.
The JAX package has no kernel here: it differentiates the model's expert
einsums by autodiff.  ``need_dx`` and ``need_dw`` say which gradients to
compute; the other comes back as None.  group_sizes is read on the device,
and x, w and dy by stride (unit stride on the last axis).

``plan`` chooses each gradient's path from the dtype alone (nothing is
tried and nothing falls back):
  fma    float32, both gradients (true float32 FMAs for the parity tests);
  wgmma  bf16, both: dx on K4 forward's TMA + wgmma body with w^T read
         K-major in place (dy and w must be tensor maps, at most DX_MAX_E
         experts), dw on a persistent TMA + wgmma kernel reading x and dy
         MN-major in place over the live rows and storing dw through TMA (x
         and dy must be tensor maps); the wrapper raises otherwise.

bf16 dx runs the body's stream-K schedule on ``dx_grid`` blocks: the full
waves of live tiles whole, then each tile left cut at the same k-steps into
a piece for each of ``grid // tiles left`` blocks (``dx_units`` lists each
block's units as the kernel walks them; the live tile count comes from
group_sizes on the device, never the host).  A tile cut across blocks is
summed by its first block from the others' f32 sums in a workspace the
wrapper allocates here (``workspace_bytes``).  Its shared tile list holds
at most DX_MAX_E experts.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.moe_gmm import _map_ok

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"moe_gmm_bwd": ([_P] * 7 + [_I] * 5 + [_L] * 6 + [_I] * 4 + [_P],
                               ctypes.c_int)}
PATHS = {"fma": 0, "wgmma": 1}   # csrc/moe_gmm_bwd.cu GBWD_PATH_*
DW_BK = 64   # live rows of one k-tile (one TMA stage) of dw's wgmma path (csrc DW_BK)
# dx's wgmma path (csrc/gmm_wgmma.cuh): its tile, k-step, shortest stream-K
# piece and one block's f32 sums of a tile in the workspace
DX_BM, DX_BN, DX_BK = 128, 256, 64
DX_MAX_E = 256
SK_MIN_STEPS = 16
SK_PART_BYTES = DX_BM * DX_BN * 4


class Plan(NamedTuple):
    dx: str   # fma / wgmma
    dw: str   # fma / wgmma


def plan(dtype: torch.dtype) -> Plan:
    """The paths of dx and dw for operands of ``dtype``."""
    return Plan("fma", "fma") if dtype == torch.float32 else Plan("wgmma", "wgmma")


def plan_call(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> Plan:
    """``plan`` for the tensors of one call."""
    return plan(x.dtype)


def dx_grid(E: int, C: int, D: int, F: int, sms: int) -> int:
    """Blocks of bf16 dx: one an SM, or one a k-step of every row tile of
    every expert when those are fewer."""
    tiles = E * -(-C // DX_BM) * -(-D // DX_BN)
    return max(1, min(sms, tiles * -(-F // DX_BK)))


def workspace_bytes(grid: int) -> int:
    """dx's workspace: a slot of f32 sums and a flag for each block."""
    return grid * (SK_PART_BYTES + 4)


class Schedule(NamedTuple):
    rounds: int   # full rounds of ``grid`` whole tiles
    left: int     # tiles left after them
    pieces: int   # pieces each of those is cut into, one a block


def dx_schedule(tiles: int, ktiles: int, grid: int) -> Schedule:
    """csrc/gmm_wgmma.cuh:sk_schedule for ``tiles`` live tiles of ``ktiles``
    k-steps on ``grid`` blocks: each tile left after the full rounds in
    grid // left pieces, none below SK_MIN_STEPS k-steps."""
    rounds, left = divmod(tiles, grid)
    return Schedule(rounds, left,
                    max(1, min(grid // left, ktiles // SK_MIN_STEPS)) if left else 0)


class Unit(NamedTuple):
    tile: int    # live tile, in the kernel's order
    k0: int      # first k-step
    k1: int      # one past the last
    kind: str    # whole / part (sums to the block's slot) / head (adds the parts)
    parts: tuple = ()   # head: the blocks whose slots it adds, in order


def dx_units(tiles: int, ktiles: int, grid: int) -> list:
    """Each block's units in the order csrc/gmm_wgmma.cuh:sk_unit gives them."""
    s = dx_schedule(tiles, ktiles, grid)
    out = []
    for b in range(grid):
        units = [Unit(r * grid + b, 0, ktiles, "whole") for r in range(s.rounds)]
        if b < s.left * s.pieces:
            i, j = divmod(b, s.pieces)
            kind = "part" if j else "head" if s.pieces > 1 else "whole"
            parts = tuple(range(b + 1, b + s.pieces)) if kind == "head" else ()
            units.append(Unit(s.rounds * grid + i, j * ktiles // s.pieces,
                              (j + 1) * ktiles // s.pieces, kind, parts))
        out.append(units)
    return out


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, group_sizes, dy: torch.Tensor, *,
                need_dx: bool = True, need_dw: bool = True):
    """x: (E, C, D); w: (E, D, F); group_sizes: (E,) int or None; dy: (E, C, F).

    Returns (dx (E, C, D) or None, dw (E, D, F) or None).
    """
    if x.device.type == "cpu":
        dx, dw = ref.moe_gmm_bwd_ref(x, w, group_sizes, dy)
        return dx if need_dx else None, dw if need_dw else None
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm_bwd: unsupported device {x.device}")
    if x.dtype not in build.DTYPE_CODES or w.dtype != x.dtype or dy.dtype != x.dtype:
        raise ValueError("moe_gmm_bwd: x, w and dy must share one dtype, float32 or "
                         f"bfloat16; got {x.dtype} {w.dtype} {dy.dtype}")
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError("moe_gmm_bwd: x (E, C, D), w (E, D, F), dy (E, C, F)")
    E, C, D = x.shape
    F = w.shape[2]
    if w.shape[:2] != (E, D) or dy.shape != (E, C, F):
        raise ValueError(f"moe_gmm_bwd: shapes {tuple(x.shape)} {tuple(w.shape)} "
                         f"{tuple(dy.shape)} do not agree")
    if group_sizes is not None:
        if group_sizes.shape != (E,):
            raise ValueError(f"moe_gmm_bwd: group_sizes must be ({E},)")
        group_sizes = group_sizes.to(torch.int32).contiguous()
    if not (x.device == w.device == dy.device and (group_sizes is None
                                                   or group_sizes.device == x.device)):
        raise ValueError("moe_gmm_bwd: x, w, dy and group_sizes must be on one device")
    dy = dy if dy.stride(2) == 1 else dy.contiguous()
    if x.stride(2) != 1 or w.stride(2) != 1:
        raise ValueError("moe_gmm_bwd: the last axis of x and w must be contiguous")
    if x.dtype == torch.bfloat16 and any(
            s % 8 for s in (D, F, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
                            dy.stride(0), dy.stride(1), x.data_ptr() // 2, w.data_ptr() // 2,
                            dy.data_ptr() // 2)):
        raise ValueError("moe_gmm_bwd: bf16 needs D, F and the row strides to be "
                         "multiples of 8 and 16-byte aligned x, w and dy")
    if x.dtype == torch.bfloat16 and need_dx and not (
            E <= DX_MAX_E and _map_ok(dy) and _map_ok(w)):
        raise ValueError(f"moe_gmm_bwd: bf16 dx reads dy and w as tensor maps, at most "
                         f"{DX_MAX_E} experts; got E {E}, strides {dy.stride()} "
                         f"{w.stride()}")
    if x.dtype == torch.bfloat16 and need_dw and not (_map_ok(x) and _map_ok(dy)):
        raise ValueError(f"moe_gmm_bwd: bf16 dw reads x and dy as tensor maps; got "
                         f"strides {x.stride()} {dy.stride()}")
    dx = torch.empty((E, C, D), dtype=x.dtype, device=x.device) if need_dx else None
    dw = torch.empty((E, D, F), dtype=w.dtype, device=x.device) if need_dw else None
    if dx is None and dw is None:
        return None, None
    p = plan_call(x, w, dy)
    sms = build.sm_count(x.device.index)
    grid = dx_grid(E, C, D, F, sms) if need_dx and p.dx == "wgmma" else 0
    if grid * -(-F // DX_BK) >= 2 ** 31:
        raise ValueError(f"moe_gmm_bwd: bf16 dx's schedule counts k-steps in 32 bits; "
                         f"F {F} on {grid} blocks is too large")
    ws = (torch.empty(workspace_bytes(grid), dtype=torch.uint8, device=x.device)
          if grid else None)
    lib = build.library("moe_gmm_bwd", _SIGNATURES)
    code = lib.moe_gmm_bwd(
        x.data_ptr(), w.data_ptr(),
        group_sizes.data_ptr() if group_sizes is not None else None, dy.data_ptr(),
        None if dx is None else dx.data_ptr(), None if dw is None else dw.data_ptr(),
        None if ws is None else ws.data_ptr(),
        build.DTYPE_CODES[x.dtype], E, C, D, F, x.stride(0), x.stride(1), w.stride(0),
        w.stride(1), dy.stride(0), dy.stride(1), PATHS[p.dx], PATHS[p.dw], sms, grid,
        build.current_stream())
    build.check(lib, code, f"moe_gmm_bwd (dx {p.dx}, dw {p.dw})")
    moe_gmm_bwd.launches += 1
    return dx, dw


moe_gmm_bwd.launches = 0
