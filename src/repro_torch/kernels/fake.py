"""What each kernel wrapper does on a tensor that holds no data, and on a
DTensor.

The dry-run (``launch/dryrun.py``) traces a step on fake tensors, sharded as
DTensors over a mesh of fake ranks.  There a wrapper of ``kernels/ops.py``
launches nothing and runs no plain version (at prefill_32k the plain
attention would build (B, H, 32768, 32768) scores and make the memory
prediction false): it returns empty outputs of the shapes, dtypes and
layouts the CUDA kernel returns, and reports the operations and bytes of the
call to the dry-run's tracer (``distributed/stats.py``).

Operations are counted as the JAX package's XLA program counts its
contractions, two per multiply-add of a dense product: its attention is the
chunked dense softmax, so K1 counts every (query, key) pair of keys padded
to the 512-key blocks it walks, and K2 every cache entry; its expert FFN is
an einsum over the whole capacity, so K4 counts every row; its WKV
recurrence is a scan whose one contraction a step is r against the state.
Bytes are each operand read once and each output written once.

Sharding rules, one per kernel, for DTensor operands.  A rule names the
axes along which the kernel's work is independent or a sum:
  K1 and its backward: batch and heads (q heads with their kv heads; where
      the kv heads do not divide the mesh dim but it is a multiple of them,
      the q heads alone, each rank reading its one kv head, and dk, dv
      summed over the mesh dim);
  K2: batch and kv heads; a cache sharded along its sequence gives a
      Partial output (each shard attends over its part, the parts are
      summed: GSPMD's split-KV decode, whose softmax statistics are small);
  K3: rows M and columns N stay sharded; the contraction D gives Partial;
  K4: experts, capacity rows and F stay sharded; D gives Partial (forward);
      in the backward C and F give Partial dw and dx, D stays sharded;
  K5 and its backward: batch and heads (u's heads with them; du is a
      Partial sum over the batch).
On each mesh dim, the first operand sharded along one of the rule's axes
picks it; every operand is redistributed to that shard (or to Replicate
where it does not take part, or where the axis does not divide), so an
operand sharded any other way is gathered first, as GSPMD gathers it.  A
Partial output is summed (all-reduced) as the call returns.

A DTensor over real shards takes the same redistribution, with the kernel's
own wrapper (``real=True``) in place of the fake local call: on CUDA shards
the kernel runs, on CPU shards its plain version.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.distributed.rules import summed
from repro_torch.kernels.decode_attention import decode_attention as _decode_kernel
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd as _flash_bwd_kernel
from repro_torch.kernels.int8_matmul import int8_matmul as _int8_kernel
from repro_torch.kernels.moe_gmm import moe_gmm as _gmm_kernel
from repro_torch.kernels.moe_gmm_bwd import moe_gmm_bwd as _gmm_bwd_kernel
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _rwkv6_kernel
from repro_torch.kernels.rwkv6_scan_bwd import rwkv6_scan_bwd as _rwkv6_bwd_kernel

ATTN_BLOCK_KV = 512   # the JAX package's attention walks keys in blocks of 512


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _count(name: str, flops: float, nbytes: int, outs=()) -> None:
    """Report a call to every tracer on the dispatch mode stack (the stack,
    unlike a thread-local, follows the autograd engine into its threads);
    ``outs``: the call's results, whose bytes a tracer may read too."""
    for mode in _get_current_dispatch_mode_stack():
        count = getattr(mode, "count_kernel", None)
        if count is not None:
            count(name, flops, nbytes, _nbytes(*outs))


# --- the local calls: shapes, dtypes, layouts and counts ----------------------


def _flash(q, k, v, *, causal, window, return_lse):
    B, H, Sq, dh = q.shape
    T = k.shape[2]
    tp = -(-T // ATTN_BLOCK_KV) * ATTN_BLOCK_KV
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _count("flash_attention", 4.0 * B * H * Sq * tp * dh, _nbytes(q, k, v, out, lse),
           (out, lse) if return_lse else (out,))
    return (out, lse) if return_lse else (out,)


def _flash_bwd(q, k, v, o, lse, do, *, causal, window):
    B, H, Sq, dh = q.shape
    K, T = k.shape[1], k.shape[2]
    tp = -(-T // ATTN_BLOCK_KV) * ATTN_BLOCK_KV
    dq = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, T, K, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, T, K, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    # s, dv, dp, dq and dk: five products over every (query, key) pair
    _count("flash_attention_bwd", 10.0 * B * H * Sq * tp * dh,
           _nbytes(q, k, v, o, lse, do, dq, dk, dv), (dq, dk, dv))
    return dq, dk, dv


def _decode(q, k_cache, v_cache, lengths, *, window):
    B, K, G, dh = q.shape
    S = k_cache.shape[2]
    out = torch.empty((B, K, G, dh), dtype=q.dtype, device=q.device)
    _count("decode_attention", 4.0 * B * K * G * S * dh,
           _nbytes(q, k_cache, v_cache, lengths, out), (out,))
    return (out,)


def _int8(x, w_q, scales):
    M, D = x.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _count("int8_matmul", 2.0 * M * N * D, _nbytes(x, w_q, scales, out), (out,))
    return (out,)


def _gmm(x, w, group_sizes):
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    _count("moe_gmm", 2.0 * E * C * D * F, _nbytes(x, w, group_sizes, out), (out,))
    return (out,)


def _gmm_bwd(x, w, group_sizes, dy, *, need_dx, need_dw):
    E, C, D = x.shape
    F = w.shape[2]
    dx = torch.empty((E, C, D), dtype=x.dtype, device=x.device) if need_dx else None
    dw = torch.empty((E, D, F), dtype=w.dtype, device=x.device) if need_dw else None
    _count("moe_gmm_bwd", 2.0 * E * C * D * F * (int(need_dx) + int(need_dw)),
           _nbytes(x, w, group_sizes, dy, dx, dw), (dx, dw))
    return dx, dw


def _rwkv6(r, k, v, w, u, s0, s_out, checkpoints):
    B, H, T, dh = r.shape
    out = torch.empty((B, T, H, dh), dtype=r.dtype, device=r.device).transpose(1, 2)
    if s_out is None:
        s_out = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    _count("rwkv6_scan", 2.0 * B * H * T * dh * dh,
           _nbytes(r, k, v, w, u, s0, out, s_out, checkpoints), (out, s_out, checkpoints))
    return out, s_out


def _rwkv6_bwd(r, k, v, w, u, s0, dout, ds_final, checkpoints):
    B, H, T, dh = r.shape

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=r.device)

    dr, dk, dv, dw = (f32(B, T, H, dh).transpose(1, 2) for _ in range(4))
    du, ds0 = f32(H, dh), f32(B, H, dh, dh)
    # the two products of the forward's contraction, back through each step
    _count("rwkv6_scan_bwd", 4.0 * B * H * T * dh * dh,
           _nbytes(r, k, v, w, u, s0, dout, ds_final, checkpoints,
                   dr, dk, dv, dw, du, ds0), (dr, dk, dv, dw, du, ds0))
    return dr, dk, dv, dw, du, ds0


def _tuple(res) -> tuple:
    return res if isinstance(res, tuple) else (res,)


# the kernels' wrappers on real local shards, in the local calls' conventions
REAL = {
    "flash_attention": lambda q, k, v, **kw: _tuple(_flash_kernel(q, k, v, **kw)),
    "flash_attention_bwd": _flash_bwd_kernel,
    "decode_attention": lambda q, kc, vc, lengths, **kw: (_decode_kernel(q, kc, vc, lengths,
                                                                         **kw),),
    "int8_matmul": lambda x, w_q, scales: (_int8_kernel(x, w_q, scales),),
    "moe_gmm": lambda x, w, group_sizes: (_gmm_kernel(x, w, group_sizes),),
    "moe_gmm_bwd": _gmm_bwd_kernel,
    "rwkv6_scan": lambda r, k, v, w, u, s0, s_out, checkpoints: _rwkv6_kernel(
        r, k, v, w, u, s0, s_out=s_out, checkpoints=checkpoints),
    "rwkv6_scan_bwd": lambda r, k, v, w, u, s0, dout, ds_final, checkpoints: _rwkv6_bwd_kernel(
        r, k, v, w, u, s0, dout, ds_final, checkpoints=checkpoints),
}


# --- DTensor operands -----------------------------------------------------------

# A rule: {axis: (the dim of each operand in it or None, the dim of each
# output in it, or "partial", or None)}.
Rule = Dict[str, Tuple[Sequence[Optional[int]], Sequence]]

RULES: Dict[str, Rule] = {
    "flash_attention": {"batch": ((0, 0, 0), (0, 0)), "heads": ((1, 1, 1), (1, 1))},
    "flash_attention_bwd": {"batch": ((0, 0, 0, 0, 0, 0), (0, 0, 0)),
                            "heads": ((1, 1, 1, 1, 1, 1), (1, 1, 1))},
    "decode_attention": {"batch": ((0, 0, 0, 0), (0,)), "heads": ((1, 1, 1, None), (1,)),
                         "sequence": ((None, 2, 2, None), ("partial",))},
    "int8_matmul": {"rows": ((0, None, None), (0,)), "cols": ((None, 1, 0), (1,)),
                    "depth": ((1, 0, None), ("partial",))},
    "moe_gmm": {"experts": ((0, 0, 0), (0,)), "rows": ((1, None, None), (1,)),
                "cols": ((None, 2, None), (2,)), "depth": ((2, 1, None), ("partial",))},
    "moe_gmm_bwd": {"experts": ((0, 0, 0, 0), (0, 0)),
                    "rows": ((1, None, None, 1), (1, "partial")),
                    "cols": ((None, 2, None, 2), ("partial", 2)),
                    "depth": ((2, 1, None, None), (2, 1))},
    "rwkv6_scan": {"batch": ((0, 0, 0, 0, None, 0, 0, 0), (0, 0)),
                   "heads": ((1, 1, 1, 1, 0, 1, 1, 1), (1, 1))},
    "rwkv6_scan_bwd": {"batch": ((0, 0, 0, 0, None, 0, 0, 0, 0), (0, 0, 0, 0, "partial", 0)),
                       "heads": ((1, 1, 1, 1, 0, 1, 1, 1, 1), (1, 1, 1, 1, 0, 1))},
}

# the operands a kernel writes in place: K5's s_out and checkpoints
_IN_PLACE = {"rwkv6_scan": (6, 7)}

# K1's kv operands and kv outputs (dk, dv): where the kv heads do not divide
# the mesh dim the q heads are sharded over, but it is a multiple of them,
# each rank's q heads read one kv head (``_plan``'s grouped heads)
KV_HEADS = {"flash_attention": ((1, 2), ()), "flash_attention_bwd": ((1, 2), (1, 2))}


def _grouped(name, operands, mesh, chosen, axis):
    """The mesh dim of ``axis`` if it can shard K1's q heads with each
    rank's heads inside one kv head, else None."""
    if axis != "heads" or name not in KV_HEADS or chosen.count(axis) != 1:
        return None
    m = chosen.index(axis)
    n = mesh.size(m)
    H, K = operands[0].shape[1], operands[KV_HEADS[name][0][0]].shape[1]
    return m if H % n == 0 and n % K == 0 else None


def _plan(name: str, operands) -> tuple:
    """Each operand's placements and each output's, mesh dim by mesh dim,
    and the mesh dim of grouped heads (or None)."""
    rule = RULES[name]
    first = next(t for t in operands if isinstance(t, DTensor))
    mesh = first.device_mesh
    n_out = len(next(iter(rule.values()))[1])
    chosen = []
    for m in range(mesh.ndim):
        axis = None
        for i, t in enumerate(operands):
            if not isinstance(t, DTensor) or not t.placements[m].is_shard():
                continue
            d = t.placements[m].dim
            axis = next((a for a, (dims, _) in rule.items() if dims[i] == d), None)
            if axis is not None:
                break
        chosen.append(axis)
    # an axis must divide on every operand across all the mesh dims it takes
    grouped = None
    for axis in sorted(set(a for a in chosen if a is not None)):
        n = 1
        for m, a in enumerate(chosen):
            if a == axis:
                n *= mesh.size(m)
        dims = rule[axis][0]
        if any(t is not None and dims[i] is not None and t.shape[dims[i]] % n
               for i, t in enumerate(operands)):
            g = _grouped(name, operands, mesh, chosen, axis)
            if g is None:
                chosen = [None if a == axis else a for a in chosen]
            else:
                grouped = g
    ins = [[Replicate()] * mesh.ndim for _ in operands]
    outs = [[Replicate()] * mesh.ndim for _ in range(n_out)]
    for m, axis in enumerate(chosen):
        if axis is None:
            continue
        dims, odims = rule[axis]
        for i, d in enumerate(dims):
            if d is not None:
                ins[i][m] = Shard(d)
        for j, d in enumerate(odims):
            if d == "partial":
                outs[j][m] = Partial()
            elif d is not None:
                outs[j][m] = Shard(d)
    if grouped is not None:
        kv_in, kv_out = KV_HEADS[name]
        for i in kv_in:
            ins[i][grouped] = Replicate()
        for j in kv_out:
            outs[j][grouped] = Partial()
    return mesh, ins, outs, grouped


def call(name: str, local_fn, operands: Sequence, *, real: bool = False, **kw):
    """``local_fn(*operands, **kw)`` on fake tensors; with DTensor operands,
    on their local shards after redistributing them by ``RULES[name]`` (a
    plain operand counts as replicated), its outputs wrapped back as
    DTensors.  An output that is an operand (an in-place state) comes back
    as that operand.  ``real``: the shards hold data; the two layouts whose
    local results would not be the rank's share of the kernel's (grouped kv
    heads, an in-place operand that had to move) raise."""
    if not any(isinstance(t, DTensor) for t in operands):
        return local_fn(*operands, **kw)
    mesh, ins, outs, grouped = _plan(name, operands)
    if real and grouped is not None:
        raise NotImplementedError(f"{name}: q heads grouped over kv heads across ranks "
                                  "are traced only on fake shards")
    local = []
    for i, (t, pl) in enumerate(zip(operands, ins)):
        if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
            # a tensor the model made whole is the same on every rank
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if isinstance(t, DTensor):
            if tuple(t.placements) != tuple(pl):
                if real and i in _IN_PLACE.get(name, ()):
                    raise NotImplementedError(f"{name}: its in-place operand {i} must lie "
                                              f"as {pl} on real shards")
                t = t.redistribute(mesh, pl)
            t = t.to_local()
            if grouped is not None and i in KV_HEADS[name][0]:
                t = t[:, :1]          # this rank's q heads read one kv head
        local.append(t)
    results = local_fn(*local, **kw)
    wrapped = []
    for j, res in enumerate(results):
        hit = next((operands[i] for i, t in enumerate(local) if t is res and res is not None),
                   None)
        if hit is not None or res is None:
            wrapped.append(hit)
            continue
        if grouped is not None and j in KV_HEADS[name][1]:
            # this rank's share of its kv head's gradient, in a whole-heads
            # tensor summed over the mesh dim
            whole = list(res.shape)
            whole[1] = operands[KV_HEADS[name][0][0]].shape[1]
            res = res.new_zeros(whole)
        wrapped.append(summed(DTensor.from_local(res, mesh, outs[j], run_check=False)))
    return tuple(wrapped)


# --- the wrappers' branches, with ops.py's arguments -----------------------------
# ``real``: the DTensor's shards hold data, so the kernel's wrapper runs on them


def _local(name: str, fake_local, real: bool):
    return REAL[name] if real else fake_local


def flash_attention(q, k, v, *, causal, window, return_lse, real=False):
    res = call("flash_attention", _local("flash_attention", _flash, real), (q, k, v),
               real=real, causal=causal, window=window, return_lse=return_lse)
    return res if return_lse else res[0]


def flash_attention_bwd(q, k, v, o, lse, do, *, causal, window, real=False):
    return call("flash_attention_bwd", _local("flash_attention_bwd", _flash_bwd, real),
                (q, k, v, o, lse, do), real=real, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, lengths, *, window, real=False):
    return call("decode_attention", _local("decode_attention", _decode, real),
                (q, k_cache, v_cache, lengths), real=real, window=window)[0]


def int8_matmul(x, w_q, scales, *, real=False):
    return call("int8_matmul", _local("int8_matmul", _int8, real), (x, w_q, scales),
                real=real)[0]


def moe_gmm(x, w, group_sizes, *, real=False):
    return call("moe_gmm", _local("moe_gmm", _gmm, real), (x, w, group_sizes), real=real)[0]


def moe_gmm_bwd(x, w, group_sizes, dy, *, need_dx, need_dw, real=False):
    return call("moe_gmm_bwd", _local("moe_gmm_bwd", _gmm_bwd, real), (x, w, group_sizes, dy),
                real=real, need_dx=need_dx, need_dw=need_dw)


def rwkv6_scan(r, k, v, w, u, s0, *, s_out, checkpoints, real=False):
    return call("rwkv6_scan", _local("rwkv6_scan", _rwkv6, real),
                (r, k, v, w, u, s0, s_out, checkpoints), real=real)


def rwkv6_scan_bwd(r, k, v, w, u, s0, dout, ds_final, *, checkpoints, real=False):
    return call("rwkv6_scan_bwd", _local("rwkv6_scan_bwd", _rwkv6_bwd, real),
                (r, k, v, w, u, s0, dout, ds_final, checkpoints), real=real)
