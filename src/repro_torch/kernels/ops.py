"""Public entry points of the kernels, with the JAX package's keyword arguments.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/ref.py``); a CUDA tensor goes to the hand-written kernel or the
wrapper raises.  The block-size arguments size the TPU kernels' tiles in the
JAX package; the CUDA kernels pick their tiles from the shapes, so here they
are accepted for call compatibility and have no effect.

``launch_counts`` and ``reset_launch_counts`` read and clear the plain
integer each wrapper adds one to where it launches its kernel.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.int8_matmul import int8_matmul as _int8
from repro_torch.kernels.int8_matmul import quantize_int8  # noqa: F401 (re-export)

_WRAPPERS = {"flash_attention": _flash, "decode_attention": _decode,
             "int8_matmul": _int8}


def flash_attention(q, k, v, *, causal=True, window=None, block_q=128,
                    block_kv=128):
    return _flash(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, lengths, *, window=None, block_s=512):
    return _decode(q, k_cache, v_cache, lengths, window=window)


def int8_matmul(x, w_q, scales, *, block_m=128, block_n=128, block_d=512):
    return _int8(x, w_q, scales)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
