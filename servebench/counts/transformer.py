"""The ``transformer`` kind's work counts: the operations and bytes of each
kernel call a step makes, the useful work of the tokens served, and the
names of the kernels its steps run (``KERNELS``).

A step is what the harness recorded around one timed engine call (see
``servebench/serve.py``): a B = 1 admission prefill of a prompt padded to
``bucket`` positions, or one decode step of the whole slot pool, with every
slot's cache length before the step (a free slot keeps stepping).

Kernel work is counted from the calls' shapes and lengths, whatever kernel
computes them: each input byte read once, each output byte written once,
bf16 activations and caches, operations as multiply-adds times two.
- K1, prefill attention: q, k, v read, o written; 4 H hd per attended pair,
  the pairs causal (and inside the window, where the model has one).
- K2, decode attention: every slot's cache entries up to its length (the new
  entry included, at most ``max_seq``), its q read and o written.
- K3, int8 weight GEMMs (``rsm_int8``): the int8 weight and its f32 scales,
  the rows of x read, of y written.
- K4, expert GEMMs: every expert's weight (a batch of 32 or more routed rows
  reaches all 8 experts but for a chance under 1e-3 a layer), k rows a
  token read and written; three calls a layer.

A kernel's device time is sorted into its family by ``KERNELS``: the first
pattern that finds the profiled name (K1 ``flash_``, K2 ``decode_``, K3
``int8_``, K4 ``gmm_`` but not its backward).

The useful work (``step_flops``, for ``mfu``) counts only the real tokens:
a prompt's own positions, not its padding, and the output tokens of the
slots that hold a request, each at its real context; weights as 2 x the
active parameters a token touches, attention as 4 H hd per attended pair,
the output head for every output token.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

BF16 = 2
KERNELS = (("k1", re.compile(r"::flash_")), ("k2", re.compile(r"::decode_")),
           ("k3", re.compile(r"::int8_")), ("k4", re.compile(r"::gmm_(?!bwd)")))


def _dims(m: dict):
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    return m["d_model"], m["num_heads"], m["num_kv_heads"], hd


def _pairs(S: int, window) -> int:
    """Attended (query, key) pairs of a causal prefill of S positions."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def dense_shapes(m: dict):
    """(contraction, outputs) of each dense call a token makes in one layer."""
    D, H, K, hd = _dims(m)
    calls = [(D, H * hd), (D, K * hd), (D, K * hd), (H * hd, D)]
    if not m.get("num_experts"):
        F = m["d_ff"]
        calls += [(D, F), (F, D)] if m["mlp"] == "relu2" else [(D, F), (D, F), (F, D)]
    return calls


def _add(acc: Dict[str, list], key: str, nbytes: float, flops: float) -> None:
    a = acc.setdefault(key, [0.0, 0.0])
    a[0] += nbytes
    a[1] += flops


def kernel_work(m: dict, fmt: str, step: dict, max_seq: int) -> Dict[str, Tuple[float, float]]:
    """{"k1" | "k2" | "k3" | "k4": (bytes, operations)} of one step's calls."""
    D, H, K, hd = _dims(m)
    L = m["num_layers"]
    acc: Dict[str, list] = {}
    if step["kind"] == "prefill":
        S = step["bucket"]
        for _ in range(L):
            _add(acc, "k1", BF16 * (2 * S * H * hd + 2 * S * K * hd),
                 4.0 * H * hd * _pairs(S, m.get("attn_window")))
        rows = S
    else:
        rows = len(step["lens"])
        for _ in range(L):
            for n in step["lens"]:
                n = min(n + 1, max_seq)
                _add(acc, "k2", BF16 * (2 * n * K * hd + 2 * H * hd), 4.0 * H * hd * n)
    if fmt == "rsm_int8":
        for _ in range(L):
            for din, dout in dense_shapes(m):
                _add(acc, "k3", din * dout + 4 * dout + BF16 * rows * (din + dout),
                     2.0 * rows * din * dout)
    if m.get("num_experts"):
        E, k, F = m["num_experts"], m["experts_per_token"], m["d_ff"]
        routed = k * rows
        for _ in range(L):
            for _call in range(3):
                _add(acc, "k4", BF16 * (E * D * F + routed * (D + F)),
                     2.0 * routed * D * F)
    return {key: (v[0], v[1]) for key, v in acc.items()}


def active_params(m: dict) -> Tuple[float, float]:
    """(weights a token multiplies in all layers, the output head's)."""
    D, H, K, hd = _dims(m)
    per_layer = D * (H + 2 * K) * hd + H * hd * D
    if m.get("num_experts"):
        per_layer += D * m["num_experts"] + m["experts_per_token"] * 3 * D * m["d_ff"]
    else:
        per_layer += (2 if m["mlp"] == "relu2" else 3) * D * m["d_ff"]
    return float(m["num_layers"] * per_layer), float(D * m["vocab_size"])


def step_flops(m: dict, step: dict) -> float:
    """Useful operations of one step (module docstring)."""
    D, H, K, hd = _dims(m)
    layers, head = active_params(m)
    attn = 4.0 * m["num_layers"] * H * hd
    window = m.get("attn_window")
    if step["kind"] == "prefill":
        P = step["prompt"]
        return 2.0 * layers * P + attn * _pairs(P, window) + 2.0 * head
    total = 0.0
    for ctx in step["live_ctx"]:
        n = ctx if window is None else min(ctx, window)
        total += 2.0 * (layers + head) + attn * n
    return total
