"""Weight rules of the reference: the precision each served weight is read in.

Frozen here so that a change to the program cannot move them.

- ``f32``: the weight as made, in float32.
- ``int8``: per-output-channel symmetric int8 (127 levels each side), the
  scale the largest magnitude along the contraction axis over 127, rounded
  half to even; the rule the ``rsm_int8`` format states.
- ``int4``: the same with 7 levels each side (the control of an int8 model).
- ``fp8``: float8 e4m3 with a per-output-channel scale (largest magnitude
  over 448), the control of a bfloat16 model.

A weight is (..., D, N): D the contraction axis, N the output channels.
``activations`` rounds the other operand of a product, row by row: ``fp8``
(e4m3, a scale a row) completes the fp8 control, both operands of every
product in fp8 as fp8 tensor cores take them.
"""

from __future__ import annotations

import torch


def _symmetric(w: torch.Tensor, levels: int) -> torch.Tensor:
    wf = w.float()
    absmax = wf.abs().amax(dim=-2)
    scales = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, float(levels))
    q = torch.clamp(torch.round(wf / scales[..., None, :]), -levels, levels)
    return q * scales[..., None, :]


def _fp8(w: torch.Tensor, axis: int = -2) -> torch.Tensor:
    wf = w.float()
    scales = torch.clamp(wf.abs().amax(dim=axis, keepdim=True), min=1e-12) / 448.0
    return (wf / scales).to(torch.float8_e4m3fn).float() * scales


RULES = {
    "f32": lambda w: w.float(),
    "int8": lambda w: _symmetric(w, 127),
    "int4": lambda w: _symmetric(w, 7),
    "fp8": _fp8,
}


def apply(rule: str, w: torch.Tensor) -> torch.Tensor:
    return RULES[rule](w)


def activations(rule, x: torch.Tensor) -> torch.Tensor:
    """x (..., D) as the configuration's rule rounds it: unchanged without
    one, fp8 e4m3 with a scale a row for ``fp8``."""
    if rule is None:
        return x
    if rule != "fp8":
        raise ValueError(f"no activation rule {rule!r}")
    return _fp8(x, axis=-1)
