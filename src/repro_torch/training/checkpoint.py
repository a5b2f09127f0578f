"""Checkpointing on the TD2 ``rsm`` format (one contract everywhere).

The counterpart of the JAX package's ``training/checkpoint.py``: a training
checkpoint is params (rsm) + optimizer m and v (rsm) + a step/meta json, in
the same files, so a checkpoint written by either package loads in the
other, and the ``rsm`` directory that restores training also serves.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from repro_torch.serving import formats


def save_checkpoint(path: str, params, opt_state, step: int,
                    meta: Optional[Dict[str, Any]] = None) -> int:
    """Returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    n = formats.save_rsm(params, os.path.join(path, "params"))
    n += formats.save_rsm({"m": opt_state["m"], "v": opt_state["v"]},
                          os.path.join(path, "opt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    return n


def load_checkpoint(path: str, params_template, opt_template=None, device=None):
    """(params, opt_state or None, meta) on ``device`` (the GPU unless the
    caller names the CPU); the templates give the trees' structure."""
    params = formats.load_rsm(params_template, os.path.join(path, "params"),
                              device=device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    opt_state = None
    if opt_template is not None:
        mv = formats.load_rsm({"m": opt_template["m"], "v": opt_template["v"]},
                              os.path.join(path, "opt"), device=device)
        opt_state = {"m": mv["m"], "v": mv["v"], "step": int(meta["step"])}
    return params, opt_state, meta


def latest_checkpoint(root: str) -> Optional[str]:
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_"):
            steps.append((int(d.split("_")[1]), os.path.join(root, d)))
    return max(steps)[1] if steps else None
