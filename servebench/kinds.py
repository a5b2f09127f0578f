"""A configuration's kind, and the files that serve it, found by name.

Each configuration file (``servebench/configs/<name>.json``) states its
``"kind"``.  The harness takes everything that depends on how the model is
built from two files of that kind:
- ``servebench/reference/<kind>.py``: ``Reference(model, weights, rules)``,
  the plain reference that decides ``correct`` (``servebench/check.py``),
  with ``run(seqs, n_prompt, n_scored, select=(), head_rows=512)``;
- ``servebench/counts/<kind>.py``: ``kernel_work(model, fmt, step,
  max_seq)``, ``step_flops(model, step)``, ``active_params(model)`` and
  ``KERNELS``, a tuple of (family key, compiled pattern of the device
  kernel's name) by which the trace's kernel time is sorted.

A model of a new kind so comes as new files.  Every lookup takes the
checkout's ``root``, so that a test can point it at a copy.
"""

from __future__ import annotations

import importlib.util
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("reference", "counts")
KIND = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_-]{0,63}")


def load_file(path: str, name: str):
    """The Python file at ``path``, executed as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def paths(config: dict, root: str = ROOT) -> dict:
    """{part: path} of the configuration's kind; LookupError, naming the
    files looked for, where the kind is not stated or a file is missing."""
    kind = config.get("kind")
    if not isinstance(kind, str) or not KIND.fullmatch(kind):
        raise LookupError(
            f"configuration {config.get('arch')!r} states no valid kind (got {kind!r}): "
            "it needs \"kind\": \"<kind>\", a name served by "
            "servebench/reference/<kind>.py and servebench/counts/<kind>.py")
    found = {part: os.path.join(root, "servebench", part, f"{kind}.py") for part in PARTS}
    missing = [p for p in found.values() if not os.path.isfile(p)]
    if missing:
        raise LookupError(f"kind {kind!r}: looked for {' and '.join(found.values())}; "
                          f"missing {' and '.join(missing)}")
    return found


def reference(config: dict, root: str = ROOT):
    """The ``Reference`` class of the configuration's kind."""
    path = paths(config, root)["reference"]
    return load_file(path, f"servebench_reference_{config['kind']}").Reference


def counts(config: dict, root: str = ROOT):
    """The work-count module of the configuration's kind."""
    path = paths(config, root)["counts"]
    return load_file(path, f"servebench_counts_{config['kind']}")
