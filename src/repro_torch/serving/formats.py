"""TD2 'Model format': the serialized forms a model is served from.

The files are the JAX package's, byte for byte: the manifest is the contract
(same key order, ``json.dump(..., indent=1)``, dtype strings such as
``"bfloat16"``, bf16 stored as f32), so either package loads what the other
wrote.

  * ``native``   -- one ``.npz`` of the flattened tree.
  * ``rsm``      -- manifest.json (dtypes, shapes, offsets) + one raw
                    tensors.bin.
  * ``rsm_int8`` -- as rsm, with matmul weights stored as per-output-channel
                    symmetric int8 + f32 scales.  Loads dequantized, or with
                    ``QTensor`` leaves that ``dense()`` sends to the int8
                    kernel.

Fence of a fault in the JAX package: ``save_rsm``'s quantize test also takes
the stacked norm gains ``layers/ln1`` / ``layers/ln2`` once a model has 8 or
more layers, and the JAX package then fails in ``forward``.  Here
``load_rsm(as_qtensor=True)`` returns a ``QTensor`` only for the leaves that
``dense()`` consumes and dequantizes every other quantized leaf to its
``orig_dtype``, exactly as ``as_qtensor=False`` does.  The files stay the
same.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.kernels.int8_matmul import quantize_int8

# leaves dense() consumes: the only ones served as QTensor
MATMUL_LEAVES = frozenset({
    "attn/wq", "attn/wk", "attn/wv", "attn/wo",
    "mlp/wi", "mlp/wi_gate", "mlp/wi_up", "mlp/wo",
})


@dataclasses.dataclass
class QTensor:
    """A quantized leaf the model's dense() dispatches on."""

    wq: torch.Tensor              # (..., D, N) int8
    scales: torch.Tensor          # (..., N) f32

    @property
    def shape(self):
        return self.wq.shape

    @property
    def ndim(self):
        return self.wq.ndim

    def dequant(self):
        return (self.wq.float() * self.scales[..., None, :]).to(torch.bfloat16)


def _is_matmul_leaf(key: str) -> bool:
    return "/".join(key.split("/")[-2:]) in MATMUL_LEAVES


def _flatten(params, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} in the JAX package's order (dict keys sorted)."""
    flat = {}
    for k in sorted(params):
        key = f"{prefix}/{k}" if prefix else str(k)
        v = params[k]
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _unflatten(template, make, prefix: str = ""):
    out = {}
    for k, v in template.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out[k] = _unflatten(v, make, key) if isinstance(v, dict) else make(key)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bf16 (which numpy lacks) becomes f32, its stored form."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


# -- native (npz) ---------------------------------------------------------------


def save_native(params, path: str) -> int:
    np.savez(path, **{k: _to_numpy(v) for k, v in _flatten(params).items()})
    return os.path.getsize(path if path.endswith(".npz") else path + ".npz")


def load_native(template, path: str, device=None):
    """Leaves keep their stored dtype, as in the JAX package: a bf16 model
    saved as native loads in f32."""
    device = resolve_device(device)
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(template, lambda key: torch.from_numpy(flat[key]).to(device))


# -- rsm (manifest + raw bin) ----------------------------------------------------


def _quantizable(key: str, arr: torch.Tensor) -> bool:
    """save_rsm's quantize test, as in the JAX package (norm gains included)."""
    return (
        arr.ndim in (2, 3)  # (D, N) or stacked-layers (L, D, N)
        and arr.shape[-2] >= 8
        and arr.dtype in (torch.float32, torch.float16, torch.bfloat16)
        # embeddings are gathered (not matmul'd) and routers need f32
        # logits -- keep them full precision
        and not any(t in key for t in ("embed", "lm_head", "router"))
    )


def save_rsm(params, path: str, quantize: bool = False) -> int:
    """Returns total bytes on disk. ``quantize`` -> rsm_int8."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(params)
    manifest = {"format": "rsm_int8" if quantize else "rsm", "tensors": {}}
    offset = 0
    with open(os.path.join(path, "tensors.bin"), "wb") as f:
        for key, t in sorted(flat.items()):
            if quantize and _quantizable(key, t):
                wq, scales = quantize_int8(t)
                wq, scales = _to_numpy(wq), _to_numpy(scales)
                entry = {
                    "dtype": "int8", "shape": list(t.shape), "offset": offset,
                    "quantized": True, "scales_offset": offset + wq.nbytes,
                    "orig_dtype": _dtype_name(t),
                }
                f.write(wq.tobytes())
                f.write(scales.tobytes())
                offset += wq.nbytes + scales.nbytes
            else:
                a = _to_numpy(t)
                entry = {
                    "dtype": str(a.dtype), "shape": list(t.shape),
                    "offset": offset, "quantized": False,
                    "orig_dtype": _dtype_name(t),
                }
                f.write(a.tobytes())
                offset += a.nbytes
            manifest["tensors"][key] = entry
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return sum(
        os.path.getsize(os.path.join(path, n))
        for n in ("tensors.bin", "manifest.json")
    )


def _dequant(wq: torch.Tensor, scales: torch.Tensor, orig_dtype: str) -> torch.Tensor:
    return (wq.float() * scales[..., None, :]).to(getattr(torch, orig_dtype))


def load_rsm(template, path: str, as_qtensor: bool = False, device=None):
    """Load an rsm/rsm_int8 directory.

    as_qtensor=True keeps the int8 matmul weights as QTensor leaves (the
    int8-kernel path); every other leaf, and every leaf when it is False, is
    returned in its original dtype.
    """
    device = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    buf = np.memmap(os.path.join(path, "tensors.bin"), dtype=np.uint8, mode="r")

    def read(dtype, shape, offset):
        n = int(np.prod(shape)) if shape else 1
        # copy out of the memmap: the loaded tree owns its memory
        return torch.from_numpy(np.array(
            np.frombuffer(buf, dtype, count=n, offset=offset).reshape(shape))).to(device)

    def make(key):
        e = manifest["tensors"][key]
        shape = tuple(e["shape"])
        if not e["quantized"]:
            t = read(np.dtype(e["dtype"]), shape, e["offset"])
            return t.to(getattr(torch, e["orig_dtype"]))
        wq = read(np.int8, shape, e["offset"])
        scales = read(np.float32, shape[:-2] + shape[-1:], e["scales_offset"])
        if as_qtensor and _is_matmul_leaf(key):
            return QTensor(wq, scales)
        return _dequant(wq, scales, e["orig_dtype"])

    return _unflatten(template, make)


def quantize_params(params):
    """The tree ``load_rsm(.., as_qtensor=True)`` gives after ``save_rsm(..,
    quantize=True)``, made in memory on the params' device.

    Same quantize test as save_rsm, same fence: matmul weights become
    QTensor, other quantized leaves are dequantized to their dtype.
    """
    def make(key):
        t = flat[key]
        if not _quantizable(key, t):
            return t
        wq, scales = quantize_int8(t)
        if _is_matmul_leaf(key):
            return QTensor(wq, scales)
        return _dequant(wq, scales, _dtype_name(t))

    flat = _flatten(params)
    return _unflatten(params, make)


def format_size_bytes(params, fmt: str, tmpdir: str) -> int:
    """Bytes-on-disk for a format (TD2 interoperability/footprint metric)."""
    if fmt == "native":
        return save_native(params, os.path.join(tmpdir, "m.npz"))
    if fmt == "rsm":
        return save_rsm(params, os.path.join(tmpdir, "rsm"), quantize=False)
    if fmt == "rsm_int8":
        return save_rsm(params, os.path.join(tmpdir, "rsm8"), quantize=True)
    raise ValueError(fmt)
