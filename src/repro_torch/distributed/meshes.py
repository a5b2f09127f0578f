"""Sharding policy: params / batch / cache placements for any mesh.

The counterpart of the JAX package's ``distributed/meshes.py``, with its
policy (MaxText-lineage, generalized so every assigned arch lowers):

  * weights: greedy 2-D sharding — the largest divisible dim goes to the
    ``model`` (tensor-parallel) axis, the next largest divisible dim to the
    fsdp group (``data`` [+ ``pod``]).  Dims that don't divide the axis size
    are left replicated; stacked-layer leading dims and small vectors are
    never sharded.
  * optimizer state mirrors params.
  * batch: global batch over (pod, data).
  * decode caches: batch over data when divisible (decode_32k), else the
    sequence axis (long_500k, B=1), kv-heads/ssm-heads over ``model`` when
    divisible.

Each rule works out the JAX package's PartitionSpec entries (None, an axis
name, or a tuple of axis names per tensor dim) and returns them as DTensor
placements, one per mesh dim (``ctx.placements``): an entry ('pod', 'data')
on one tensor dim becomes Shard(d) on both mesh dims, major to minor.  A
mesh is anything with ``shape`` and ``mesh_dim_names`` (a ``DeviceMesh``);
a tree is nested dicts whose leaves have a ``shape``.
"""

from __future__ import annotations

import math
from typing import Tuple

from repro_torch.distributed.ctx import placements

MODEL_AXIS = "model"


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data/fsdp axis group (includes the pod axis when present)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _map(rule, tree, path=()):
    """``rule(path string, leaf)`` over a nested dict (the tree's leaves in
    place); the path joins the keys with '/', as the JAX package's does."""
    if isinstance(tree, dict):
        return {k: _map(rule, v, path + (str(k),)) for k, v in tree.items()}
    return rule("/".join(path), tree)


def _fsdp_entry(mesh):
    fd = dp_axes(mesh)
    return fd if len(fd) > 1 else fd[0]


# -- generic greedy weight rule -------------------------------------------------


def _weight_spec(shape, mesh, *, skip_leading: int, min_dim: int = 256):
    """Greedy: model axis on the largest divisible dim, fsdp on the next."""
    spec: list = [None] * len(shape)
    dims = [(d, i) for i, d in enumerate(shape) if i >= skip_leading and d >= min_dim]
    dims.sort(reverse=True)
    remaining = list(dims)
    for axes in (MODEL_AXIS, dp_axes(mesh)):
        size = axis_size(mesh, axes)
        if size <= 1:
            continue
        for d, i in remaining:
            if spec[i] is None and d % size == 0:
                spec[i] = axes if isinstance(axes, str) else (
                    axes if len(axes) > 1 else axes[0])
                remaining.remove((d, i))
                break
    return tuple(spec)


def _is_stacked(path_str: str) -> bool:
    return any(t in path_str for t in ("layers", "mamba_layers", "enc_layers", "dec_layers"))


def param_specs(params_shape, mesh, mode: str = "train"):
    """The JAX package's PartitionSpec entries of a params shape tree.

    mode="train": greedy 2-D (model TP + fsdp over data) — optimizer state
    must shard, and per-layer weight gathers amortize over the math.
    mode="serve": model-axis TP only — weights stay resident, no per-step
    fsdp all-gathers (the decode hot path).  Leaves whose model-sharded
    size would still exceed ~1 GiB/device (giant MoE expert stacks) keep
    the 2-D layout.
    """
    model_n = _sizes(mesh)[MODEL_AXIS]

    def rule(pstr, leaf):
        shape = tuple(leaf.shape)
        skip = 1 if _is_stacked(pstr) else 0
        if "group_gain" in pstr:
            skip = 1
        if len(shape) - skip < 2:
            return ()                     # vectors / scalars / norms: replicated
        if "embed" in pstr or "lm_head" in pstr:
            # embedding-like tables: the VOCAB dim over model only
            vdim = 0 if "embed" in pstr else 1
            spec = [None, None]
            if shape[vdim] % model_n == 0:
                spec[vdim] = MODEL_AXIS
            if mode != "serve":
                odim = 1 - vdim
                if shape[odim] % axis_size(mesh, dp_axes(mesh)) == 0:
                    spec[odim] = _fsdp_entry(mesh)
            return tuple(spec)
        if mode == "serve" and math.prod(shape) * 2 / model_n <= 1 * 1024 ** 3:  # bf16
            spec = [None] * len(shape)
            dims = sorted(((d, i) for i, d in enumerate(shape) if i >= skip), reverse=True)
            for d, i in dims:
                if d % model_n == 0 and d >= 256:
                    spec[i] = MODEL_AXIS
                    break
            return tuple(spec)
        return _weight_spec(shape, mesh, skip_leading=skip)

    return _map(rule, params_shape)


def opt_specs(opt_shape, mesh):
    def rule(pstr, leaf):
        if pstr.startswith("step") or not hasattr(leaf, "shape"):
            return ()
        shape = tuple(leaf.shape)
        skip = 1 if _is_stacked(pstr) else 0
        if len(shape) - skip < 2:
            return ()
        return _weight_spec(shape, mesh, skip_leading=skip)

    return _map(rule, opt_shape)


# -- batch / cache rules ----------------------------------------------------------


def batch_specs(batch_shape, mesh):
    dp_n = axis_size(mesh, dp_axes(mesh))
    dp_spec = _fsdp_entry(mesh)

    def rule(pstr, leaf):
        B = leaf.shape[0]
        return (dp_spec if B % dp_n == 0 else None, *([None] * (len(leaf.shape) - 1)))

    return _map(rule, batch_shape)


def cache_specs(cache_shape, mesh, cfg):
    """Decode-cache entries: see module docstring."""
    dp = dp_axes(mesh)
    dp_n = axis_size(mesh, dp)
    dp_spec = _fsdp_entry(mesh)
    m_n = _sizes(mesh)[MODEL_AXIS]

    def rule(pstr, leaf):
        shape = tuple(leaf.shape)
        if pstr == "lengths":
            return ()
        spec: list = [None] * len(shape)
        B = shape[1]              # layout: (L_or_G, B, ...) for every tensor leaf
        if pstr in ("k", "v", "xk", "xv"):
            # (L, B, S, K, hd): batch over data, then K over model when
            # divisible, else sequence over model (split-KV decode).  Never
            # the head dim (the contraction).
            if B % dp_n == 0 and B >= dp_n:
                spec[1] = dp_spec
            elif shape[2] % dp_n == 0:
                spec[2] = dp_spec  # long-context B=1: sequence over data
            if shape[3] % m_n == 0 and shape[3] >= m_n:
                spec[3] = MODEL_AXIS
            elif shape[2] % m_n == 0:
                spec[2] = MODEL_AXIS if spec[2] is None else (*dp, MODEL_AXIS)
            return tuple(spec)
        if B % dp_n == 0 and B >= dp_n:
            spec[1] = dp_spec
        if pstr in ("wkv", "ssm", "tm_shift", "cm_shift"):
            # wkv (L, B, H, hd, hd); ssm (L, B, nh, hd, S); shifts (L, B, D)
            if shape[2] % m_n == 0:
                spec[2] = MODEL_AXIS
        elif pstr == "conv":
            # (L, B, W-1, C)
            if shape[3] % m_n == 0:
                spec[3] = MODEL_AXIS
        return tuple(spec)

    return _map(rule, cache_shape)


# -- placements -------------------------------------------------------------------


def named(tree_specs, mesh):
    """The DTensor placements (one per mesh dim) of a tree of entries."""
    if isinstance(tree_specs, dict):
        return {k: named(v, mesh) for k, v in tree_specs.items()}
    return placements(mesh, tree_specs)


def param_shardings(params_shape, mesh, mode: str = "train"):
    return named(param_specs(params_shape, mesh, mode), mesh)


def opt_shardings(opt_shape, mesh):
    return named(opt_specs(opt_shape, mesh), mesh)


def batch_shardings(batch_shape, mesh):
    return named(batch_specs(batch_shape, mesh), mesh)


def cache_shardings(cache_shape, mesh, cfg):
    return named(cache_specs(cache_shape, mesh, cfg), mesh)
