"""Ambient sharding constraints for model-internal tensors.

The counterpart of the JAX package's ``distributed/ctx.py``.  Model code
(the residual stream, the MoE dispatch buffers) sometimes needs an
activation sharding that DTensor's propagation would not pick.
``constrain(x, spec_template, role)`` redistributes a DTensor ``x`` to the
placements the template names on the mesh installed by ``sharding_hints``,
and returns ``x`` itself (no copy, no launch) when no mesh is installed, the
role is off or ``x`` is no DTensor: the serving and training paths on one
card never install a mesh, so the models stay mesh-agnostic.

The hints are process-wide, not per thread: the autograd engine runs a
CUDA backward, and the forward that ``remat`` recomputes there, on a thread
of its own, which must see the forward's hints.
"""

from __future__ import annotations

import contextlib

from torch.distributed.tensor import DTensor, Replicate, Shard

_HINTS = {"mesh": None, "roles": frozenset()}


@contextlib.contextmanager
def sharding_hints(mesh, roles=("residual", "moe")):
    """roles: which constraint classes are active.  The JAX package's
    measured policy: training needs both ('residual' pins the backward's
    cotangent sharding, 'moe' tames the dispatch all-reduce); inference
    runs best with the propagation's own choices, roles=() there."""
    prev = dict(_HINTS)
    _HINTS.update(mesh=mesh, roles=frozenset(roles))
    try:
        yield
    finally:
        _HINTS.update(prev)


def _dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def entries(mesh, shape, spec_template) -> tuple:
    """The PartitionSpec entries (None, an axis name, or a tuple of them) the
    JAX package's ``constrain`` gives a tensor of ``shape``: 'dp' resolves to
    the (pod, data) group; a dim whose size does not divide stays whole."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for dim, r in zip(shape, spec_template):
        if r is None:
            out.append(None)
            continue
        axes = _dp_axes(mesh) if r == "dp" else (r,)
        size = 1
        for a in axes:
            size *= sizes[a]
        if size > 1 and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


def placements(mesh, spec_entries) -> tuple:
    """DTensor placements, one per mesh dim, of PartitionSpec entries: a dim
    named by an entry is Shard(that tensor dim) (an entry of several axes
    shards the dim over each, major to minor), any other Replicate."""
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for d, e in enumerate(spec_entries):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def constrain(x, spec_template, role="residual"):
    """spec_template: tuple with entries None | 'dp' | 'model' per dim.

    'dp' resolves to the (pod, data) group of the ambient mesh.  Dims whose
    size doesn't divide the axis size are left unsharded.  No-op unless the
    ambient hints enable ``role``.
    """
    mesh = _HINTS["mesh"]
    if mesh is None or role not in _HINTS["roles"] or not isinstance(x, DTensor):
        return x
    target = placements(mesh, entries(mesh, x.shape, spec_template))
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)
