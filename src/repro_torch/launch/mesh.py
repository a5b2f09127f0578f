"""Production mesh construction (functions, not constants: importing this
module starts no process group).

The JAX package's production meshes are 16x16 = 256 chips a pod and
2x16x16 = 512 across two pods; here they stand for 256 and 512 H100s.  They
are built on the ``fake`` process-group backend, whose ranks move no data:
the dry-run traces one rank's step on fake tensors and reads its
collectives from what it dispatches.

A process holds one default process group.  Each function here makes the
group its mesh needs, tearing down the one before when its world size
differs (``_world``); a mesh made earlier is dead after that.  The dry-run
builds one mesh, traces one step on it and drops it before the next.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    """The card where there is one: its fake tensors are CUDA ones."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _world(size: int) -> None:
    """A default process group of ``size`` fake ranks, this process rank 0."""
    # internal to torch: the one import of its fake backend in the port
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def release() -> None:
    """Tear down the default process group (and with it every mesh)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 cards a pod; 2x16x16 = 512 cards across 2 pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _world(256 * (2 if multi_pod else 1))
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh() -> DeviceMesh:
    """Degenerate 1x1 mesh on the real local device: the card where there is
    one (its one rank issues no collective)."""
    _world(1)
    return init_device_mesh(_device_type(), (1, 1), mesh_dim_names=("data", "model"))
