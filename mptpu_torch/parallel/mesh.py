"""Device mesh over the ranks of ``torch.distributed`` (counterpart of
``make_mesh`` in ``mptpu/parallel/mesh.py``).

Axes, as in ``mptpu``: ``data`` for batch-parallel work and ``dict`` for
atom-sharded matching pursuit. Where ``mptpu`` lays a mesh over the
devices of one process, each rank here is one process: the caller starts
the ranks and calls ``torch.distributed.init_process_group`` (giving it
the rendezvous, the world size and the rank) before ``make_mesh``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import default_device


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    device=None,
) -> DeviceMesh:
    """A mesh of ``axis_sizes`` (default: one axis over every rank) named
    ``axis_names``, ranks laid out row-major as ``mptpu``'s devices, on
    ``default_device(device)``'s type (``cuda`` with NCCL, or ``cpu`` with
    gloo). The sizes must multiply to the world size."""
    dev = default_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call torch.distributed.init_process_group "
            "in every rank first"
        )
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (world,)
    n_needed = math.prod(axis_sizes)
    if n_needed != world:
        raise ValueError(
            f"make_mesh: axis_sizes {tuple(axis_sizes)} needs {n_needed} devices (ranks) "
            f"but the process group has {world}"
        )
    return init_device_mesh(dev.type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))
