"""Dictionary-sharded (atom-parallel) matching pursuit on
``torch.distributed`` (counterpart of ``mptpu/parallel/dict_shard.py``).

The dictionary is split over the mesh's ``dict`` axis. At each step every
rank correlates the residual with its shard and takes its local argmax;
one ``all_gather`` of the (value, atom, position) triples over ``dict``
resolves the global winner, the first maximum, so ties go to the lower
shard and thus the lower global atom, as ``sparse_code``'s argmax; the
owner's atom reaches every rank through an ``all_reduce`` of the
owner-masked contribution, and every rank subtracts the same event. With
a ``data`` axis the batch rows are split too, and only the result is
gathered over it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.correlation import mp_correlate
from ..sparse.matching_pursuit import SparseCodeResult, _as3d, _normalize_dict, _subtract_event


def _axis(mesh: DeviceMesh, name: str):
    """(process group, size, this rank's index) of the mesh axis ``name``."""
    return (
        mesh.get_group(name),
        mesh.size(mesh.mesh_dim_names.index(name)),
        mesh.get_local_rank(name),
    )


def _shard_size(n_atoms: int, n_dev: int, axis: str) -> int:
    if n_atoms % n_dev != 0:
        raise ValueError(
            f"sharded_sparse_code: n_atoms ({n_atoms}) must be divisible "
            f"by the '{axis}' axis size ({n_dev}); pad the dictionary or "
            "choose a divisor mesh."
        )
    return n_atoms // n_dev


def _all_gather(t: torch.Tensor, group) -> list:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def sharded_mp_correlate(mesh: DeviceMesh, signal, atoms, axis: str = "dict") -> torch.Tensor:
    """This rank's shard of the correlation map with the dictionary split
    over ``axis``: ``(batch, n_atoms / n, n_samples)`` for atoms
    ``[r * n_atoms / n, (r + 1) * n_atoms / n)`` of rank ``r`` of ``n``
    on that axis (``mptpu`` returns the global map sharded so)."""
    _, n_dev, me = _axis(mesh, axis)
    shard = _shard_size(atoms.shape[0], n_dev, axis)
    return mp_correlate(signal, atoms[me * shard : (me + 1) * shard])


def sharded_sparse_code(
    mesh: DeviceMesh,
    signal: torch.Tensor,
    d: torch.Tensor,
    n_steps: int = 100,
    axis: str = "dict",
    data_axis: Optional[str] = None,
) -> SparseCodeResult:
    """Greedy MP with the dictionary sharded across ``axis`` and, with
    ``data_axis``, the batch across that axis.

    Every rank passes the full signal (batch, channels, n_samples) and the
    full dictionary (n_atoms, atom_size) or (n_atoms, channels, atom_size)
    and gets the global ``SparseCodeResult``, equal to ``sparse_code``'s
    (ties to the lower global atom). Per step: one ``all_gather`` of the
    triples and one ``all_reduce`` of the winning atoms, both over ``axis``;
    batch rows never communicate until the end.
    """
    if signal.ndim == 2:
        signal = signal[:, None, :]
    batch, channels, n_samples = signal.shape
    d3 = _normalize_dict(_as3d(d))

    dict_group, n_dev, me = _axis(mesh, axis)
    shard_atoms = _shard_size(d3.shape[0], n_dev, axis)
    if data_axis is not None:
        data_group, n_data, row = _axis(mesh, data_axis)
        if batch % n_data != 0:
            raise ValueError(
                f"sharded_sparse_code: batch ({batch}) must be divisible "
                f"by the '{data_axis}' axis size ({n_data})."
            )
        b_local = batch // n_data
        signal = signal[row * b_local : (row + 1) * b_local]
    d_shard = d3[me * shard_atoms : (me + 1) * shard_atoms]
    b_local = signal.shape[0]
    rows = torch.arange(b_local, device=signal.device)

    residual = signal
    events = []
    for _ in range(n_steps):
        flat = mp_correlate(residual, d_shard).reshape(b_local, -1)
        idx = torch.argmax(flat, dim=-1)
        # float64 holds the float32 value and both indices exactly: one
        # collective carries the whole triple
        triple = torch.stack([flat[rows, idx].double(), (idx // n_samples).double(),
                              (idx % n_samples).double()])
        gathered = torch.stack(_all_gather(triple, dict_group))   # (n_dev, 3, b_local)
        winner = torch.argmax(gathered[:, 0], dim=0)   # first maximum: the lower shard
        win = gathered[winner, :, rows]                # (b_local, 3)
        value = win[:, 0].to(signal.dtype)
        local_atom, position = win[:, 1].long(), win[:, 2].long()
        contrib = d_shard[local_atom] * (winner == me).to(signal.dtype)[:, None, None]
        dist.all_reduce(contrib, group=dict_group)     # the owner's atom, on every rank
        residual = _subtract_event(residual, contrib, position, value)
        events.append((winner * shard_atoms + local_atom, position, value))

    atoms, positions, values = (torch.stack(x) for x in zip(*events))
    atoms, positions = atoms.to(torch.int32), positions.to(torch.int32)
    if data_axis is not None:
        residual = torch.cat(_all_gather(residual, data_group), dim=0)
        atoms, positions, values = (torch.cat(_all_gather(t, data_group), dim=1)
                                    for t in (atoms, positions, values))
    return SparseCodeResult(atoms, positions, values, residual)
