"""Data-parallel training on ``torch.distributed`` (counterpart of
``mptpu/parallel/dp.py``): every rank holds the whole parameters and its
shard of the batch, and the ranks' gradients are all-reduced.

``mptpu`` jits the loss over the global batch and lets XLA insert the
reduction, so its loss and gradients are those of the whole batch. Its
SIAM loss sums over the batch (``iterative_loss``), so the ranks'
gradients are summed here, not averaged as DDP does: one step on R ranks
equals one step of one process on the whole batch. The ok-gate reads the
global loss and the global gradient norm, the same on every rank, so
every rank takes or skips the same update.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import no_tf32
from ..train.optim import AdamState, apply_gated, global_norm


def shard_batch(mesh: DeviceMesh, batch: torch.Tensor, axis: str = "data",
                dim: int = 0) -> torch.Tensor:
    """This rank's rows of ``batch`` along ``dim``: the ``r``-th of ``R``
    equal shards for rank ``r`` of the mesh's ``axis`` (``mptpu`` places a
    host batch on the mesh so). Raises when the rows do not divide."""
    group = mesh.get_group(axis)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    rows = batch.shape[dim]
    if rows % world:
        raise ValueError(f"shard_batch: {rows} rows do not divide over {world} ranks of {axis!r}")
    size = rows // world
    return batch.narrow(dim, rank * size, size)


def make_data_parallel_step(loss_fn: Callable[..., torch.Tensor], opt, mesh: Optional[DeviceMesh],
                            axis: str = "data", batch_dims: Sequence[int] = (0,)):
    """``step(params, opt_state, *inputs) -> (opt_state, loss)``.

    ``inputs`` are global (every rank passes the same): the ``k``-th is
    cut along ``batch_dims[k]`` (0 for the rest) by :func:`shard_batch`,
    and ``loss_fn(*shards)`` returns the rank's loss, summed over its
    rows. The losses and gradients are summed over the ranks (one
    all-reduce of a flat buffer), then ``opt`` (``train.optim.Adam``)
    updates ``params`` in place unless the global loss or gradient norm is
    not finite (``apply_gated``). Forward and backward run without TF32.
    ``mesh=None`` is one process on the whole batch, no collective.
    ``loss`` is the global one, on the device: nothing is read on the
    host."""
    group = mesh.get_group(axis) if mesh is not None else None

    def step(params: Sequence[torch.Tensor], opt_state: AdamState, *inputs):
        params = list(params)
        if mesh is not None:
            dims = list(batch_dims) + [0] * (len(inputs) - len(batch_dims))
            inputs = [shard_batch(mesh, x, axis, d) for x, d in zip(inputs, dims)]
        with no_tf32():
            loss = loss_fn(*inputs)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        loss = loss.detach()
        if group is not None:
            flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            loss = flat[0]
            parts = torch.split(flat[1:], [g.numel() for g in grads])
            grads = [part.view_as(g) for part, g in zip(parts, grads)]
        with torch.no_grad():
            gnorm = global_norm(grads)
            updates, new_state = opt.update(grads, opt_state)
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            opt_state = apply_gated(params, updates, opt_state, new_state, ok)
        return opt_state, loss

    return step
