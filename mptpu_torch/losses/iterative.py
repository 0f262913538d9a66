"""Greedy per-event energy-removal loss (counterpart of
``mptpu/losses/iterative.py``).

The target and every event channel are transformed, the channels sorted
loudest first, and each event is rewarded for the energy it removes from
the running residual. ``mptpu``'s ``lax.scan`` over events is a loop here.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import kinks

TensorTransform = Callable[[torch.Tensor], torch.Tensor]


def sort_channels_descending_norm(x: torch.Tensor) -> torch.Tensor:
    """(batch, channels, D) with channels in descending order of their l1
    norm: a stable ascending sort, reversed, as ``jnp.argsort`` then
    ``[:, ::-1]`` (equal norms come out in reverse order)."""
    diff = torch.sum(kinks.abs(x), dim=-1)
    indices = torch.argsort(diff, dim=-1, stable=True).flip(-1)
    return torch.gather(x, 1, indices[:, :, None].expand(-1, -1, x.shape[-1]))


def iterative_loss(
    target_audio: torch.Tensor,
    recon_channels: torch.Tensor,
    transform: TensorTransform,
    return_residual: bool = False,
    ratio_loss: bool = False,
    sort_channels: bool = True,
):
    """target_audio (batch, 1, time), recon_channels (batch, n_events,
    time); ``transform`` maps (batch, channels, time) to any shape and is
    applied once to the target and once to all channels."""
    batch = target_audio.shape[0]
    n_events = recon_channels.shape[1]
    time = recon_channels.shape[-1]

    residual = transform(target_audio.reshape(batch, 1, time)).reshape(batch, -1)
    channels = transform(recon_channels.reshape(batch, n_events, time)).reshape(batch, n_events, -1)
    if sort_channels:
        channels = sort_channels_descending_norm(channels)

    losses = []
    for i in range(n_events):
        start_norm = torch.sum(kinks.abs(residual), dim=-1)
        residual = residual - channels[:, i]
        end_norm = torch.sum(kinks.abs(residual), dim=-1)
        if ratio_loss:
            losses.append(torch.sum(end_norm / (start_norm + 1e-12)))
        else:
            losses.append(torch.sum(-(start_norm - end_norm)))
    loss = torch.sum(torch.stack(losses))
    if return_residual:
        return residual, loss
    return loss
