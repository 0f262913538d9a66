"""Shift-and-subtract matching pursuit and the serial transform-domain
loss (counterpart of ``mptpu/losses/serial.py``; ``mptpu``'s scan over
events is a loop here)."""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import kinks
from ..ops.fft import fft_convolve, fft_shift


def serial_matching_pursuit(inp: torch.Tensor, target: torch.Tensor):
    """inp (batch, n_events, n_samples), target (batch, 1, n_samples) ->
    (residual, recon): each unit-normed event, in order, placed at the lag
    of its largest correlation with the running residual (the first such
    lag), scaled by that correlation and subtracted."""
    n_samples = inp.shape[-1]
    inp = inp / (torch.linalg.vector_norm(inp, dim=-1, keepdim=True) + 1e-8)
    recon = torch.zeros_like(target)
    for i in range(inp.shape[1]):
        atom = inp[:, i:i + 1, :]
        feature_map = fft_convolve(atom, target)
        values = torch.amax(feature_map, dim=-1)
        scalar = torch.argmax(feature_map, dim=-1).to(inp.dtype) / n_samples
        shifted = fft_shift(atom, scalar[..., None]) * values[..., None]
        target, recon = target - shifted, recon + shifted
    return target, recon


def serial_loss(inp: torch.Tensor, target: torch.Tensor,
                transform: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``sum(|transform(target) - sum of transform(event)|)`` over the
    events of ``inp`` (batch, n_events, n_samples)."""
    batch, n_events, n_samples = inp.shape
    t = transform(target)
    x = transform(inp.reshape(-1, 1, n_samples))
    x = x.reshape((batch, n_events) + tuple(x.shape[1:]))
    return torch.sum(kinks.abs(t - torch.sum(x, dim=1)))
