"""Sinusoidal positional encodings (counterpart of
``mptpu/nn/pos_encode.py``). The grids are ``ops.windows.linspace``, which
computes ``jnp.linspace``'s float32 values."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.kinks import clip
from ..ops.windows import linspace
from .init import uniform_linear


def positional_encoding(sequence_length: int, n_freqs: int, geometric_freq_spacing: bool = False,
                        geometric_freq_decay: bool = False, device=None) -> torch.Tensor:
    """(n_freqs, sequence_length) sines over [-pi, pi], frequencies 1 to
    ``sequence_length // 2``, scaled from 1 down to 1e-8."""
    time = linspace(-math.pi, math.pi, sequence_length, device=device)
    freqs = linspace(1, sequence_length // 2, n_freqs, device=device)
    if geometric_freq_spacing:
        freqs = freqs**2
    scaling = linspace(1, 1e-8, n_freqs, device=device)
    if geometric_freq_decay:
        scaling = scaling**2
    return torch.sin(time[None, :] * freqs[:, None]) * scaling[:, None]


def pos_encode_feature(x: torch.Tensor, domain: float, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^i x), cos(2^i x), ...] over the last axis, ``x`` clipped
    to +-``domain``."""
    x = clip(x, -domain, domain)
    output = [x]
    for i in range(n_freqs):
        output.append(torch.sin((2**i) * x))
        output.append(torch.cos((2**i) * x))
    return torch.cat(output, dim=-1)


def n_features_for_freq(n_freqs: int) -> int:
    return n_freqs * 2 + 1


def pos_encoded(batch_size: int, time_dim: int, n_freqs: int, domain: float = 1.0,
                device=None) -> torch.Tensor:
    """(batch, time, 2 n_freqs + 1) sinusoid features of a grid over
    [-domain, domain]."""
    n_features = n_features_for_freq(n_freqs)
    grid = linspace(-domain, domain, time_dim, device=device).reshape(-1, 1)
    pos = pos_encode_feature(grid, 1.0, n_freqs).reshape(1, time_dim, n_features)
    return pos.expand(batch_size, time_dim, n_features)


class LearnedPosEncodings(nn.Module):
    """Sinusoid features projected by ``Dense_0`` and added to the input
    (batch, time, out_channels). ``Dense_0`` is drawn uniform in +-0.1 from
    ``generator`` (a CPU one, default seed 0), not with flax's initialiser."""

    def __init__(self, n_freqs: int, out_channels: int, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_freqs = n_freqs
        self.Dense_0 = uniform_linear(n_features_for_freq(n_freqs), out_channels, True, 0.1, gen,
                                      device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = pos_encoded(x.shape[0], x.shape[1], self.n_freqs, device=x.device)
        return x + self.Dense_0(pos)
