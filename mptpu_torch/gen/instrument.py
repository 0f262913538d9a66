"""Instrument layers and stacks (counterpart of ``mptpu/gen/instrument.py``):
a control-plane energy signal is decayed, then turned into a mixture of
sinusoids by a hypernetwork's matrix conditioned on a time-varying shape,
and the layers are mixed by learned weights. Children carry flax's names
(``hyper``, ``energy_hyper``, ``layer_{i}``).

The positional encoding is ``sin`` of up to 0.49 pi n_samples rad, where
float32 keeps about 4e-3 rad at 2^15 samples: comparisons across packages
or devices hold these layers in float64.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from ..device import default_device, no_tf32
from ..ops.fft import fft_convolve
from ..ops.upsample import interpolate_last_axis
from ..ops.windows import linspace
from .reds import exponential_decay
from .ssm import HyperNetworkLayer


class InstrumentLayer(nn.Module):
    """``forward(energy, transforms, decays)``: energy (batch, events,
    channels, frames), transforms (batch, events, shape_channels,
    shape_frames), decays (batch, events, 1) -> (audio (batch, events,
    n_samples), the next layer's energy (batch, events, channels, frames)).
    ``frames`` must be ``n_frames``."""

    def __init__(self, encoding_channels: int, channels: int, n_frames: int, n_samples: int,
                 shape_channels: int, generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        self.encoding_channels, self.channels, self.n_frames = (encoding_channels, channels,
                                                                n_frames)
        self.n_samples, self.shape_channels = n_samples, shape_channels
        self.base_shape = nn.Parameter(torch.zeros(shape_channels, device=dev))
        self.deformability = nn.Parameter(torch.full((1,), 0.1, device=dev))
        self.hyper = HyperNetworkLayer(shape_channels, 64, channels, encoding_channels, gen, dev)
        self.energy_hyper = HyperNetworkLayer(shape_channels, 16, channels, channels, gen, dev)

    def pos_encoding(self, device, dtype) -> torch.Tensor:
        """(1, 1, encoding_channels, n_samples) sines at frequencies from 1e-5
        to 0.49 of Nyquist."""
        freqs = linspace(0.00001, 0.49, self.encoding_channels, device=device, dtype=dtype)
        t = linspace(0.0, float(self.n_samples), self.n_samples, device=device, dtype=dtype)
        p = torch.sin(t[None, :] * freqs[:, None] * math.pi)
        return p.reshape(1, 1, self.encoding_channels, self.n_samples)

    def forward(self, energy, transforms, decays):
        batch, n_events, _, frames = energy.shape
        envelopes = exponential_decay(decays, n_atoms=n_events, n_frames=frames,
                                      base_resonance=0.5, n_samples=frames)
        envelopes = envelopes.reshape(batch, n_events, 1, frames).expand(energy.shape)
        energy = fft_convolve(energy, envelopes).permute(0, 1, 3, 2)   # (b, E, frames, cp)

        transforms = transforms + self.deformability * self.base_shape[None, None, :, None]
        transforms = interpolate_last_axis(transforms, self.n_frames).permute(0, 1, 3, 2)
        flat_shape = transforms.reshape(-1, self.shape_channels)
        flat_energy = energy.reshape(-1, 1, self.channels)
        with no_tf32():
            w = self.hyper(flat_shape)                 # (b E frames, channels, encoding)
            w_energy = self.energy_hyper(flat_shape)   # (b E frames, channels, channels)
            transformed = torch.matmul(flat_energy, w)[:, 0, :]
            next_energy = torch.matmul(flat_energy, w_energy)[:, 0, :]
        transformed = transformed.reshape(batch, n_events, self.n_frames, self.encoding_channels)
        transformed = interpolate_last_axis(transformed.permute(0, 1, 3, 2), self.n_samples)
        next_energy = next_energy.reshape(batch, n_events, frames, self.channels)
        final = self.pos_encoding(energy.device, energy.dtype) * torch.relu(transformed)
        return torch.sum(final, dim=2), next_energy.permute(0, 1, 3, 2)


class InstrumentStack(nn.Module):
    """``n_layers`` :class:`InstrumentLayer` s (``layer_{i}``), each fed the
    energy the one before returns and its own transforms and decays, their
    audio mixed by ``softmax(mix)`` (batch, events, n_layers)."""

    def __init__(self, encoding_channels: int, channels: int, n_frames: int, n_samples: int,
                 shape_channels: int, n_layers: int, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", InstrumentLayer(encoding_channels, channels, n_frames,
                                                          n_samples, shape_channels, gen, device))

    def forward(self, energy, transforms: List[torch.Tensor], decays: List[torch.Tensor], mix):
        outputs, e = [], energy
        for i in range(self.n_layers):
            audio, e = getattr(self, f"layer_{i}")(e, transforms[i], decays[i])
            outputs.append(audio)
        stacked = torch.stack(outputs, dim=2)   # (b, E, layers, n)
        return torch.sum(stacked * torch.softmax(mix, dim=-1)[:, :, :, None], dim=2)
