"""The recurrent frame synthesiser (counterpart of
``mptpu/gen/recurrent.py``): per-frame noise bands and oscillators, driven
by a latent that a gated recurrence evolves for a fixed number of frames.
Children carry flax's names.

The oscillators' phase is a running sum over every sample: at thousands
of radians float32 keeps about 1e-3 rad of it, so comparisons across
packages or devices hold the synthesiser in float64.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import no_tf32
from ..nn.linear import LinearOutputStack
from ..ops.norms import unit_norm
from ..ops.upsample import interpolate_last_axis
from .ddsp import noise_bank2


class FrameSynth(nn.Module):
    """(batch, time, channels) latents -> (batch, 1, time *
    samples_per_frame): noise filtered by ``LinearOutputStack_0``'s
    per-frame magnitudes (``noise``, the (batch, time * samples_per_frame)
    uniform draw of :func:`noise_bank2`) plus ``n_osc`` oscillators whose
    amplitude and frequency are the norm and angle of
    ``LinearOutputStack_1``'s pairs."""

    def __init__(self, layers: int, channels: int, samples_per_frame: int, n_osc: int = 64,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.samples_per_frame, self.n_osc = samples_per_frame, n_osc
        self.LinearOutputStack_0 = LinearOutputStack(channels, layers,
                                                     out_channels=samples_per_frame + 1,
                                                     generator=gen, device=device)
        self.LinearOutputStack_1 = LinearOutputStack(channels, layers, out_channels=2 * n_osc,
                                                     generator=gen, device=device)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        batch, time, _ = x.shape
        with no_tf32():
            noise_params = self.LinearOutputStack_0(x)
            osc = self.LinearOutputStack_1(x).reshape(batch, time, self.n_osc, 2)
        noise = noise_bank2(noise_params.transpose(1, 2), noise, generator)
        amp = torch.linalg.vector_norm(osc, dim=-1).transpose(1, 2)
        freq = (torch.atan2(osc[..., 1], osc[..., 0]) / math.pi).transpose(1, 2)
        freq = freq * 0.98 + 0.0036
        total = self.samples_per_frame * time
        amp = interpolate_last_axis(amp, total)
        freq = interpolate_last_axis(freq, total)
        sig = torch.sin(torch.cumsum(freq * math.pi, dim=-1)) * amp
        return torch.sum(sig, dim=1, keepdim=True) + noise


class RecurrentSynth(nn.Module):
    """Latent (batch, channels) -> ``max_iter`` frames of a recurrence
    (``LinearOutputStack_0``, the state unit-normed between steps), each
    weighted by the first of a softmax gate pair (``LinearOutputStack_1``),
    -> :class:`FrameSynth` (``FrameSynth_0``)."""

    def __init__(self, layers: int, channels: int, samples_per_frame: int, max_iter: int = 10,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.channels, self.samples_per_frame, self.max_iter = (channels, samples_per_frame,
                                                                 max_iter)
        self.LinearOutputStack_0 = LinearOutputStack(channels, layers, generator=gen,
                                                     device=device)
        self.LinearOutputStack_1 = LinearOutputStack(channels, layers, out_channels=2,
                                                     generator=gen, device=device)
        self.FrameSynth_0 = FrameSynth(layers, channels, samples_per_frame, generator=gen,
                                       device=device)

    def noise_shape(self, batch: int):
        """The shape of one forward's noise draw."""
        return (batch, self.max_iter * self.samples_per_frame)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = unit_norm(x)
        latents, amps = [], []
        with no_tf32():
            for _ in range(self.max_iter):
                h = self.LinearOutputStack_0(h)
                amps.append(torch.softmax(self.LinearOutputStack_1(h), dim=-1)[..., 0:1])
                latents.append(h)
                h = unit_norm(h)
        seq = torch.stack(latents, 1).reshape(x.shape[0], self.max_iter, self.channels)
        amp = torch.stack(amps, 1).reshape(x.shape[0], self.max_iter, 1)
        return self.FrameSynth_0(seq * amp, noise, generator)
