"""Impulse (attack transient) generation: a conv-upsampled latent drives
frame-wise noise filters, and the filtered noise is shaped by a squared
envelope (counterpart of ``mptpu/gen/impulse.py``). Children carry flax's
names. The noise is an argument, or drawn from a ``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import no_tf32
from ..nn.init import uniform_linear
from ..nn.linear import LinearOutputStack
from ..nn.upsample import ConvUpsample
from ..ops.kinks import clip
from ..ops.upsample import interpolate_last_axis
from .ddsp import noise_bank2


class NoiseModel(nn.Module):
    """(batch, input_channels, input_size) -> (batch, 1, n_audio_samples):
    a learned upsampler to ``n_noise_frames`` frames of filter magnitudes
    (``activation`` ``"sigmoid"``, else a clip to [-1, 1]; ``squared``;
    the first ``mask_after`` coefficients set to 1), then
    :func:`noise_bank2`."""

    def __init__(self, input_channels: int, input_size: int, n_noise_frames: int,
                 n_audio_samples: int, channels: int, squared: bool = False,
                 mask_after: Optional[int] = None, activation: str = "clamp",
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.input_channels, self.input_size = input_channels, input_size
        self.squared, self.mask_after, self.activation = squared, mask_after, activation
        noise_coeffs = n_audio_samples // n_noise_frames + 1
        self.ConvUpsample_0 = ConvUpsample(input_channels, channels, start_size=input_size,
                                           end_size=n_noise_frames, mode="learned",
                                           out_channels=noise_coeffs, from_latent=False,
                                           in_channels=input_channels, generator=gen,
                                           device=device)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.ConvUpsample_0(x.reshape(x.shape[0], self.input_channels, self.input_size))
        x = torch.sigmoid(x) if self.activation == "sigmoid" else clip(x, -1.0, 1.0)
        if self.squared:
            x = x**2
        if self.mask_after is not None:
            # mptpu's x.at[:, :mask_after].set(1.0): no gradient reaches them
            x = torch.cat([torch.ones_like(x[:, : self.mask_after]), x[:, self.mask_after:]], 1)
        return noise_bank2(x, noise, generator)


class GenerateMix(nn.Module):
    """Latent -> a residual MLP (3 layers) to ``mixer_channels`` ->
    (-1, encoding_channels, 1), softmaxed over its last axis."""

    def __init__(self, latent_dim: int, channels: int, encoding_channels: int,
                 mixer_channels: int = 2, generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.encoding_channels = encoding_channels
        self.LinearOutputStack_0 = LinearOutputStack(channels, 3, out_channels=mixer_channels,
                                                     in_channels=latent_dim, generator=gen,
                                                     device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            x = self.LinearOutputStack_0(x)
        return torch.softmax(x.reshape(-1, self.encoding_channels, 1), dim=-1)


class GenerateImpulse(nn.Module):
    """Latent (batch, latent_dim) -> (batch, 1, n_samples): noise filtered
    by a :class:`NoiseModel` over ``4 * n_samples // 256`` frames (sigmoid,
    squared, the first coefficient 1) times a squared envelope of
    ``n_samples // 256`` frames. ``noise`` is the (batch, n_samples)
    uniform draw in [-1, 1)."""

    def __init__(self, latent_dim: int, channels: int, n_samples: int, n_filter_bands: int,
                 encoding_channels: int, generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_samples = n_samples
        n_frames = n_samples // 256
        self.Dense_0 = uniform_linear(latent_dim, n_frames, True, 0.1, gen, device)
        self.ConvUpsample_0 = ConvUpsample(latent_dim, channels, start_size=4, end_size=n_frames,
                                           mode="learned", out_channels=channels,
                                           from_latent=True, generator=gen, device=device)
        self.NoiseModel_0 = NoiseModel(channels, n_frames, n_frames * 4, n_samples, channels,
                                       squared=True, mask_after=1, activation="sigmoid",
                                       generator=gen, device=device)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with no_tf32():
            env = self.Dense_0(x) ** 2
        env = interpolate_last_axis(env, self.n_samples)
        h = self.NoiseModel_0(self.ConvUpsample_0(x), noise, generator)
        return h.reshape(x.shape[0], -1, self.n_samples) * env
