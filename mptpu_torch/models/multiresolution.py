"""The multiresolution codec's shells (counterpart of
``mptpu/models/multiresolution.py``): per-band encoders over a feature
dict and a summariser; per-band decoders recomposed into audio. Children
carry flax's names (``band_<key>``, ``summarizer``)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..ops.decompose import fft_frequency_recompose
from ..nn.linear import LinearOutputStack
from ..nn.upsample import ConvUpsample


class BandEncoder(nn.Module):
    """(batch, 64 x frames x feature) periodicity features -> (batch, 64 x
    ``periodicity_channels``, frames) through ``LinearOutputStack_0``."""

    def __init__(self, channels: int, periodicity_feature_size: int,
                 periodicity_channels: int = 8, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.feature_size = periodicity_feature_size
        self.LinearOutputStack_0 = LinearOutputStack(
            channels, 3, out_channels=periodicity_channels, in_channels=periodicity_feature_size,
            generator=generator or torch.Generator().manual_seed(0), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch = x.shape[0]
        x = x.reshape(batch, 64, -1, self.feature_size)
        frames = x.shape[2]
        x = self.LinearOutputStack_0(x).permute(0, 3, 1, 2)
        return x.reshape(batch, -1, frames)


class EncoderShell(nn.Module):
    """A feature dict {band: features} -> (batch, latent_dim): each band
    encoded (``band_<key>``, in sorted key order, 8 periodicity channels),
    the encodings joined over time, averaged over it and summarised."""

    def __init__(self, channels: int, band_feature_sizes: Dict[int, int], latent_dim: int = 128,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.keys = sorted(band_feature_sizes)
        for k in self.keys:
            self.add_module(f"band_{k}", BandEncoder(channels, band_feature_sizes[k],
                                                     generator=gen, device=device))
        self.summarizer = LinearOutputStack(channels, 2, out_channels=latent_dim,
                                            in_channels=64 * 8, generator=gen, device=device)

    def forward(self, x: Dict[int, torch.Tensor]) -> torch.Tensor:
        encodings = torch.cat([getattr(self, f"band_{k}")(x[k]) for k in self.keys], dim=-1)
        return self.summarizer(torch.mean(encodings, dim=-1))


class ConvBandDecoder(nn.Module):
    """latent -> one band's audio (batch, 1, band_size) by a nearest-mode
    ``ConvUpsample_0`` from ``max(4, band_size // 64)`` samples."""

    def __init__(self, channels: int, band_size: int, latent_dim: int = 128,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.band_size = band_size
        self.ConvUpsample_0 = ConvUpsample(latent_dim, channels, max(4, band_size // 64),
                                           band_size, mode="nearest", out_channels=1,
                                           generator=generator, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.ConvUpsample_0(z).reshape(-1, 1, self.band_size)


class DecoderShell(nn.Module):
    """latent -> every band (``band_<size>``) -> audio (batch, 1,
    n_samples) recomposed from the bands."""

    def __init__(self, channels: int, band_sizes: Sequence[int], n_samples: int,
                 latent_dim: int = 128, generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.band_sizes, self.n_samples = tuple(band_sizes), n_samples
        for size in self.band_sizes:
            self.add_module(f"band_{size}", ConvBandDecoder(channels, size, latent_dim, gen,
                                                            device))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        bands = {size: getattr(self, f"band_{size}")(z) for size in self.band_sizes}
        return fft_frequency_recompose(bands, self.n_samples)
