"""Audio-texture statistics (counterpart of ``mptpu/perceptual/texture.py``):
per octave band, the power envelopes of a gammatone bank, their forward and
backward spectral autocorrelations within and between neighbouring
channels, and the kurtosis of the envelopes and of their differences."""

from __future__ import annotations

import torch

from ..device import default_device
from ..ops import kinks
from ..ops.decompose import fft_frequency_decompose
from ..ops.fft import fft_convolve
from ..ops.norms import unit_norm
from ..ops.upsample import ensure_last_axis_length
from .gammatone import gammatone_filter_bank


def calculate_kurtosis(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Excess kurtosis along ``axis``: the fourth central moment over the
    square of the unbiased (n - 1) variance + 1e-12, less 3."""
    mean = torch.mean(x, dim=axis, keepdim=True)
    n = x.shape[axis]
    var = torch.sum((x - mean) ** 2, dim=axis, keepdim=True) / max(n - 1, 1)
    fourth = torch.mean((x - mean) ** 4, dim=axis, keepdim=True)
    return fourth / (var**2 + 1e-12) - 3.0


class AudioTextureFeatures:
    """Texture statistics of (batch, 1, n_samples) audio over a linear
    gammatone bank of ``n_filters`` x ``filter_size`` (unit-normed), bands
    from ``min_band_size`` up."""

    def __init__(self, n_samples: int, n_filters: int = 64, filter_size: int = 64,
                 samplerate: int = 22050, min_band_size: int = 512, device=None):
        self.n_samples = n_samples
        self.n_filters = n_filters
        self.filter_size = filter_size
        self.min_band_size = min(min_band_size, n_samples)
        fb = gammatone_filter_bank(n_filters, filter_size, start_hz=20,
                                   stop_hz=samplerate // 2 - 10, samplerate=samplerate,
                                   band_spacing="linear")
        # normed on the host, so that every device holds the same float32 bank
        self.fb = unit_norm(torch.from_numpy(fb)).to(default_device(device))

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        batch = audio.shape[0]
        audio = audio.reshape(-1, 1, self.n_samples)
        results = []
        for size, band in fft_frequency_decompose(audio, self.min_band_size).items():
            fb = self.fb.to(audio.dtype).reshape(1, self.n_filters, self.filter_size)
            spec = fft_convolve(ensure_last_axis_length(fb, size), band) ** 2
            fwd = torch.abs(torch.fft.rfft(spec, dim=-1))
            bwd = torch.abs(torch.fft.rfft(torch.flip(spec, dims=(-1,)), dim=-1))
            results.append(torch.cat([
                (fwd * bwd).reshape(batch, -1),
                (fwd[:, 1:, :] * bwd[:, :-1, :]).reshape(batch, -1),
                calculate_kurtosis(spec).reshape(batch, -1),
                calculate_kurtosis(spec[:, 1:, :] - spec[:, :-1, :]).reshape(batch, -1),
            ], dim=-1))
        return torch.cat(results, dim=-1)

    def loss(self, target: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        return kinks.abs(self(recon) - self(target)).sum()
