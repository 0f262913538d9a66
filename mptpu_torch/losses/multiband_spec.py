"""Multi-resolution multiband spectrogram features (counterpart of
``mptpu/losses/multiband_spec.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.decompose import fft_frequency_decompose
from ..ops.stft import stft


def stft_transform(x: torch.Tensor, transform_window_size: int = 2048,
                   transform_step_size: int = 256) -> torch.Tensor:
    """STFT magnitude as (batch, coeffs - 1, frames)."""
    batch_size = x.shape[0]
    s = stft(x, transform_window_size, transform_step_size, pad=True)
    n_coeffs = transform_window_size // 2 + 1
    s = s.reshape(batch_size, -1, n_coeffs)[..., : n_coeffs - 1]
    return s.transpose(1, 2)


def multiband_spectrogram(
    x: torch.Tensor,
    stft_spec: Dict[str, Tuple[int, int]],
    smallest_band_size: int = 512,
    normalize: bool = False,
) -> Dict[str, torch.Tensor]:
    """An octave decomposition, then an STFT of every band at every
    resolution ``name: (window, step)``; keys ``f"{band_size}_{name}"``,
    resolutions outside and bands inside, the order in which
    ``flattened_multiband_spectrogram`` concatenates them."""
    bands = fft_frequency_decompose(x, smallest_band_size)
    accum: Dict[str, torch.Tensor] = {}
    for name, (ws, step) in stft_spec.items():
        for k, v in bands.items():
            s = stft(v, ws, step, pad=True)
            if normalize:
                s = s / v.numel()
            accum[f"{k}_{name}"] = s
    return accum


def flattened_multiband_spectrogram(
    x: torch.Tensor,
    stft_spec: Dict[str, Tuple[int, int]],
    smallest_band_size: int = 512,
    normalize: bool = False,
) -> torch.Tensor:
    """Every (band, resolution) spectrogram flattened to (batch, channels,
    -1) and concatenated: the splat loss's feature."""
    batch_size, channels = x.shape[0], x.shape[1]
    bands = multiband_spectrogram(x, stft_spec, smallest_band_size, normalize)
    return torch.cat([b.reshape(batch_size, channels, -1) for b in bands.values()], dim=-1)
