"""FFT-domain octave band decomposition and recomposition, the codec's
filterbank (counterpart of ``mptpu/ops/decompose.py``).

An ortho rFFT is split into octave bands, each inverse-transformed at its
own native sample rate; ``fft_frequency_recompose`` resamples every band
back to the target rate by placing its spectrum into the matching
coefficient range. Band sizes are Python ints and the returned dict is
keyed by band length. FFTs run in float32 / complex64.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .fft import irfft, real_ends as _real_ends, rfft


def band_sizes(n_samples: int, min_size: int) -> List[int]:
    """The band lengths [min_size, 2 * min_size, ..., n_samples]."""
    sizes = []
    current = min_size
    while current <= n_samples:
        sizes.append(current)
        current *= 2
    return sizes


def fft_frequency_decompose(x: torch.Tensor, min_size: int) -> Dict[int, torch.Tensor]:
    """Split (batch, channels, n_samples) into octave bands.

    The band of size ``s`` holds frequencies (s/4, s/2] of the original
    spectrum (the lowest band keeps everything below its Nyquist), sampled
    at its own rate.
    """
    n_samples = x.shape[-1]
    coeffs = rfft(x, axis=-1, norm="ortho")
    output: Dict[int, torch.Tensor] = {}
    for size in band_sizes(n_samples, min_size):
        sl = coeffs[..., : size // 2 + 1]
        if size > min_size:
            mask = torch.zeros(sl.shape[-1], dtype=torch.float32, device=x.device)
            mask[size // 4 : size // 2 + 1] = 1.0
            sl = sl * mask
        output[size] = irfft(_real_ends(sl), n=size, axis=-1, norm="ortho")
    return output


def fft_resample(x: torch.Tensor, desired_size: int, is_lowest_band: bool) -> torch.Tensor:
    """Resample one band up to ``desired_size`` samples by placing its
    spectrum into the matching coefficient range (all of it for the lowest
    band, its upper half otherwise)."""
    coeffs = rfft(x, axis=-1, norm="ortho")
    n_coeffs = coeffs.shape[-1]
    new_coeffs = torch.zeros(
        (*coeffs.shape[:-1], desired_size // 2 + 1), dtype=coeffs.dtype, device=coeffs.device
    )
    lo = 0 if is_lowest_band else n_coeffs // 2
    new_coeffs[..., lo:n_coeffs] = coeffs[..., lo:]
    return irfft(new_coeffs, n=desired_size, axis=-1, norm="ortho")


def fft_frequency_recompose(d: Dict[int, torch.Tensor], desired_size: int) -> torch.Tensor:
    """Sum of every band resampled to ``desired_size``."""
    first_band = min(d.keys())
    out = None
    for size, band in d.items():
        resampled = fft_resample(band, desired_size, size == first_band)
        out = resampled if out is None else out + resampled
    return out
