"""The scattering transform (counterpart of
``mptpu/perceptual/scattering.py``): first-order rectified filter-bank
energies and the second-order structure of their fine detail (each
channel less its local average). ``MoreCorrectScattering`` refilters each
fine-detail channel by the filters below it, one band at a time, as
``mptpu`` does."""

from __future__ import annotations

import numpy as np
import torch

from ..device import default_device
from ..ops import kinks
from .filterbank import avg_pool_1d, filter_bank_convolve, morlet_filter_bank


def scattering_transform(signal: torch.Tensor, d: torch.Tensor, window_size: int = 512,
                         step_size: int = 256):
    """(batch, samples) x (n_filters, taps) -> (c1, c2): the first-order
    coefficients (batch, n_filters, frames) and the second-order ones
    (batch, n_filters ** 2, frames)."""
    batch, samples = signal.shape
    s1 = kinks.abs(filter_bank_convolve(signal, d)).reshape(batch, -1, samples)
    pooled = avg_pool_1d(s1, window_size, 1, step_size)[..., :samples]
    c1 = avg_pool_1d(pooled, step_size, step_size, step_size // 2)
    s2 = (s1 - pooled).reshape(-1, samples)
    s2 = kinks.abs(filter_bank_convolve(s2, d)).reshape(batch, -1, samples)
    c2 = avg_pool_1d(s2, window_size, step_size, step_size)
    return c1, c2


class MoreCorrectScattering:
    """Scattering over a real morlet bank where fine-detail channel ``i``
    (from 2 up) is refiltered only by the ``i`` filters below it; the
    window is the kernel size, the hop half of it."""

    def __init__(self, samplerate: int, center_frequencies_hz, kernel_size: int,
                 scaling_factors=0.1, device=None):
        bank = morlet_filter_bank(samplerate, kernel_size, center_frequencies_hz,
                                  scaling_factors).real.astype(np.float32)
        self.filter_bank = torch.from_numpy(bank).to(default_device(device))
        self.window_size = kernel_size
        self.step_size = kernel_size // 2
        self.n_bands = bank.shape[0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, ..., n) -> (batch, n_bands + sum of 2 .. n_bands - 1,
        n // step)."""
        batch = x.shape[0]
        x = x.reshape(batch, -1)
        n_samples = x.shape[-1]
        n_frames = n_samples // self.step_size
        ws, step = self.window_size, self.step_size
        orig_spec = kinks.abs(filter_bank_convolve(x, self.filter_bank, padding=step))
        avg = avg_pool_1d(orig_spec, ws, 1, step)[..., :n_samples]
        first_order = avg_pool_1d(orig_spec, ws, step, step)[..., :n_frames]
        fine = (orig_spec - avg).reshape(batch, self.n_bands, n_samples)
        output = []
        for i in range(2, self.n_bands):
            spec = kinks.abs(filter_bank_convolve(fine[:, i, :], self.filter_bank[:i],
                                                  padding=step))
            output.append(avg_pool_1d(spec, ws, step, step)[..., :n_frames])
        return torch.cat([first_order, torch.cat(output, dim=1)], dim=1)
