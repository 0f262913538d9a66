"""Spiking-style perceptual losses (counterpart of
``mptpu/losses/autocorrelation.py``): spectral autocorrelation features of
a rectified gammatone bank, and an envelope loss against a bank of decay
templates less a trailing moving average."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import default_device
from ..ops import kinks
from ..ops.decompose import fft_frequency_decompose
from ..ops.fft import fft_convolve
from ..ops.norms import unit_norm
from ..ops.stft import stft
from ..perceptual.gammatone import gammatone_filter_bank


def _frame(x: torch.Tensor, window: int, step: int) -> torch.Tensor:
    """(..., n) -> (..., 1 + (n + step - window) // step, window): ``step``
    zeros appended first, unlike ``ops.stft._frame``."""
    return F.pad(x, (0, step)).unfold(-1, window, step)


class AutocorrelationLoss:
    """Gammatone channels (linear, 20 Hz to 11 kHz, unit-normed), half-wave
    rectified, framed, rFFT'd; the features are the magnitudes of the
    products of neighbouring bins and of neighbouring frames."""

    def __init__(self, n_channels: int = 64, filter_size: int = 128, device=None):
        self.n_channels = n_channels
        self.filter_size = filter_size
        g = gammatone_filter_bank(n_filters=n_channels, size=filter_size, band_spacing="linear")
        # normed on the host, so that every device holds the same float32 bank
        self.gammatone = unit_norm(torch.from_numpy(g))[None].to(default_device(device))

    def features(self, audio: torch.Tensor, window_size: int = 128,
                 step_size: int = 64) -> torch.Tensor:
        n_samples = audio.shape[-1]
        audio = audio.reshape(-1, 1, n_samples)
        g = F.pad(self.gammatone.to(audio.dtype), (0, n_samples - self.filter_size))
        channels = torch.relu(fft_convolve(audio, g))
        spec = torch.fft.rfft(_frame(channels, window_size, step_size), dim=-1)
        corr = torch.abs(spec[..., 1:] * spec[..., :-1])
        corr2 = torch.abs(spec[:, :, 1:, :] * spec[:, :, :-1, :])
        return torch.cat([corr.reshape(-1), corr2.reshape(-1)])

    def loss(self, target: torch.Tensor, recon: torch.Tensor, window_size: int = 128,
             step_size: int = 64) -> torch.Tensor:
        t = self.features(target, window_size, step_size)
        r = self.features(recon, window_size, step_size)
        return kinks.abs(t - r).sum()

    def multiband_loss(self, target: torch.Tensor, recon: torch.Tensor, window_size: int = 128,
                       step_size: int = 64, min_size: int = 512) -> torch.Tensor:
        """:meth:`loss` summed over the octave bands of both signals."""
        tb = fft_frequency_decompose(target, min_size)
        rb = fft_frequency_decompose(recon, min_size)
        loss = 0.0
        for k in tb:
            loss = loss + kinks.abs(self.features(tb[k], window_size, step_size)
                                    - self.features(rb[k], window_size, step_size)).sum()
        return loss

    __call__ = loss


class DecayLoss:
    """STFT frames (hop half the window) convolved over time with
    ``n_decays`` templates ``(1 - t) ** e``, ``e`` from ``min_decay`` to
    ``max_decay``, each unit-normed; less the mean of the ``pool`` frames
    before each frame (the frame itself left out); rectified."""

    def __init__(self, n_samples: int, n_decays: int = 16, min_decay: float = 0.5,
                 max_decay: float = 32.0, window_size: int = 512, pool: int = 16, device=None):
        self.n_samples = n_samples
        self.window_size = window_size
        self.step_size = window_size // 2
        self.n_frames = n_samples // self.step_size
        self.pool = pool
        base = np.linspace(1, 0, self.n_frames)[None, :]
        exps = np.linspace(min_decay, max_decay, n_decays)[:, None]
        decays = base**exps
        decays = decays / (np.linalg.norm(decays, axis=-1, keepdims=True) + 1e-8)
        self.decays = torch.from_numpy(decays.astype(np.float32)).to(
            default_device(device))[None, None]   # (1, 1, D, F)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        batch = x.shape[0]
        spec = stft(x, self.window_size, self.step_size, pad=True).transpose(-1, -2)
        smeared = fft_convolve(spec[:, :, :, None, :], self.decays.to(x.dtype)[:, :, None])
        smeared = smeared.reshape(batch, -1, self.n_frames)
        # the mean of the k frames before each frame, by a running sum:
        # F.avg_pool1d(F.pad(x, [k, 0]), k, 1) without its last frame
        k = self.pool
        csum = F.pad(torch.cumsum(F.pad(smeared, (k, 0)), dim=-1), (1, 0))
        pooled = ((csum[..., k:] - csum[..., :-k]) / k)[..., : self.n_frames]
        return torch.relu(smeared - pooled)

    def loss(self, target: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        return kinks.abs(self.features(target) - self.features(recon)).sum()

    __call__ = loss
