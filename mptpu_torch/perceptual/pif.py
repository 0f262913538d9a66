"""FFT-based phase-invariant feature (counterpart of
``mptpu/perceptual/pif.py``): the spectrum windowed into channels, back to
time, rectified and square-root compressed, then windowed rFFT magnitudes
per channel."""

from __future__ import annotations

import torch

from ..ops.stft import _frame
from ..ops.windows import hamming_window


def fft_based_pif(audio: torch.Tensor, freq_window_size: int,
                  time_window_size: int) -> torch.Tensor:
    """(batch, 1, n) audio -> (batch, channels, frames, coefficients)."""
    batch = audio.shape[0]
    spec = torch.fft.rfft(audio, dim=-1)
    windowed = _frame(spec, freq_window_size, freq_window_size // 2)
    windowed = windowed * hamming_window(freq_window_size, device=audio.device).to(audio.dtype)
    channels = torch.fft.irfft(windowed, dim=-1)
    n_channels = channels.shape[2]
    channels = torch.sqrt(torch.relu(channels))
    channels = channels.reshape(batch, n_channels, -1)
    channels = _frame(channels, time_window_size, time_window_size // 2)
    channels = channels * hamming_window(channels.shape[-1], device=audio.device).to(audio.dtype)
    return torch.abs(torch.fft.rfft(channels, dim=-1))
