"""Auditory image model: a rectified gammatone filter bank, then windowed
rFFT periodicities (counterpart of ``mptpu/perceptual/aim.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fft import fft_convolve, rfft
from ..ops.norms import unit_norm
from ..ops.stft import _frame
from ..ops.windows import hamming_window


def rectified_filter_bank(signal: torch.Tensor, filters: torch.Tensor,
                          do_log_compression: bool = False) -> torch.Tensor:
    """(batch, 1, n) x (n_filters, taps) -> (batch, n_filters, n): FFT
    convolution with each filter, half-wave rectified; ``do_log_compression``
    takes ``log(x + 1e-8)``."""
    n_samples = signal.shape[-1]
    padded = F.pad(filters.to(signal.dtype), (0, n_samples - filters.shape[-1]))[None]
    spec = torch.relu(fft_convolve(signal, padded))
    if do_log_compression:
        spec = torch.log(spec + 1e-8)
    return spec


def auditory_image_model(signal: torch.Tensor, filters: torch.Tensor, aim_window_size: int,
                         aim_step_size: int) -> torch.Tensor:
    """(batch, 1, time) -> (batch, n_filters, frames, periodicities): the
    magnitudes of the rFFT of each rectified channel's frames."""
    spec = rectified_filter_bank(signal, filters)
    return torch.abs(torch.fft.rfft(_frame(spec, aim_window_size, aim_step_size), dim=-1))


def auditory_image(x: torch.Tensor, window_size: int, time_steps: int, do_windowing: bool = True,
                   check_cola: bool = True, causal: bool = False,
                   norm_periodicities: bool = False) -> torch.Tensor:
    """A filter bank's output (batch, channels, time) -> (batch, channels,
    frames, periodicities): half a window of zeros after (``causal``:
    before) the signal, frames of ``window_size`` every ``time // time_steps``
    samples, optionally Hamming-windowed, ortho rFFT magnitudes, optionally
    unit-normed over the periodicities. ``check_cola`` raises unless the
    hop is half the window."""
    time = x.shape[-1]
    padding = window_size // 2
    x = F.pad(x, (padding, 0) if causal else (0, padding))
    step = time // time_steps
    if check_cola and step != window_size // 2:
        raise ValueError(f"window and step ({window_size}, {step}) violate COLA")
    framed = _frame(x, window_size, step)
    if do_windowing:
        framed = framed * hamming_window(window_size, dtype=framed.dtype, device=framed.device)
    out = torch.abs(rfft(framed, norm="ortho"))
    if norm_periodicities:
        out = unit_norm(out, axis=-1)
    return out
