"""Small audio features: the amplitude envelope, MFCCs and chroma
(counterpart of ``mptpu/ops/features.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import kinks


def amplitude_envelope(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(batch, channels, time) -> (batch, channels, time // step + 1): the
    mean of ``|audio|`` over windows of ``2 * step`` samples every ``step``
    (``step = time // n_frames``), with ``step`` zeros at each end counted
    in every mean (``lax.reduce_window``'s padded sum over the window)."""
    step = audio.shape[-1] // n_frames
    return F.avg_pool1d(kinks.abs(audio), 2 * step, step, padding=step, count_include_pad=True)


def mfcc(x: torch.Tensor, n_coeffs: int = 12) -> torch.Tensor:
    """Cepstral coefficients 1 to ``n_coeffs`` of a (batch, freq_bins,
    time) spectrogram: the log magnitude of its ortho rFFT over the bins."""
    cepstrum = torch.fft.rfft(x, dim=1) * (1.0 / math.sqrt(x.shape[1]))
    return torch.log(torch.abs(cepstrum) + 1e-12)[:, 1: n_coeffs + 1, :]


def chroma(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(batch, bins, time) spectrogram onto a (12, bins) chroma basis ->
    (batch, 12, time)."""
    return (x.transpose(1, 2) @ basis.T).transpose(1, 2)


def chroma_basis(n_bins: int, samplerate: int = 22050, start_hz: float = 20.0) -> np.ndarray:
    """(12, n_bins) float32: each geometrically spaced bin from ``start_hz``
    to 10 Hz below Nyquist assigned to its nearest pitch class, each row
    normalised to sum 1."""
    freqs = np.geomspace(start_hz, samplerate / 2 - 10, n_bins)
    midi = 69 + 12 * np.log2(freqs / 440.0)
    classes = np.round(midi).astype(int) % 12
    basis = np.zeros((12, n_bins), dtype=np.float32)
    basis[classes, np.arange(n_bins)] = 1.0
    basis /= basis.sum(axis=-1, keepdims=True) + 1e-8
    return basis
