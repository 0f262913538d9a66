"""Morlet filter banks, the bank convolution and the average pooling that
the scattering transform and the psychoacoustic feature use (counterpart of
``mptpu/perceptual/filterbank.py``).

The banks are float64 numpy, built as ``mptpu`` builds them. The
convolution is a cross-correlation, as ``lax.conv_general_dilated`` is, and
runs without TF32. Pooling takes a contiguous input: on a transposed view
CUDA's pooling backward has given wrong gradients.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import no_tf32


def morlet(M: int, w: float = 5.0, s: float = 1.0) -> np.ndarray:
    """``pi**-0.25 * exp(1j w x) * exp(-x**2 / 2)`` on ``M`` points of
    ``[-2 pi s, 2 pi s]`` (scipy's removed ``signal.morlet``)."""
    x = np.linspace(-s * 2 * np.pi, s * 2 * np.pi, M)
    return np.pi ** (-0.25) * np.exp(1j * w * x) * np.exp(-(x**2) / 2)


def mel_scale_hz(start_hz: float, stop_hz: float, n_bands: int) -> np.ndarray:
    """``n_bands`` centre frequencies evenly spaced on the mel scale."""

    def to_mel(f):
        return 2595.0 * np.log10(1 + f / 700.0)

    def from_mel(m):
        return 700.0 * (10 ** (m / 2595.0) - 1)

    return from_mel(np.linspace(to_mel(start_hz), to_mel(stop_hz), n_bands))


def morlet_filter_bank(samplerate: int, kernel_size: int, center_frequencies_hz: Sequence[float],
                       scaling_factor, normalize: bool = True) -> np.ndarray:
    """(n_bands, kernel_size) complex128 morlet filters, one per centre
    frequency, each scaled by its ``scaling_factor`` (one for all, or one
    each); ``normalize`` divides each by its l2 norm + 1e-8."""
    freqs = np.asarray(center_frequencies_hz, dtype=np.float64)
    if np.isscalar(scaling_factor) or np.ndim(scaling_factor) == 0:
        scaling_factor = np.repeat(float(scaling_factor), len(freqs))
    basis = np.zeros((len(freqs), kernel_size), dtype=np.complex128)
    for i, (freq, scaling) in enumerate(zip(freqs, scaling_factor)):
        w = freq / (scaling * 2 * samplerate / kernel_size)
        basis[i] = morlet(M=kernel_size, w=w, s=scaling)
    if normalize:
        basis /= np.linalg.norm(basis, axis=-1, keepdims=True) + 1e-8
    return basis


def filter_bank_convolve(x: torch.Tensor, filters: torch.Tensor,
                         padding: int | None = None) -> torch.Tensor:
    """(batch, n) x (n_filters, taps) -> (batch, n_filters, n): the
    cross-correlation with each filter, ``padding`` (``taps // 2`` unless
    given) zeros on each side, cut to the input's length."""
    n_samples = x.shape[-1]
    pad = padding if padding is not None else filters.shape[-1] // 2
    with no_tf32():
        out = F.conv1d(x.reshape(x.shape[0], 1, n_samples), filters[:, None, :].to(x.dtype),
                       padding=pad)
    return out[..., :n_samples]


def avg_pool_1d(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """The mean over windows of the last axis, zero padding counted
    (``F.avg_pool1d`` with ``count_include_pad=True``), any leading axes."""
    lead = x.shape[:-1]
    out = F.avg_pool1d(x.contiguous().reshape(-1, 1, x.shape[-1]), kernel, stride, padding,
                       count_include_pad=True)
    return out.reshape(*lead, out.shape[-1])
