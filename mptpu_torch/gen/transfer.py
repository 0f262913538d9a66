"""Waveform tables, the damped harmonic oscillator and Gaussian band-pass
filtering (counterpart of ``make_waves``, ``damped_harmonic_oscillator``
and ``gaussian_bandpass_filtered`` in ``mptpu/gen/transfer.py``; the rest
of that module is not ported yet)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from scipy.signal import sawtooth, square

from ..device import default_device
from ..ops.kinks import clip
from ..ops.pdf import pdf2


def make_waves(n_samples: int, f0s: List[float], samplerate: int, device=None) -> torch.Tensor:
    """(4 * len(f0s), n_samples) float32 table on ``default_device(device)``:
    every f0's sawtooth, then every square, triangle and sine, computed in
    float64 numpy with scipy's ``square`` and ``sawtooth`` as ``mptpu``
    does."""
    sawtooths, squares, triangles, sines = [], [], [], []
    for f0 in f0s:
        rps = f0 / (samplerate // 2) * np.pi
        radians = np.linspace(0, rps * n_samples, n_samples)
        squares.append(square(radians)[None, :])
        sawtooths.append(sawtooth(radians)[None, :])
        triangles.append(sawtooth(radians, 0.5)[None, :])
        sines.append(np.sin(radians)[None, :])
    waves = np.concatenate(sawtooths + squares + triangles + sines, axis=0)
    return torch.from_numpy(waves.astype(np.float32)).to(default_device(device))


def gaussian_bandpass_filtered(means: torch.Tensor, stds: torch.Tensor, signals: torch.Tensor,
                               normalize: bool = True) -> torch.Tensor:
    """Filter ``signals`` (..., samples) by Gaussian magnitude responses:
    ``pdf2(means, stds)`` over the rFFT's coefficients, unnormalised
    transforms; the responses (..., coeffs) broadcast against the spectra."""
    samples = signals.shape[-1]
    gaussians = pdf2(means, stds, samples // 2 + 1, normalize=normalize)
    spec = torch.fft.rfft(signals, dim=-1)
    return torch.fft.irfft(spec * gaussians, n=samples, dim=-1)


def damped_harmonic_oscillator(
    time: torch.Tensor,
    mass: torch.Tensor,
    damping: torch.Tensor,
    tension: torch.Tensor,
    initial_displacement: torch.Tensor,
    initial_velocity: float,
    do_clamp: bool = True,
) -> torch.Tensor:
    """Closed-form damped oscillator ``a * exp(-x t) * cos(omega t - phi)``
    with ``x = damping / (2 mass)``; the arguments broadcast. ``do_clamp``
    keeps ``tension - x^2`` at least 1e-12, else its magnitude is taken."""
    x = damping / (2 * mass)
    if do_clamp:
        omega = torch.sqrt(clip(tension - x**2, 1e-12))
    else:
        omega = torch.sqrt(torch.abs(tension - x**2))
    phi = torch.atan2(initial_velocity + x * initial_displacement, initial_displacement * omega)
    a = initial_displacement / torch.cos(phi)
    return a * torch.exp(-x * time) * torch.cos(omega * time - phi)
