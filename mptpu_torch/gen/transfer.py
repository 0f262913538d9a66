"""Waveform tables, the damped harmonic oscillator, Gaussian band-pass
filtering and the N-argument FFT convolution with its correlation mode
(counterpart of ``make_waves``, ``make_waves_vectorized``,
``damped_harmonic_oscillator``, ``gaussian_bandpass_filtered`` and
``fft_convolve_correlation`` in ``mptpu/gen/transfer.py``; the resonance
banks of that module are not ported yet)."""

from __future__ import annotations

from functools import reduce
from typing import List

import numpy as np
import torch
from scipy.signal import sawtooth, square

from ..device import default_device
from ..ops.fft import real_ends
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


def make_waves_vectorized(n_samples: int, f0s, samplerate: int, device=None) -> torch.Tensor:
    """The table of :func:`make_waves` from one grid of phases for all f0s
    (``mptpu``'s vectorised form; equal to the loop form within its own
    tolerance, not bit for bit)."""
    f0s = np.asarray(f0s, dtype=np.float64) / (samplerate // 2)
    radians = (f0s * np.pi)[:, None] * np.linspace(0, n_samples, n_samples)[None, :]
    waves = np.concatenate([sawtooth(radians), square(radians), sawtooth(radians, 0.5),
                            np.sin(radians)], axis=0)
    return torch.from_numpy(waves.astype(np.float32)).to(default_device(device))


def fft_convolve_correlation(*args: torch.Tensor, correlation: bool = False) -> torch.Tensor:
    """N-argument FFT convolution: each input zero-padded to twice its
    length, the spectra multiplied, the product cut to the first input's
    length; ``correlation`` conjugates the second spectrum, a
    cross-correlation with it. Leading axes broadcast."""
    n_samples = args[0].shape[-1]
    specs = [torch.fft.rfft(x, n=2 * x.shape[-1], dim=-1) for x in args]
    if correlation:
        specs[1] = torch.conj(specs[1])
    spec = reduce(lambda a, c: a * c, specs[1:], specs[0])
    return torch.fft.irfft(real_ends(spec), n=2 * n_samples, dim=-1)[..., :n_samples]


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
