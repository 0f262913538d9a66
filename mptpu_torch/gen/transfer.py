"""Resonance machinery (counterpart of ``mptpu/gen/transfer.py``):
waveform tables, the damped harmonic oscillator, Gaussian band-pass
filtering, the N-argument FFT convolution with its correlation mode,
frequency-domain transfer functions to resonances, and the resonance bank,
time-varying mix, block and chain.

The modules' children carry flax's names. A ``ResonanceBlock`` builds ONE
``ResonanceBank_0`` and calls it once per mix channel, as ``mptpu``'s does
(its ``Dense`` layers, by contrast, are new on each pass: ``Dense_1`` to
``Dense_{3 * mix_channels}``).
"""

from __future__ import annotations

from functools import reduce
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import sawtooth, square
from torch import nn

from ..device import default_device, no_tf32
from ..nn.init import uniform_init, uniform_linear
from ..nn.upsample import ConvUpsample
from ..ops.fft import cexp, fft_convolve, real_ends
from ..ops.kinks import clip
from ..ops.norms import max_norm
from ..ops.overlap_add import overlap_add
from ..ops.pdf import pdf2
from ..ops.upsample import interpolate_last_axis
from ..ops.windows import hamming_window, linspace


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


def freq_domain_transfer_function_to_resonance(
    window_size: int,
    coeffs: torch.Tensor,
    n_frames: int,
    start_phase: Optional[torch.Tensor] = None,
    start_mags: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-bin decay coefficients (..., window_size // 2 + 1) -> (-1, 1,
    n_frames * window_size // 2) max-normed resonances: each bin's
    magnitude the running product of its coefficient from ``start_mags``
    (1 without), taken as a running sum of logs, its phase advancing by a
    group delay of 0 to pi over the bins each frame (from ``start_phase``),
    frames by inverse rFFT, overlap-added without a window. ``mptpu``'s
    ``apply_decay``, ``log_space_scan``, ``apply_window`` and
    ``do_overlap_add`` flags are fixed at their defaults, which every caller
    passes."""
    step_size = window_size // 2
    total_samples = step_size * n_frames
    expected_coeffs = window_size // 2 + 1
    group_delay = linspace(0.0, np.pi, expected_coeffs, device=coeffs.device, dtype=coeffs.dtype)
    res = coeffs.reshape(-1, expected_coeffs, 1).expand(-1, expected_coeffs, n_frames)
    if start_mags is not None:
        start = start_mags.reshape(res.shape[0], expected_coeffs, 1)
    else:
        start = torch.ones((res.shape[0], expected_coeffs, 1), dtype=res.dtype, device=res.device)
    res = torch.cat([start, res], dim=-1)
    res = torch.exp(torch.cumsum(torch.log(res + 1e-12), dim=-1))
    spec_mag = res[..., :n_frames].permute(0, 2, 1)[:, None]   # (batch, 1, frames, coeffs)
    phase = torch.cumsum(group_delay.expand(spec_mag.shape), dim=2)
    if start_phase is not None:
        phase = phase + start_phase.reshape(-1, 1, 1, expected_coeffs)
    windowed = torch.fft.irfft(real_ends(spec_mag * cexp(phase)), n=window_size, dim=-1)
    audio = overlap_add(windowed, apply_window=False)[..., :total_samples]
    return max_norm(audio.reshape(-1, 1, total_samples))


class ResonanceBank(nn.Module):
    """Resonances chosen from a waveform table (``res_samples``, learned
    from ``initial`` when ``learnable_resonances``; with
    ``fft_based_resonance`` built from learned transfer functions
    ``fft_res`` instead), shaped by a learned per-frame exponential decay
    (``Dense_0``) and convolved with a learned filter (``filters``,
    Hamming-windowed)."""

    def __init__(self, n_resonances: int, window_size: int, n_frames: int,
                 initial: torch.Tensor, fft_based_resonance: bool = False,
                 learnable_resonances: bool = True, base_resonance: float = 0.02,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        self.window_size, self.n_frames = window_size, n_frames
        self.n_samples = initial.shape[-1]
        self.fft_based_resonance = fft_based_resonance
        self.base_resonance = base_resonance
        if learnable_resonances:
            self.res_samples = nn.Parameter(initial.detach().clone().to(dev))
        else:
            self.register_buffer("res_samples", initial.detach().clone().to(dev))
        self.filters = nn.Parameter(uniform_init((n_resonances, n_frames), 1.0, gen).to(dev))
        self.Dense_0 = uniform_linear(n_resonances, n_frames, True, 0.1, gen, dev)
        if fft_based_resonance:
            self.fft_res = nn.Parameter(torch.full((n_resonances, window_size // 2 + 1), -6.0,
                                                   device=dev))

    def forward(self, selection, initial_selection, filter_selection):
        """Selections (batch, k, n_resonances) -> (batch, k, n_samples)."""
        n_samples = self.n_samples
        res_factor = (1 - self.base_resonance) * 0.99
        with no_tf32():
            filt = (filter_selection @ self.filters).reshape(-1, 1, self.n_frames)
            decay = torch.sigmoid(self.Dense_0(initial_selection))
            if self.fft_based_resonance:
                coeffs = torch.sigmoid(selection @ self.fft_res)
            else:
                res = selection @ self.res_samples
        filt = filt * hamming_window(self.n_frames, dtype=filt.dtype, device=filt.device)
        decay = self.base_resonance + decay * res_factor
        decay = torch.exp(torch.cumsum(torch.log(1e-12 + decay), dim=-1))
        amp = interpolate_last_axis(decay.reshape(selection.shape[0], -1, self.n_frames),
                                    n_samples)
        if self.fft_based_resonance:
            res = freq_domain_transfer_function_to_resonance(self.window_size, coeffs, 128)
        res = res * amp.reshape(res.shape)
        filt = F.pad(filt, (0, n_samples - self.n_frames)).reshape(res.shape)
        return fft_convolve(filt, res)[..., :n_samples]


class TimeVaryingMix(nn.Module):
    """Latent -> a nearest-mode upsampler to ``n_frames`` frames of
    ``n_mixer_channels`` logits, interpolated to the audio's length,
    softmaxed over the channels, and the channels mixed down by them."""

    def __init__(self, latent_dim: int, channels: int, n_mixer_channels: int, n_frames: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_mixer_channels, self.n_frames = n_mixer_channels, n_frames
        self.ConvUpsample_0 = ConvUpsample(latent_dim, channels, start_size=4, end_size=n_frames,
                                           mode="nearest", out_channels=n_mixer_channels,
                                           from_latent=True, generator=gen, device=device)

    def forward(self, x: torch.Tensor, audio_channels: torch.Tensor) -> torch.Tensor:
        total_samples = audio_channels.shape[-1]
        mix = self.ConvUpsample_0(x).reshape(-1, self.n_mixer_channels, self.n_frames)
        mix = torch.softmax(interpolate_last_axis(mix, total_samples), dim=1)
        out = torch.sum(audio_channels * mix, dim=1)
        return out.reshape(x.shape[0], -1, total_samples)


class ResonanceBlock(nn.Module):
    """``mix_channels`` selections from one shared :class:`ResonanceBank`
    (``ResonanceBank_0``), each convolved with the impulse, mixed down by a
    :class:`TimeVaryingMix`, then blended with the dry impulse by a softmax
    pair (``Dense_0``); each channel's three selections are ReLU'd Dense
    layers ``Dense_{3i+1}`` to ``Dense_{3i+3}``."""

    def __init__(self, n_atoms: int, window_size: int, n_frames: int, total_samples: int,
                 mix_channels: int, channels: int, latent_dim: int, initial: torch.Tensor,
                 learnable_resonances: bool = True, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.total_samples, self.mix_channels = total_samples, mix_channels
        self.Dense_0 = uniform_linear(latent_dim, 2, True, 0.1, gen, device)
        self.ResonanceBank_0 = ResonanceBank(n_atoms, window_size, n_frames, initial,
                                             fft_based_resonance=False,
                                             learnable_resonances=learnable_resonances,
                                             generator=gen, device=device)
        for i in range(1, 3 * mix_channels + 1):
            self.add_module(f"Dense_{i}", uniform_linear(latent_dim, n_atoms, True, 0.1, gen,
                                                         device))
        self.TimeVaryingMix_0 = TimeVaryingMix(latent_dim, channels, mix_channels, n_frames,
                                               generator=gen, device=device)

    def forward(self, x: torch.Tensor, impulse: torch.Tensor) -> torch.Tensor:
        batch_size = x.shape[0]
        with no_tf32():
            final_mix = torch.softmax(self.Dense_0(x), dim=-1).reshape(batch_size, -1, 1, 2)
            sels = [torch.relu(getattr(self, f"Dense_{i}")(x))[:, None]
                    for i in range(1, 3 * self.mix_channels + 1)]
        resonances = [self.ResonanceBank_0(*sels[3 * i:3 * i + 3])
                      for i in range(self.mix_channels)]
        impulse = F.pad(impulse, (0, self.total_samples - impulse.shape[-1])).reshape(
            -1, 1, self.total_samples)
        resonances = torch.cat(resonances, dim=1).reshape(-1, self.mix_channels,
                                                           self.total_samples)
        mixed_down = self.TimeVaryingMix_0(x, fft_convolve(resonances, impulse))
        imp_and_res = torch.stack([impulse.reshape(mixed_down.shape), mixed_down], dim=-1)
        return torch.sum(imp_and_res * final_mix, dim=-1)


class ResonanceChain(nn.Module):
    """``depth`` :class:`ResonanceBlock` s, each excited by the one before
    (the first by the impulse), their outputs mixed by a learned depth mix
    (``Dense_0``)."""

    def __init__(self, depth: int, n_atoms: int, window_size: int, n_frames: int,
                 total_samples: int, mix_channels: int, channels: int, latent_dim: int,
                 initial: torch.Tensor, learnable_resonances: bool = True,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"ResonanceBlock_{i}", ResonanceBlock(
                n_atoms, window_size, n_frames, total_samples, mix_channels, channels,
                latent_dim, initial, learnable_resonances, gen, device))
        self.Dense_0 = uniform_linear(latent_dim, depth, True, 0.1, gen, device)

    def forward(self, latent: torch.Tensor, impulse: torch.Tensor) -> torch.Tensor:
        imp, outputs = impulse, []
        for i in range(self.depth):
            imp = getattr(self, f"ResonanceBlock_{i}")(latent, imp)
            outputs.append(imp[..., None])
        with no_tf32():
            mx = self.Dense_0(latent).reshape(latent.shape[0], -1, 1, self.depth)
        return torch.sum(torch.cat(outputs, dim=-1) * mx, dim=-1)
