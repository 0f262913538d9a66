"""DDSP primitives: filtered-noise banks, an additive oscillator bank and a
multi-voice harmonic model (counterpart of ``mptpu/gen/ddsp.py``).

``mptpu`` draws its noise from a key; here each draw is an argument, or
comes from a ``torch.Generator`` (on its own device, then moved).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import default_device
from ..nn.init import uniform
from ..ops.fft import irfft, real_ends, rfft
from ..ops.kinks import clip
from ..ops.overlap_add import overlap_add
from ..ops.pdf import pdf
from ..ops.stft import _frame
from ..ops.upsample import interpolate_last_axis
from ..ops.windows import hamming_window, hann_window


def _uniform_noise(shape, device, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Uniform in [-1, 1) from ``generator`` (the default one of
    ``device`` without), on ``device``."""
    return uniform(shape, -1.0, 1.0, generator, device).to(device)


def noise_spec(n_audio_samples: int, ws: int = 512, step: int = 256,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """The ortho rFFT of Hamming-windowed frames of white noise, (frames,
    coeffs); ``noise`` is the (n_audio_samples,) uniform draw in [-1, 1)."""
    if noise is None:
        noise = _uniform_noise((n_audio_samples,), default_device(device), generator)
    framed = _frame(F.pad(noise, (0, step)), ws, step)
    framed = framed * hamming_window(ws, dtype=framed.dtype, device=framed.device)
    return rfft(framed, norm="ortho")


def band_filtered_noise(n_audio_samples: int, ws: int = 512, step: int = 256, mean=0.5, std=0.1,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """White noise through Gaussian band-passes: ``mean`` and ``std``
    (batch, atoms, frames) in [0, 1] of Nyquist -> (batch, atoms,
    n_audio_samples)."""
    batch, atoms, _ = mean.shape
    frames = n_audio_samples // step
    spec = noise_spec(n_audio_samples, ws, step, noise, generator, mean.device)
    n_coeffs = spec.shape[-1]
    grid = torch.arange(n_coeffs, device=mean.device, dtype=mean.dtype).reshape(1, 1, n_coeffs, 1)
    filt = pdf(grid, (mean * n_coeffs)[:, :, None, :], (std * n_coeffs)[:, :, None, :])
    filt = filt / torch.amax(filt)
    spec = (spec.T[None, None] * filt).reshape(batch, atoms, n_coeffs, frames)
    windowed = irfft(real_ends(spec.permute(0, 1, 3, 2)), norm="ortho")
    return overlap_add(windowed)[..., :n_audio_samples]


def noise_bank2(x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The DDSP filtered-noise synthesiser: x (batch, n_coeffs, frames)
    filter magnitudes -> (batch, 1, frames * (n_coeffs - 1)): Hann-windowed
    frames of white noise, their ortho rFFTs times the filters, back to
    time and overlap-added. ``noise`` is the (batch, frames * (n_coeffs -
    1)) uniform draw in [-1, 1)."""
    batch, magnitudes, samples = x.shape
    window_size = (magnitudes - 1) * 2
    hop_size = window_size // 2
    total_samples = hop_size * samples
    if noise is None:
        noise = _uniform_noise((batch, total_samples), x.device, generator)
    framed = _frame(F.pad(noise.to(x.dtype), (0, hop_size)), window_size, hop_size)
    framed = framed * hann_window(window_size, dtype=framed.dtype, device=framed.device)
    filtered = rfft(framed, norm="ortho") * x.permute(0, 2, 1)
    audio = irfft(real_ends(filtered), n=window_size, norm="ortho")
    audio = overlap_add(audio[:, None], apply_window=True)
    return audio[..., :total_samples].reshape(batch, 1, -1)


def oscillator_bank(f0: torch.Tensor, amplitudes: torch.Tensor, n_samples: int, samplerate: int,
                    n_harmonics: int = 8) -> torch.Tensor:
    """Additive harmonic oscillators: frame-rate f0 (batch, frames) in [0,
    1] of Nyquist and amplitudes (batch, n_harmonics, frames) -> (batch, 1,
    n_samples), harmonics above Nyquist silent, phases by cumulative sum."""
    f0 = interpolate_last_axis(f0, n_samples)
    amps = interpolate_last_axis(amplitudes, n_samples)
    nyquist = samplerate / 2
    ks = torch.arange(1, n_harmonics + 1, device=f0.device, dtype=f0.dtype)
    freqs = f0[:, None, :] * ks[None, :, None]
    mask = (freqs * nyquist < nyquist).to(f0.dtype)
    sig = torch.sin(torch.cumsum(freqs * math.pi, dim=-1)) * amps * mask
    return torch.sum(sig, dim=1, keepdim=True)


def harmonic_model(f0: torch.Tensor, harmonics: torch.Tensor, profiles: torch.Tensor,
                   n_voices: int, n_harmonics: int, n_frames: int, n_samples: int,
                   samplerate: int = 22050, freq_hz_range=(40, 4000)) -> torch.Tensor:
    """Multi-voice harmonic synthesis: each voice's f0 from the angle of a
    pair of trajectories (its amplitude their squared norm), its harmonics
    at ``(k + 2) ** 2`` times f0 (clipped to Nyquist) with amplitudes from
    a softmax mixture over ``profiles`` (n_profiles, n_harmonics) ->
    (batch, 1, n_samples)."""
    batch = f0.shape[0]
    nyquist = samplerate / 2
    min_freq = freq_hz_range[0] / nyquist
    interval = freq_hz_range[1] / nyquist - min_freq
    f0 = f0.reshape(batch, n_voices, 2, -1)
    n_profiles = profiles.shape[0]
    harmonics = harmonics.reshape(batch, n_voices, n_profiles, -1)
    f0_amp = torch.linalg.vector_norm(f0, dim=-2) ** 2
    f0_val = torch.atan2(f0[:, :, 1, :], f0[:, :, 0, :]) / math.pi
    f0_val = min_freq + (f0_val**2) * interval
    ratios = torch.arange(2, 2 + n_harmonics, device=f0.device) ** 2
    harmonic_freqs = clip(f0_val[:, :, None, :] * ratios[None, None, :, None].to(f0.dtype), 0, 1)
    h = torch.softmax(harmonics.permute(0, 1, 3, 2), dim=-1) @ profiles
    harmonic_amp = f0_amp[:, :, None, :] * clip(h.permute(0, 1, 3, 2), 0, 1)
    full_freq = torch.cat([f0_val[:, :, None, :], harmonic_freqs], dim=2)
    full_amp = torch.cat([f0_amp[:, :, None, :], harmonic_amp], dim=2)
    full_freq = interpolate_last_axis(
        full_freq.reshape(batch * n_voices, n_harmonics + 1, n_frames), n_samples)
    full_amp = interpolate_last_axis(
        full_amp.reshape(batch * n_voices, n_harmonics + 1, n_frames), n_samples)
    signal = full_amp * torch.sin(torch.cumsum(full_freq, dim=-1) * math.pi)
    signal = signal.reshape(batch, n_voices, n_harmonics + 1, n_samples)
    return torch.sum(signal, dim=(1, 2)).reshape(batch, 1, n_samples)


class HarmonicModel:
    """:func:`harmonic_model` with its sizes; the learned (n_profiles,
    n_harmonics) profile table is the caller's, ``init_profiles`` a start
    for it."""

    def __init__(self, n_voices: int = 8, n_profiles: int = 16, n_harmonics: int = 64,
                 freq_hz_range=(40, 4000), samplerate: int = 22050, n_frames: int = 64,
                 n_samples: int = 2**14):
        self.n_voices = n_voices
        self.n_profiles = n_profiles
        self.n_harmonics = n_harmonics
        self.freq_hz_range = freq_hz_range
        self.samplerate = samplerate
        self.n_frames = n_frames
        self.n_samples = n_samples

    def init_profiles(self, generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
        """Uniform in [0, 0.1) on ``default_device(device)``."""
        dev = default_device(device)
        return uniform((self.n_profiles, self.n_harmonics), 0.0, 0.1, generator, dev).to(dev)

    def __call__(self, profiles, f0, harmonics) -> torch.Tensor:
        return harmonic_model(f0, harmonics, profiles, self.n_voices, self.n_harmonics,
                              self.n_frames, self.n_samples, self.samplerate, self.freq_hz_range)
