"""The invertible STFT and its magnitude / instantaneous-frequency codec
(counterpart of ``mptpu/ops/phase.py``): Hann-windowed frames, an ortho
rFFT, overlap-add synthesis, and the decomposition that makes spectrogram
frames independent of their phase.

``jnp``'s ``%`` on floats is ``torch.remainder`` (the sign of the
divisor), not ``torch.fmod``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import default_device
from .fft import cexp, real_ends
from .overlap_add import overlap_add
from .stft import _frame
from .windows import hann_window


def windowed_audio(audio_batch: torch.Tensor, window_size: int, step_size: int) -> torch.Tensor:
    """(batch, ..., time) -> (batch, ..., frames, window): ``step_size``
    zeros appended, frames every ``step_size`` samples, a periodic Hann
    window."""
    framed = _frame(F.pad(audio_batch, (0, step_size)), window_size, step_size)
    return framed * hann_window(window_size, dtype=framed.dtype, device=framed.device)


def stft_complex(audio_batch: torch.Tensor, window_size: int, step_size: int) -> torch.Tensor:
    """The complex ortho STFT, (batch, frames, window_size // 2 + 1)."""
    spec = torch.fft.rfft(windowed_audio(audio_batch, window_size, step_size), dim=-1,
                          norm="ortho")
    return spec.reshape(audio_batch.shape[0], -1, window_size // 2 + 1)


def istft(spec: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`stft_complex` by overlap-add, (batch, 1,
    samples)."""
    n = 2 * (spec.shape[-1] - 1)
    windowed = torch.fft.irfft(real_ends(spec), n=n, dim=-1, norm="ortho")
    return overlap_add(windowed[:, None, :, :], apply_window=False)


def rfft_freqs(window_size: int, device=None) -> torch.Tensor:
    """``jnp.fft.rfftfreq(window_size)`` in float32 with the first entry
    1e-12, on ``default_device(device)``."""
    freqs = torch.arange(window_size // 2 + 1, dtype=torch.float32,
                         device=default_device(device)) / float(window_size)
    freqs[0] = 1e-12
    return freqs


def mag_phase_decomposition(spec: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Complex frames (batch, frames, coeffs) -> (batch, frames, coeffs, 2):
    the magnitude, and the phase's advance from the frame before, modulo
    2 pi, less each bin's carrier."""
    mag = torch.abs(spec)
    phase = torch.angle(spec)
    phase = torch.diff(phase, dim=1, prepend=torch.zeros_like(phase[:, :1]))
    phase = torch.remainder(phase, 2 * math.pi)
    phase = phase - freqs[None, None, :] * 2 * math.pi
    return torch.stack([mag, phase], dim=-1)


def mag_phase_recomposition(spec: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`mag_phase_decomposition`: complex frames."""
    phase = spec[..., 1] + freqs[None, None, :] * 2 * math.pi
    imag = torch.cumsum(phase, dim=1)
    imag = torch.remainder(imag + math.pi, 2 * math.pi) - math.pi
    return spec[..., 0] * cexp(imag)


class AudioCodec:
    """Audio (batch, time) <-> phase-independent frames (batch, frames,
    coeffs, 2); the bins' frequencies live on ``default_device(device)``."""

    def __init__(self, window_size: int = 1024, step_size: int = 256, device=None):
        self.window_size = window_size
        self.step_size = step_size
        self.freqs = rfft_freqs(window_size, device)

    def to_frequency_domain(self, audio_batch: torch.Tensor) -> torch.Tensor:
        spec = stft_complex(audio_batch, self.window_size, self.step_size)
        return mag_phase_decomposition(spec, self.freqs.to(audio_batch.device))

    def to_time_domain(self, spec: torch.Tensor) -> torch.Tensor:
        return istft(mag_phase_recomposition(spec, self.freqs.to(spec.device)))
