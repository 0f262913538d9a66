"""Short-time Fourier transform (counterpart of ``mptpu/ops/stft.py``):
frames by ``Tensor.unfold``, a periodic Hann window, an ortho rFFT."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fft import rfft
from .windows import hamming_window, hann_window


def _frame(x: torch.Tensor, ws: int, step: int) -> torch.Tensor:
    """Overlapping frames of the last axis: (..., n_frames, ws)."""
    return x.unfold(-1, ws, step)


def stft(
    x: torch.Tensor,
    ws: int = 512,
    step: int = 256,
    pad: bool = False,
    log_amplitude: bool = False,
    log_epsilon: float = 1e-4,
    return_complex: bool = False,
    mag_epsilon: float = 0.0,
) -> torch.Tensor:
    """(batch, channels, time) -> (batch, channels, frames, coeffs), with
    ``frames = time // step`` taken before the pad; ``pad=True`` appends
    ``ws`` zeros so that all those frames exist. ``return_complex`` gives
    (..., frames, coeffs, 2), the real and imaginary parts; ``mag_epsilon``
    smooths the magnitude, ``sqrt(re^2 + im^2 + eps^2)``, so that its
    gradient at 0 is not 0/0."""
    frames = x.shape[-1] // step
    if pad:
        x = F.pad(x, (0, ws))
    framed = _frame(x, ws, step)
    framed = framed * hann_window(ws, periodic=True, dtype=framed.dtype, device=framed.device)
    spec = rfft(framed, norm="ortho")
    if return_complex:
        return torch.stack([spec.real, spec.imag], dim=-1)[..., :frames, :, :]
    if mag_epsilon:
        mag = torch.sqrt(spec.real**2 + spec.imag**2 + mag_epsilon**2)
    else:
        mag = torch.abs(spec)
    if log_amplitude:
        mag = torch.log(mag + log_epsilon)
    return mag[..., :frames, :]


def log_stft(x: torch.Tensor, ws: int = 512, step: int = 256, a: float = 0.001) -> torch.Tensor:
    return torch.log(a + stft(x, ws, step))


def stft_relative_phase(x: torch.Tensor, ws: int = 512, step: int = 256, pad: bool = False):
    """(magnitude, phase differences along frequency), each (batch, frames
    over all channels, ws // 2 + 1); ``pad`` appends ``step`` zeros."""
    if pad:
        x = F.pad(x, (0, step))
    framed = _frame(x, ws, step)
    win = hann_window(ws, periodic=True, dtype=framed.dtype, device=framed.device)
    spec = rfft(framed * win, norm="ortho")
    spec = spec.reshape(spec.shape[0], -1, ws // 2 + 1)
    mag = torch.abs(spec)
    phase = torch.angle(spec)
    phase = torch.diff(phase, dim=-1, prepend=torch.zeros_like(phase[..., :1]))
    return mag, phase


def short_time_transform(x: torch.Tensor, basis: torch.Tensor, pad: bool = True) -> torch.Tensor:
    """Hamming-windowed frames (hop ``window // 2``) projected onto a
    (n_filters, window) basis, keeping the first ``window // 2 + 1``
    outputs."""
    ws = basis.shape[1]
    ss = ws // 2
    if pad:
        x = F.pad(x, (0, ss))
    framed = _frame(x, ws, ss)
    framed = framed * hamming_window(ws, dtype=framed.dtype, device=framed.device)
    return (framed @ basis.T)[..., : ws // 2 + 1]
