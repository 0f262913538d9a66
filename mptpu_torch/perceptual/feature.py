"""The cochlea model and the periodicity feature (counterpart of
``mptpu/perceptual/feature.py``): a gammatone convolution, half-wave
rectification, square-root compression and a smoothing for the loss of
phase locking."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import default_device, no_tf32
from ..ops.fft import rfft
from ..ops.stft import _frame
from ..ops.windows import hamming_window
from .filterbank import avg_pool_1d
from .gammatone import gammatone_filter_bank


def cochlea_filter_bank(n_filters: int, kernel_size: int, samplerate: int = 22050,
                        start_hz: float = 20.0, stop_hz: float | None = None):
    """The geometric gammatone bank (float32 numpy) of the cochlea model,
    up to ``samplerate / 2 - 10`` Hz unless ``stop_hz`` is given."""
    if stop_hz is None:
        stop_hz = samplerate / 2 - 10
    return gammatone_filter_bank(n_filters, kernel_size, start_hz=start_hz, stop_hz=stop_hz,
                                 samplerate=samplerate, band_spacing="geometric")


def cochlea_model(x: torch.Tensor, filters: torch.Tensor, samplerate: int = 22050,
                  phase_locking_cutoff_hz: int = 5000) -> torch.Tensor:
    """(batch, ..., n) -> (batch, n_filters, n): the cross-correlation with
    each filter (``taps // 2`` zeros each side, cut to ``n``), rectified,
    square-rooted, then averaged over ``int(samplerate / 2 / cutoff)``
    samples when that is above 1."""
    x = x.reshape(x.shape[0], 1, -1)
    n_samples = x.shape[-1]
    kernel_size = filters.shape[-1]
    with no_tf32():
        out = F.conv1d(x, filters[:, None, :].to(x.dtype), padding=kernel_size // 2)
    out = torch.sqrt(torch.relu(out[..., :n_samples]))
    plk = int((samplerate / 2) / phase_locking_cutoff_hz)
    if plk > 1:
        out = avg_pool_1d(out, plk, 1, plk // 2)[..., :n_samples]
    return out


def periodicity_feature(x: torch.Tensor, window_size: int, step: int) -> torch.Tensor:
    """(batch, channels, n) -> complex (batch, channels, frames, coeffs):
    ``step`` zeros appended, Hamming-windowed frames, ortho rFFT, each
    frame's spectrum divided by its l2 norm + 1e-8."""
    x = F.pad(x, (0, step))
    framed = _frame(x, window_size, step)
    framed = framed * hamming_window(window_size, dtype=framed.dtype, device=framed.device)
    spec = rfft(framed, norm="ortho")
    norm = torch.sqrt(torch.sum(torch.abs(spec) ** 2, dim=-1, keepdim=True))
    return spec / (norm + 1e-8)


class CochleaModel:
    """:func:`cochlea_model` over a bank built once, on
    ``default_device(device)``."""

    def __init__(self, samplerate: int = 22050, n_filters: int = 128, kernel_size: int = 512,
                 start_hz: float = 20.0, stop_hz: float | None = None,
                 phase_locking_cutoff_hz: int = 5000, device=None):
        self.samplerate = samplerate
        self.phase_locking_cutoff_hz = phase_locking_cutoff_hz
        self.filters = torch.from_numpy(cochlea_filter_bank(
            n_filters, kernel_size, samplerate, start_hz, stop_hz)).to(default_device(device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return cochlea_model(x, self.filters, self.samplerate, self.phase_locking_cutoff_hz)
