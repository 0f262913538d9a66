"""The multiband psychoacoustic feature (counterpart of
``mptpu/perceptual/psychoacoustic.py``): octave bands, a mel-spaced real
morlet bank for each band at the band's own rate, rectified, then windowed
rFFT magnitudes per channel, and a mean-squared loss over the bands."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import default_device
from ..ops import kinks
from ..ops.decompose import fft_frequency_decompose
from ..ops.stft import _frame
from .filterbank import filter_bank_convolve, mel_scale_hz, morlet_filter_bank

_SPANS = [(20, 344), (344, 689), (689, 1378), (1378, 2756), (2756, 5512), (5512, 11025)]
_KEYS = [512, 1024, 2048, 4096, 8192, 16384]


class PsychoacousticFeature:
    """One bank per octave band of 512 to 16,384 samples, so it takes
    signals of at least 16,384 samples."""

    def __init__(self, kernel_sizes=(32, 64, 128, 256, 512, 1024), n_bands: int = 64,
                 device=None):
        dev = default_device(device)
        self.banks: Dict[int, torch.Tensor] = {}
        self.kernel_sizes: Dict[int, int] = {}
        for span, size, key in zip(_SPANS, kernel_sizes, _KEYS):
            self.kernel_sizes[key] = size // 2 + 1
            bank = morlet_filter_bank(span[1] * 2, size, mel_scale_hz(span[0], span[1], n_bands),
                                      np.geomspace(0.25, 0.9, num=n_bands)).real
            self.banks[key] = torch.from_numpy(bank.astype(np.float32)).to(dev)

    @property
    def band_sizes(self):
        return sorted(self.banks.keys())

    def decompose(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        return fft_frequency_decompose(x, 512)

    def _to_dict(self, x):
        if isinstance(x, dict):
            return x
        return self.decompose(x.reshape(x.shape[0], 1, -1))

    def compute_feature_dict(self, x, constant_window_size=None,
                             time_steps: int = 32) -> Dict[int, torch.Tensor]:
        """Each band's rectified bank output, padded and framed (window the
        kernel size and hop half of it, or ``constant_window_size`` and
        ``time_steps`` frames), its frames' rFFT magnitudes, the first
        ``time_steps`` frames."""
        x = self._to_dict(x)
        bands = {}
        for size, bank in self.banks.items():
            band = x[size]
            kernel_size = bank.shape[-1]
            spec = kinks.abs(filter_bank_convolve(band.reshape(band.shape[0], -1), bank))
            if constant_window_size is None:
                padding, window_size, step = kernel_size // 4, kernel_size, kernel_size // 2
            else:
                window_size = constant_window_size
                padding = window_size // 2
                step = spec.shape[-1] // time_steps
            spec = F.pad(spec, (padding, padding))
            feat = torch.abs(torch.fft.rfft(_frame(spec, window_size, step), dim=-1))
            bands[size] = feat[:, :, :time_steps, :]
        return bands

    def loss(self, a, b) -> torch.Tensor:
        fa = self.compute_feature_dict(a)
        fb = self.compute_feature_dict(b)
        total = 0.0
        for key in fa:
            total = total + torch.mean((fa[key] - fb[key]) ** 2)
        return total

    def __call__(self, x):
        feats = self.compute_feature_dict(x)
        batch = next(iter(feats.values())).shape[0]
        return torch.cat([v.reshape(batch, -1) for v in feats.values()], dim=-1)
