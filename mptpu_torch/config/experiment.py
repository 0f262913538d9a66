"""The experiment bundle: sample rate, length, a geometric gammatone bank
and the perceptual feature and loss on top of it (counterpart of
``mptpu/config/experiment.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import default_device
from ..ops import kinks
from ..ops.norms import unit_norm
from ..perceptual.aim import auditory_image, rectified_filter_bank
from ..perceptual.gammatone import gammatone_filter_bank


class Experiment:
    """``model_dim`` gammatone filters of ``kernel_size`` taps, geometric
    from 20 Hz to ``samplerate // 2 - 10``, on ``default_device(device)``;
    frames of 512 samples every 256."""

    def __init__(self, samplerate: int, n_samples: int, model_dim: int = 128,
                 weight_init: float = 0.1, kernel_size: int = 512, windowed_pif: bool = False,
                 norm_periodicities: bool = False, device=None):
        self.samplerate = samplerate
        self.n_samples = n_samples
        self.window_size = 512
        self.step_size = self.window_size // 2
        self.n_frames = n_samples // self.step_size
        self.n_bands = model_dim
        self.model_dim = model_dim
        self.kernel_size = kernel_size
        self.weight_init = weight_init
        self.windowed_pif = windowed_pif
        self.norm_periodicities = norm_periodicities
        self.filters = torch.from_numpy(gammatone_filter_bank(
            model_dim, kernel_size, start_hz=20, stop_hz=samplerate // 2 - 10,
            samplerate=samplerate, band_spacing="geometric")).to(default_device(device))

    def apply_filter_bank(self, x: torch.Tensor) -> torch.Tensor:
        return rectified_filter_bank(x, self.filters)

    def pooled_filter_bank(self, x: torch.Tensor) -> torch.Tensor:
        """The filter bank's output, the maximum over windows of 512
        samples every 256 (padded with -inf), one frame per 256 samples."""
        orig = x.shape[-1]
        fb = self.apply_filter_bank(x)
        pooled = F.max_pool1d(fb.contiguous(), 512, 256, padding=256)
        return pooled[..., : orig // 256]

    def perceptual_feature(self, x: torch.Tensor) -> torch.Tensor:
        return auditory_image(self.apply_filter_bank(x), 512, self.n_samples // 256,
                              do_windowing=self.windowed_pif, check_cola=False,
                              norm_periodicities=self.norm_periodicities)

    def perceptual_loss(self, a: torch.Tensor, b: torch.Tensor, norm: str = "l2"):
        """The mean squared (``norm="l2"``) or summed absolute difference of
        the two perceptual features."""
        fa = self.perceptual_feature(a)
        fb = self.perceptual_feature(b)
        if norm == "l2":
            return torch.mean((fa - fb) ** 2)
        return torch.sum(kinks.abs(fa - fb))

    def perceptual_triune(self, x: torch.Tensor):
        """(place, population, spike-timing) encodings: the pooled bank
        unit-normed over the channels, its mean over groups of 8 channels,
        and the unwindowed auditory image unit-normed over the
        periodicities."""
        batch = x.shape[0]
        fb = self.apply_filter_bank(x)
        pooled = self.pooled_filter_bank(x)
        place_encoding = unit_norm(pooled, axis=1)
        groups = pooled.shape[1] // 8
        pe = pooled[:, : groups * 8].reshape(batch, groups, 8, -1).sum(dim=2) / 8.0
        st = auditory_image(fb, 512, self.n_samples // 256, do_windowing=False, check_cola=False)
        return place_encoding, pe, unit_norm(st, axis=-1)
