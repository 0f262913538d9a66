"""Decaying sines and noise (the multiband benchmark script's signal):
``sum_i sin(2 pi f_i t) exp(-t decay_i)`` over ``partials`` at
``samplerate``, plus Gaussian noise of ``base_noise``, scaled to a peak of
1, the same for every item of the batch, plus each item's own noise of
``item_noise``. The noise is new in every batch."""

from __future__ import annotations

import math

import torch


def make(spec, *, batch, n_samples, n_steps, gen, device, dictionary=None):
    t = torch.arange(n_samples, device=device, dtype=torch.float64) / spec["samplerate"]
    base = sum(torch.sin(2 * math.pi * f * t) * torch.exp(-t * decay)
               for f, decay in spec["partials"])
    base = base + spec["base_noise"] * torch.randn(n_samples, generator=gen, device=device,
                                                   dtype=torch.float64)
    base = base / base.abs().max()
    items = spec["item_noise"] * torch.randn((batch, n_samples), generator=gen, device=device,
                                             dtype=torch.float64)
    return (base[None, :] + items).float()[:, None, :]
