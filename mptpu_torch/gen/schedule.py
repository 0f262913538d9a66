"""Event placement schedulers (counterpart of ``mptpu/gen/schedule.py``).

A scheduler is a static configuration with ``init_params(generator)`` and
``schedule(pos, events)``; positions stay differentiable through
straight-through one-hots (softmax backward) and FFT phase ramps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..nn.init import uniform
from ..ops.fft import cexp, fft_convolve, irfft, rfft
from ..ops.ste import sparse_softmax
from ..ops.upsample import upsample_with_holes


def interpretable_fft_shift(a: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Circular FFT shift: ``shift`` in [0, 1] maps onto half the signal,
    1 meaning no shift; nothing is padded, so content wraps around."""
    shift = 1.0 - shift
    n_samples = a.shape[-1]
    shift_samples = shift * n_samples * 0.5
    spec = rfft(a, norm="ortho")
    n_coeffs = spec.shape[-1]
    theta = (torch.arange(n_coeffs, device=a.device) * 2.0 * math.pi / n_coeffs) * shift_samples
    return irfft(spec * cexp(theta), n=n_samples, norm="ortho")


def hierarchical_dirac(elements: torch.Tensor, soft: bool = False, return_logits: bool = False):
    """Binary-tree dirac: (..., log2(n), 2) choices -> (..., n). Each level
    zero-stuffs the signal so far to twice its length and convolves it with
    that level's pair; with ``soft=False`` every pair is one-hot forward
    (``sparse_softmax(normalize=True)``) and a softmax backward, so the
    result is one-hot within FFT round-off."""
    seq_shape = elements.shape[:-2]
    steps = elements.shape[-2]
    if soft:
        chosen = torch.softmax(elements, dim=-1)
    else:
        chosen = sparse_softmax(elements, normalize=True, axis=-1)
    signal = chosen[..., 0, :]
    current_size = 2
    for i in range(1, steps):
        new_size = current_size * 2
        stuffed = upsample_with_holes(signal, new_size)
        zeros = torch.zeros(*seq_shape, new_size - 2, dtype=elements.dtype, device=elements.device)
        current = torch.cat([chosen[..., i, :], zeros], dim=-1)
        signal = fft_convolve(stuffed, current)
        current_size = new_size
    if return_logits:
        return signal, chosen
    return signal


class DiracScheduler:
    """Softmax positions on a coarse grid, zero-stuffed to the sample rate
    and FFT-convolved with the events."""

    def __init__(self, n_events: int, start_size: int, n_samples: int, pre_sparse: bool = False):
        self.n_events = n_events
        self.start_size = start_size
        self.n_samples = n_samples
        self.pre_sparse = pre_sparse

    @property
    def param_shape(self):
        return (1, self.n_events, self.start_size)

    def init_params(self, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
        """Uniform in [-0.02, 0.02) from ``generator`` (``nn.init.uniform``)."""
        pos = uniform(self.param_shape, -0.02, 0.02, generator, device)
        if self.pre_sparse:
            pos = sparse_softmax(pos, normalize=True, axis=-1)
        return pos

    random_params = init_params

    def schedule(self, pos: torch.Tensor, events: torch.Tensor) -> torch.Tensor:
        if not self.pre_sparse:
            pos = sparse_softmax(pos, normalize=True, axis=-1)
        pos = upsample_with_holes(pos, desired_size=self.n_samples)
        return fft_convolve(events, pos)


class FFTShiftScheduler:
    """Scalar positions applied as circular FFT shifts."""

    def __init__(self, n_events: int):
        self.n_events = n_events

    @property
    def param_shape(self):
        return (1, self.n_events, 1)

    def init_params(self, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
        return uniform(self.param_shape, 0.0, 1.0, generator, device)

    random_params = init_params

    def schedule(self, pos: torch.Tensor, events: torch.Tensor) -> torch.Tensor:
        return interpretable_fft_shift(events, pos)


class HierarchicalDiracModel:
    """Binary-tree positions: (1, n_events, log2(signal_size), 2)."""

    def __init__(self, n_events: int, signal_size: int):
        self.n_events = n_events
        self.signal_size = signal_size
        self.n_elements = int(np.log2(signal_size))

    @property
    def param_shape(self):
        return (1, self.n_events, self.n_elements, 2)

    def init_params(self, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
        return uniform(self.param_shape, -0.02, 0.02, generator, device)

    random_params = init_params

    def schedule(self, pos: torch.Tensor, events: torch.Tensor) -> torch.Tensor:
        return fft_convolve(hierarchical_dirac(pos), events)
