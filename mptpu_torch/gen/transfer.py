"""Waveform tables (counterpart of ``make_waves`` in
``mptpu/gen/transfer.py``; the rest of that module is not ported yet)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from scipy.signal import sawtooth, square

from ..device import default_device


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
