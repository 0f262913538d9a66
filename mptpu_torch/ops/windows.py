"""Window functions and the float32 grid (counterpart of
``mptpu/ops/windows.py``, plus the grid of ``jnp.linspace``).

The windows are computed in float64 numpy and then cast, as ``mptpu``
does; ``torch.hann_window`` computes in float32 and can differ in the last
place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import default_device


def hann_window(size: int, periodic: bool = True, dtype=torch.float32, device=None) -> torch.Tensor:
    """Hann window; ``periodic=True`` is the COLA form that the STFT uses."""
    n = size + 1 if not periodic else size
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    if not periodic:
        w = w[:size] if size == 1 else (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(size) / (size - 1)))
    return torch.from_numpy(w[:size].copy()).to(default_device(device), dtype)


def hamming_window(size: int, periodic: bool = False, dtype=torch.float32, device=None) -> torch.Tensor:
    denom = size if periodic else size - 1
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(size) / denom)
    return torch.from_numpy(w).to(default_device(device), dtype)


def linspace(start: float, stop: float, num: int, device=None,
             dtype=torch.float32) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in ``dtype`` (float32 unless
    asked) by its own formula:
    ``start * (1 - s) + stop * s`` with ``s = i * (1 / (num - 1))``, and
    ``stop`` exactly at the end. ``torch.linspace`` computes otherwise and
    differs from it in the last place at most sizes; XLA may fuse the
    arithmetic, so a value may still differ from ``jnp``'s by one place
    (not on a grid from 0 to 1)."""
    dev = default_device(device)
    first = torch.tensor([start], dtype=dtype, device=dev)
    if num == 1:
        return first
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=dev) * (
        torch.tensor(1.0, dtype=dtype) / div).to(dev)
    end = torch.tensor([stop], dtype=dtype, device=dev)
    return torch.cat([first * (1 - step) + end * step, end])
