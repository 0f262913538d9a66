"""The energy-conserving block instrument (counterpart of
``mptpu/gen/energy.py``): audio as non-overlapping blocks of samples,
projected to ``model_channels``; each layer injects its activations into a
bank of decaying lines by an FFT convolution, so that energy can only
decay from block to block; a discontinuity penalty keeps the block
boundaries continuous.

Children and parameters carry flax's names (``Dense_0``, ``EnergyBlock_i``
with ``Dense_0``, ``Dense_1``, ``gain`` and ``pow``, then the output
``Dense_1``), so ``convert.module_from_flax`` carries ``mptpu``'s trees.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..device import default_device, no_tf32
from ..nn.init import uniform, uniform_linear
from ..ops import kinks
from ..ops.fft import fft_convolve
from ..ops.windows import linspace


def to_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """(batch, channels, n) -> (batch, channels, n // block_size, block_size)."""
    b, c, n = x.shape
    return x.reshape(b, c, n // block_size, block_size)


def blocks_to_samples(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_blocks`: the last two axes joined."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def compute_discontinuity(x: torch.Tensor) -> torch.Tensor:
    """The sum over blocks of |last sample of block i - first sample of
    block i + 1|, with ``jnp.abs``'s gradient at 0."""
    return kinks.abs(x[..., :-1, -1] - x[..., 1:, 0]).sum()


class EnergyBlock(nn.Module):
    """One layer on (batch, blocks, channels): a projection (``Dense_0``),
    the values (``Dense_1``) convolved over the blocks with one decay line
    per channel, ``linspace(1, 0, line_len) ** (2 + 100 sigmoid(pow))``
    (0 past ``line_len`` blocks), times ``gain``, through ``non_linearity``."""

    def __init__(self, channels: int, non_linearity: Callable = torch.tanh, line_len: int = 512,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        self.non_linearity = non_linearity
        self.line_len = line_len
        self.Dense_0 = uniform_linear(channels, channels, False, 0.05, gen, dev)
        self.Dense_1 = uniform_linear(channels, channels, False, 0.05, gen, dev)
        self.gain = nn.Parameter(uniform((1, 1, channels), 0.01, 1.0, gen).to(dev))
        self.pow = nn.Parameter(uniform((1, channels, 1), -6.0, 6.0, gen).to(dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            v = self.Dense_1(self.Dense_0(x))   # (batch, time, channels)
        time = v.shape[1]
        line = linspace(1.0, 0.0, self.line_len, device=v.device, dtype=v.dtype)
        line = torch.cat([line, line.new_zeros(max(0, time - self.line_len))])[:time]
        # at a base of exactly 0 the exponent's gradient is 0, as in JAX
        z = line[None, None, :] ** (2.0 + torch.sigmoid(self.pow) * 100.0)   # (1, C, time)
        out = fft_convolve(z, v.transpose(1, 2)).transpose(1, 2)
        return self.non_linearity(out * self.gain)


class EnergyInstrumentModel(nn.Module):
    """(batch, input_channels, n_samples) control signal -> (batch, 1,
    n_samples) audio: blocks of ``block_size`` samples, ``Dense_0`` to
    ``model_channels``, ``n_layers`` :class:`EnergyBlock` s, ``Dense_1``
    back to a block. Weights uniform in [-0.05, 0.05) from ``generator``
    (a CPU one, default seed 0)."""

    def __init__(self, input_channels: int = 1, model_channels: int = 128,
                 block_size: int = 512, n_layers: int = 3,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        self.block_size, self.n_layers = block_size, n_layers
        self.Dense_0 = uniform_linear(input_channels * block_size, model_channels, False, 0.05,
                                      gen, dev)
        for i in range(n_layers):
            self.add_module(f"EnergyBlock_{i}", EnergyBlock(model_channels, generator=gen,
                                                            device=dev))
        self.Dense_1 = uniform_linear(model_channels, block_size, False, 0.05, gen, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        blocked = to_blocks(x, self.block_size)
        t = blocked.shape[2]
        blocked = blocked.transpose(1, 2).reshape(b, t, -1)
        with no_tf32():
            h = self.Dense_0(blocked)
        for i in range(self.n_layers):
            h = getattr(self, f"EnergyBlock_{i}")(h)
        with no_tf32():
            out = self.Dense_1(h)   # (batch, blocks, block_size)
        return out.reshape(b, 1, t * self.block_size)

    def block_view(self, audio: torch.Tensor) -> torch.Tensor:
        return to_blocks(audio, self.block_size)
