"""The 1-D UNet and the downsampling discriminator (counterpart of
``mptpu/nn/unet.py``). Public shape (batch, channels, time); children
carry flax's names (``_Down_i``, ``_Up_i``, ``Conv_0``, ``Dense_0``).

flax's transposed convolution with explicit padding ``[(1, 1)]`` at kernel
4 and stride 2 gives ``2 n - 2`` samples, not ``2 n``
(``nn/layers.py``). The up path's lengths therefore miss the down path's
(from 128: down 64, 32, 16, 8, 4; up 6, 10, 18, 34, 66), and a skip
connection is added only where two lengths meet, as in ``mptpu``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import no_tf32
from ..ops import kinks
from ..ops.stft import stft
from .init import uniform_linear
from .layers import BatchNorm, ConvTranspose1d, Masks, conv_last, dropout, flax_conv


class _Down(nn.Module):
    """Dropout (0.1), a convolution of kernel 3 and stride 2 padded (1, 1),
    leaky ReLU (0.2), and with ``norm`` a batch norm."""

    def __init__(self, in_channels: int, channels: int, norm: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.norm = norm
        self.Conv_0 = flax_conv(in_channels, channels, 3, 0.1, gen, stride=2, device=device)
        if norm:
            self.BatchNorm_0 = BatchNorm(channels, device=device)

    def forward(self, x, deterministic: bool = True, train: bool = False, masks: Masks = None,
                generator: torch.Generator | None = None):
        x = dropout(x, 0.1, deterministic, masks, generator)
        x = kinks.leaky_relu(conv_last(self.Conv_0, x, (1, 1)), 0.2)
        return self.BatchNorm_0(x, train) if self.norm else x


class _Up(nn.Module):
    """Dropout (0.1), flax's transposed convolution of kernel 4 and stride 2
    padded [(1, 1)], leaky ReLU (0.2), and with ``norm`` a batch norm."""

    def __init__(self, channels: int, norm: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.norm = norm
        self.ConvTranspose_0 = ConvTranspose1d(channels, channels, 4, 2, [(1, 1)], 0.1, gen,
                                               device)
        if norm:
            self.BatchNorm_0 = BatchNorm(channels, device=device)

    def forward(self, x, deterministic: bool = True, train: bool = False, masks: Masks = None,
                generator: torch.Generator | None = None):
        x = dropout(x, 0.1, deterministic, masks, generator)
        x = kinks.leaky_relu(self.ConvTranspose_0(x), 0.2)
        return self.BatchNorm_0(x, train) if self.norm else x


class UNet(nn.Module):
    """(batch, in_channels, time) -> (batch, out_channels, time'): ``levels``
    down layers, then either a judging convolution (``is_disc``: kernel 4,
    stride 4, no padding, one channel) or ``levels`` up layers, each added
    to the down layer of its length where there is one, and ``Dense_0``.
    ``in_channels`` defaults to ``channels``."""

    def __init__(self, channels: int, is_disc: bool = False, norm: bool = True,
                 out_channels: int = 4096, levels: int = 5, in_channels: Optional[int] = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.is_disc, self.levels = is_disc, levels
        for i in range(levels):
            self.add_module(f"_Down_{i}", _Down((in_channels or channels) if i == 0 else channels,
                                                channels, norm, gen, device))
        if is_disc:
            self.Conv_0 = flax_conv(channels, 1, 4, 0.1, gen, stride=4, device=device)
        else:
            for i in range(levels):
                self.add_module(f"_Up_{i}", _Up(channels, norm, gen, device))
            self.Dense_0 = uniform_linear(channels, out_channels, True, 0.1, gen, device)

    def forward(self, x: torch.Tensor, deterministic: bool = True, train: bool = False,
                masks: Masks = None, generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.transpose(1, 2)
        context = {}
        for i in range(self.levels):
            x = getattr(self, f"_Down_{i}")(x, deterministic, train, masks, generator)
            context[x.shape[1]] = x
        if self.is_disc:
            return conv_last(self.Conv_0, x).transpose(1, 2)
        for i in range(self.levels):
            x = getattr(self, f"_Up_{i}")(x, deterministic, train, masks, generator)
            if x.shape[1] in context:
                x = x + context[x.shape[1]]
        with no_tf32():
            return self.Dense_0(x).transpose(1, 2)


class DownsamplingDiscriminator(nn.Module):
    """(batch, 1, n_samples) audio -> (batch, 1, frames'): the STFT
    (``window_size`` / ``step_size``, magnitudes or with
    ``complex_valued`` the real and imaginary parts) through ``Dense_0``,
    ``log2(frames) - 2`` down layers without norm, and a judging
    convolution (kernel 4, stride 4, no padding)."""

    def __init__(self, window_size: int, step_size: int, n_samples: int, channels: int,
                 complex_valued: bool = False, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.window_size, self.step_size = window_size, step_size
        self.complex_valued = complex_valued
        n_coeffs = window_size // 2 + 1
        self.input_channels = n_coeffs * 2 if complex_valued else n_coeffs
        self.n_layers = int(math.log2(n_samples // step_size)) - 2
        self.Dense_0 = uniform_linear(self.input_channels, channels, True, 0.1, gen, device)
        for i in range(self.n_layers):
            self.add_module(f"_Down_{i}", _Down(channels, channels, False, gen, device))
        self.Conv_0 = flax_conv(channels, 1, 4, 0.1, gen, stride=4, device=device)

    def forward(self, x: torch.Tensor, deterministic: bool = True, masks: Masks = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        s = stft(x, ws=self.window_size, step=self.step_size, pad=True,
                 return_complex=self.complex_valued).reshape(x.shape[0], -1, self.input_channels)
        with no_tf32():
            s = self.Dense_0(s)
        for i in range(self.n_layers):
            s = getattr(self, f"_Down_{i}")(s, deterministic, False, masks, generator)
        return conv_last(self.Conv_0, s).transpose(1, 2)
