"""The Fourier-mixer transformer and the pooling metaformer (counterpart of
``mptpu/nn/transformer.py``). Channels-last; children carry flax's
names."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import no_tf32
from ..ops import kinks
from .init import flax_linear, uniform_linear
from .layers import LayerNorm


class ForwardBlock(nn.Module):
    """``leaky_relu(Dense_0(x) + x, 0.2)``, the Dense uniform +-0.1."""

    def __init__(self, n_channels: int, generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.Dense_0 = uniform_linear(n_channels, n_channels, True, 0.1, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            h = self.Dense_0(x)
        return kinks.leaky_relu(h + x, 0.2)


def fourier_mix(x: torch.Tensor) -> torch.Tensor:
    """FNet's token mixing: the real part of the ortho-scaled FFT over the
    features, then over the sequence."""
    n1, n2 = x.shape[-1], x.shape[-2]
    x = torch.fft.fft(x, dim=-1) * (1.0 / math.sqrt(n1))
    x = torch.fft.fft(x, dim=-2) * (1.0 / math.sqrt(n2))
    return x.real


class FourierMixer(nn.Module):
    """:func:`fourier_mix` as a module (no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fourier_mix(x)


class Transformer(nn.Module):
    """``n_layers`` of (``ForwardBlock_i``, :func:`fourier_mix`);
    ``return_features`` also gives each layer's output."""

    def __init__(self, n_channels: int, n_layers: int, return_features: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_layers, self.return_features = n_layers, return_features
        for i in range(n_layers):
            self.add_module(f"ForwardBlock_{i}", ForwardBlock(n_channels, gen, device))

    def forward(self, x: torch.Tensor):
        features = []
        for i in range(self.n_layers):
            x = fourier_mix(getattr(self, f"ForwardBlock_{i}")(x))
            features.append(x)
        return (x, features) if self.return_features else x


class MetaFormerBlock(nn.Module):
    """PoolFormer's block over (batch, seq, channels): ``x + (pool(h) -
    h)`` with ``h = LayerNorm_0(x)`` and ``pool`` the mean over
    ``pool_size`` steps, zeros padded at both ends and counted; then ``x +
    Dense_1(gelu(Dense_0(LayerNorm_1(x))))``, GELU in its tanh form (JAX's
    default)."""

    def __init__(self, channels: int, pool_size: int = 3,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.pool_size = pool_size
        self.LayerNorm_0 = LayerNorm(channels, device=device)
        self.LayerNorm_1 = LayerNorm(channels, device=device)
        self.Dense_0 = flax_linear(channels, channels * 4, True, gen, device)
        self.Dense_1 = flax_linear(channels * 4, channels, True, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.LayerNorm_0(x)
        # contiguous: CUDA's pooling backward went wrong on the transposed view (its gradients
        # 0.4 to 2.3 of their largest from the CPU's in float64, the forward right)
        pooled = F.avg_pool1d(h.transpose(1, 2).contiguous(), self.pool_size, 1,
                              padding=self.pool_size // 2, count_include_pad=True).transpose(1, 2)
        x = x + (pooled - h)
        with no_tf32():
            h = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh"))
        return x + h


class MetaFormer(nn.Module):
    """``n_layers`` metaformer blocks, ``MetaFormerBlock_i``."""

    def __init__(self, channels: int, n_layers: int, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"MetaFormerBlock_{i}", MetaFormerBlock(channels, generator=gen,
                                                                    device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"MetaFormerBlock_{i}")(x)
        return x
