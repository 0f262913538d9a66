"""flax layers with flax's semantics, where PyTorch's differ (used by the
port's counterparts of ``mptpu``'s ``nn`` stacks and models).

- ``ConvTranspose1d``: flax's ``nn.ConvTranspose`` (no kernel
  transposition) is a correlation of the stride-dilated input with the
  kernel as stored, padded by ``lax.conv_transpose``'s rule: ``"SAME"``
  gives ``stride * n`` samples, an explicit ``(lo, hi)`` pads by it, so
  ``[(1, 1)]`` at kernel 4 and stride 2 gives ``2 n - 2``. PyTorch's
  ``conv_transpose1d`` flips the kernel, so the layer keeps flax's kernel
  (``kernel`` (k, in, out), ``bias``) and hands PyTorch its flip with the
  padding ``k - 1 - lo``.
- ``BatchNorm``: momentum 0.99, eps 1e-5, the variance ``mean(x^2) -
  mean(x)^2`` (biased, floored at 0) both for normalising and for the
  running variance, which PyTorch's ``BatchNorm1d`` keeps unbiased.
  Parameters ``scale`` and ``bias``; the running statistics are the
  buffers ``mean`` and ``var`` (flax's ``batch_stats``).
- ``LayerNorm``: eps 1e-6 (PyTorch's default is 1e-5), the same fast
  variance, ``scale`` and ``bias`` optional.
- ``dropout``: flax's ``Dropout``, ``where(keep, x / (1 - rate), 0)``, its
  mask taken from an iterator of masks or drawn from a generator.

Tensors are channels-last, as flax's; ``conv_last`` runs an
``nn.Conv1d`` on them.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device, no_tf32
from ..ops import kinks
from .init import uniform_init

Padding = Union[str, Sequence[Tuple[int, int]]]


def flax_conv(in_channels: int, out_channels: int, kernel_size: int, init_scale: float,
              generator: torch.Generator, stride: int = 1, dilation: int = 1,
              device=None) -> nn.Conv1d:
    """An ``nn.Conv1d`` (no padding of its own) whose weight is a flax
    kernel (k, in, out) drawn uniform in +-``init_scale``, bias zero."""
    conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride=stride, dilation=dilation)
    with torch.no_grad():
        kernel = uniform_init((kernel_size, in_channels, out_channels), init_scale, generator)
        conv.weight.copy_(kernel.permute(2, 1, 0))
        conv.bias.zero_()
    return conv.to(default_device(device))


def conv_last(conv: nn.Conv1d, x: torch.Tensor, padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """flax's ``Conv`` on channels-last ``x`` (batch, time, channels) with
    explicit ``padding`` (lo, hi) of the time axis."""
    with no_tf32():
        return conv(F.pad(x.transpose(1, 2), padding)).transpose(1, 2)


def transpose_padding(kernel_size: int, stride: int, padding: Padding) -> Tuple[int, int]:
    """``lax.conv_transpose``'s (lo, hi) padding of the dilated input, for
    ``"SAME"`` or one explicit (lo, hi) pair."""
    if padding == "SAME":
        pad_len = kernel_size + stride - 2
        lo = kernel_size - 1 if stride > kernel_size - 1 else -(-pad_len // 2)
        return lo, pad_len - lo
    ((lo, hi),) = padding
    return lo, hi


class ConvTranspose1d(nn.Module):
    """flax's ``ConvTranspose`` over channels-last (batch, time, in) ->
    (batch, time', out), the kernel drawn uniform in +-``init_scale``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: Padding, init_scale: float = 0.1,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        self.stride = stride
        self.pads = transpose_padding(kernel_size, stride, padding)
        lo, hi = self.pads
        if not (0 <= lo <= kernel_size - 1 and 0 <= hi - lo < stride):
            raise ValueError(f"padding {padding} gives ({lo}, {hi}), which conv_transpose1d "
                             f"cannot express at kernel {kernel_size} and stride {stride}")
        self.kernel = nn.Parameter(
            uniform_init((kernel_size, in_channels, out_channels), init_scale, gen).to(dev))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[0]
        lo, hi = self.pads
        weight = self.kernel.permute(1, 2, 0).flip(-1)   # (in, out, k), flipped
        with no_tf32():
            y = F.conv_transpose1d(x.transpose(1, 2), weight, self.bias, stride=self.stride,
                                   padding=k - 1 - lo, output_padding=hi - lo)
        return y.transpose(1, 2)


def _fast_stats(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's statistics: the mean, and ``max(0, mean(x^2) - mean^2)``."""
    mu = torch.mean(x, dim=dims)
    mu2 = torch.mean(x * x, dim=dims)
    return mu, kinks.clip(mu2 - mu * mu, 0.0)


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
               scale: Optional[torch.Tensor], bias: Optional[torch.Tensor]) -> torch.Tensor:
    """flax's ``_normalize``, operation for operation; ``mean``, ``var``,
    ``scale`` and ``bias`` already broadcast against ``x``."""
    y = x - mean
    mul = torch.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale
    y = y * mul
    return y + bias if bias is not None else y


# flax's defaults, which every mptpu module keeps
BATCH_NORM_MOMENTUM, BATCH_NORM_EPS, LAYER_NORM_EPS = 0.99, 1e-5, 1e-6


class BatchNorm(nn.Module):
    """flax's ``BatchNorm`` over the features on ``axis`` (the last by
    default), momentum 0.99 and eps 1e-5: ``train=True`` normalises by the
    batch's statistics and moves the running ones, ``train=False``
    normalises by the running ones."""

    def __init__(self, features: int, axis: int = -1, device=None):
        super().__init__()
        dev = default_device(device)
        self.axis = axis
        self.scale = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        axis = self.axis % x.ndim
        dims = tuple(d for d in range(x.ndim) if d != axis)
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        if train:
            mean, var = _fast_stats(x, dims)
            with torch.no_grad():
                m = BATCH_NORM_MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return _normalize(x, mean.reshape(shape), var.reshape(shape), BATCH_NORM_EPS,
                          self.scale.reshape(shape), self.bias.reshape(shape))


class LayerNorm(nn.Module):
    """flax's ``LayerNorm`` over the last axis (eps 1e-6)."""

    def __init__(self, features: int, use_scale: bool = True, use_bias: bool = True,
                 device=None):
        super().__init__()
        dev = default_device(device)
        self.scale = nn.Parameter(torch.ones(features, device=dev)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features, device=dev)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _fast_stats(x, -1)
        return _normalize(x, mean[..., None], var[..., None], LAYER_NORM_EPS, self.scale, self.bias)


Masks = Optional[Iterator[torch.Tensor]]


def dropout(x: torch.Tensor, rate: float, deterministic: bool, masks: Masks = None,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's ``Dropout``: ``x`` itself when ``deterministic``, else
    ``where(keep, x / (1 - rate), 0)`` with ``keep`` the next of ``masks``
    (booleans of ``x``'s shape) or drawn from ``generator`` (on its
    device, then moved to ``x``'s)."""
    if deterministic or rate == 0.0:
        return x
    if masks is not None:
        keep = next(masks).to(x.device)
    else:
        dev = generator.device if generator is not None else x.device
        keep = (torch.rand(x.shape, generator=generator, device=dev) < 1.0 - rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
