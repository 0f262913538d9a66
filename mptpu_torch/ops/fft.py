"""FFT convolution primitives and complex construction (counterpart of
``mptpu/ops/fft.py``; ``fft_shift`` and ``randomize_phase`` are not ported
yet).

Real FFTs over the last axis; ``norm="ortho"`` is passed straight to
``torch.fft``.
"""

from __future__ import annotations

from functools import reduce

import torch


def n_fft_coeffs(size: int) -> int:
    """Number of rFFT coefficients for a real signal of ``size`` samples."""
    return size // 2 + 1


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << max(0, (int(n) - 1)).bit_length()


def to_complex(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """real + 1j * imag, from float32 parts."""
    return torch.complex(real.float(), imag.float())


def cexp(phase: torch.Tensor) -> torch.Tensor:
    """exp(1j * phase) as cos + 1j * sin, as ``mptpu`` builds it."""
    return torch.complex(torch.cos(phase), torch.sin(phase))


def rfft(x: torch.Tensor, n: int | None = None, axis: int = -1, norm: str | None = None):
    return torch.fft.rfft(x, n=n, dim=axis, norm=norm)


def irfft(x: torch.Tensor, n: int | None = None, axis: int = -1, norm: str | None = None):
    return torch.fft.irfft(x, n=n, dim=axis, norm=norm)


def fft_convolve(*args: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """Multi-argument FFT convolution: each input is zero-padded to twice
    its length, the spectra are multiplied, and the product is trimmed
    back to the first input's length. Leading axes broadcast."""
    n_samples = args[0].shape[-1]
    specs = [rfft(x, n=2 * x.shape[-1], norm=norm) for x in args]
    spec = reduce(lambda a, c: a * c, specs[1:], specs[0])
    return irfft(spec, n=2 * n_samples, norm=norm)[..., :n_samples]


def simple_fft_convolve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-argument ortho-normalized FFT convolution."""
    n = a.shape[-1]
    sa = rfft(a, n=2 * n, norm="ortho")
    sb = rfft(b, n=2 * n, norm="ortho")
    return irfft(sa * sb, n=2 * n, norm="ortho")[..., :n]
