"""FFT convolution and shift primitives and complex construction
and phase randomisation (counterpart of ``mptpu/ops/fft.py``).

Real FFTs over the last axis; ``norm="ortho"`` is passed straight to
``torch.fft``.
"""

from __future__ import annotations

import math
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


def real_ends(spec: torch.Tensor) -> torch.Tensor:
    """``spec`` with the imaginary parts of its first and last coefficients
    set to 0, which is what an inverse real FFT of even length reads of
    them: pocketfft (numpy, XLA, torch on the CPU) drops them, but cuFFT's
    float32 inverse does not at every length (on an H100 the 8,192- and
    16,384-sample octave bands came out 4e-4 of their largest from float64).
    Every spectrum that is not an rFFT's own (a slice of a larger one, a
    product with a complex ramp or envelope, one built from real numbers)
    goes through this before its inverse."""
    keep = torch.ones(spec.shape[-1], dtype=spec.real.dtype, device=spec.device)
    # slices, not elements: a number written to a slice of a CUDA tensor is
    # a fill, to one element a copy from the host that waits for the card
    keep[:1] = 0.0
    keep[-1:] = 0.0
    return torch.complex(spec.real, spec.imag * keep)


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


def fft_shift(a: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Fractional delay by a frequency-domain phase ramp: ``shift`` in
    [0, 1] moves the signal by up to ``n_samples / 3`` samples. The signal
    is padded to 3x its length, so shifted content does not wrap around."""
    n_samples = a.shape[-1]
    shift_samples = shift * n_samples * (1.0 / 3.0)
    padded_len = n_samples * 3
    spec = torch.fft.rfft(a, n=padded_len, dim=-1)
    n_coeffs = spec.shape[-1]
    k = torch.arange(n_coeffs, dtype=a.dtype, device=a.device)
    theta = -(k * 2.0 * math.pi / n_coeffs) * shift_samples
    samples = torch.fft.irfft(real_ends(spec * cexp(theta)), n=padded_len, dim=-1)
    return samples[..., :n_samples]


def randomize_phase(x: torch.Tensor, generator: torch.Generator | None = None,
                    phases: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` with its rFFT's magnitudes kept and its phases replaced by the
    running sum over axis 1 of uniform draws in [-pi, pi), wrapped back into
    [-pi, pi). ``phases`` are those draws (the spectrum's shape), else they
    come from ``generator`` on its device (``x``'s device without one)."""
    spec = torch.fft.rfft(x, dim=-1)
    mags = torch.abs(spec)
    if phases is None:
        dev = generator.device if generator is not None else x.device
        phases = (torch.rand(spec.shape, generator=generator, device=dev, dtype=x.dtype)
                  * (2 * math.pi) - math.pi).to(x.device)
    imag = torch.cumsum(phases, dim=1)
    imag = torch.remainder(imag + math.pi, 2 * math.pi) - math.pi
    return torch.fft.irfft(real_ends(mags * cexp(imag)), n=x.shape[-1], dim=-1)
