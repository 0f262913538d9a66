"""L0 ops of the sparse layer (counterpart of ``mptpu.ops``; only the
ported names)."""

from .fft import n_fft_coeffs, next_pow2, rfft, irfft, fft_convolve, simple_fft_convolve
from .correlation import mp_correlate, torch_style_conv
from .norms import unit_norm, max_norm, limit_norm, example_norm
from .decompose import (
    band_sizes,
    fft_frequency_decompose,
    fft_frequency_recompose,
    fft_resample,
)
from .ste import (
    straight_through,
    leaky_relu_ste,
    sparse_softmax,
    soft_dirac,
    soft_clamp,
    step_func,
    hard_softmax,
)
from .refit import refit_gains

__all__ = [
    "n_fft_coeffs",
    "next_pow2",
    "rfft",
    "irfft",
    "fft_convolve",
    "simple_fft_convolve",
    "mp_correlate",
    "torch_style_conv",
    "unit_norm",
    "max_norm",
    "limit_norm",
    "example_norm",
    "band_sizes",
    "fft_frequency_decompose",
    "fft_frequency_recompose",
    "fft_resample",
    "straight_through",
    "leaky_relu_ste",
    "sparse_softmax",
    "soft_dirac",
    "soft_clamp",
    "step_func",
    "hard_softmax",
    "refit_gains",
]
