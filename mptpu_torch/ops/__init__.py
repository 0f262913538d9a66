"""L0 ops (counterpart of ``mptpu.ops``; only the ported names)."""

from .fft import (
    n_fft_coeffs,
    next_pow2,
    to_complex,
    cexp,
    rfft,
    irfft,
    real_ends,
    fft_convolve,
    simple_fft_convolve,
    fft_shift,
    randomize_phase,
)
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
from .windows import hann_window, hamming_window, linspace
from .pdf import pdf, pdf2, gamma_pdf
from .upsample import (
    upsample_with_holes,
    interpolate_last_axis,
    ensure_last_axis_length,
    fft_upsample,
)
from .stft import stft, log_stft, stft_relative_phase, short_time_transform
from .overlap_add import overlap_add
from .features import amplitude_envelope, mfcc, chroma, chroma_basis
from .phase import (
    windowed_audio,
    stft_complex,
    istft,
    rfft_freqs,
    mag_phase_decomposition,
    mag_phase_recomposition,
    AudioCodec,
)
from .custom_grads import (
    position_render,
    scalar_position,
    differentiable_fft_shift,
    schedule_atoms,
    diff_index,
)

__all__ = [
    "n_fft_coeffs",
    "next_pow2",
    "to_complex",
    "cexp",
    "rfft",
    "irfft",
    "real_ends",
    "fft_convolve",
    "simple_fft_convolve",
    "fft_shift",
    "randomize_phase",
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
    "hann_window",
    "hamming_window",
    "linspace",
    "pdf",
    "pdf2",
    "gamma_pdf",
    "upsample_with_holes",
    "interpolate_last_axis",
    "ensure_last_axis_length",
    "fft_upsample",
    "stft",
    "log_stft",
    "stft_relative_phase",
    "short_time_transform",
    "overlap_add",
    "amplitude_envelope",
    "mfcc",
    "chroma",
    "chroma_basis",
    "windowed_audio",
    "stft_complex",
    "istft",
    "rfft_freqs",
    "mag_phase_decomposition",
    "mag_phase_recomposition",
    "AudioCodec",
    "position_render",
    "scalar_position",
    "differentiable_fft_shift",
    "schedule_atoms",
    "diff_index",
]
