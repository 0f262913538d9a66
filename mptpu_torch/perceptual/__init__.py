"""Perceptual features (counterpart of ``mptpu.perceptual``): the gammatone
and morlet banks, the auditory image model, the cochlea model, the
scattering transform, the psychoacoustic and texture features, and the
FFT-based phase-invariant feature with its distance."""

from .aim import auditory_image, auditory_image_model, rectified_filter_bank
from .distance import pif_distance
from .feature import CochleaModel, cochlea_filter_bank, cochlea_model, periodicity_feature
from .filterbank import (avg_pool_1d, filter_bank_convolve, mel_scale_hz, morlet,
                         morlet_filter_bank)
from .gammatone import gammatone_filter_bank
from .pif import fft_based_pif
from .psychoacoustic import PsychoacousticFeature
from .scattering import MoreCorrectScattering, scattering_transform
from .texture import AudioTextureFeatures, calculate_kurtosis

__all__ = ["auditory_image", "auditory_image_model", "rectified_filter_bank", "pif_distance",
           "CochleaModel", "cochlea_filter_bank", "cochlea_model", "periodicity_feature",
           "avg_pool_1d", "filter_bank_convolve", "mel_scale_hz", "morlet",
           "morlet_filter_bank", "gammatone_filter_bank", "fft_based_pif",
           "PsychoacousticFeature", "MoreCorrectScattering", "scattering_transform",
           "AudioTextureFeatures", "calculate_kurtosis"]
