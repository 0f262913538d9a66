"""Losses of the port (counterpart of ``mptpu.losses``)."""

from .autocorrelation import AutocorrelationLoss, DecayLoss
from .correlation import (CorrelationLoss, correlation_loss, covariance, multiband_noise_loss,
                          noise_loss)
from .gan import least_squares_disc_loss, least_squares_generator_loss, squared_gan_loss
from .infoloss import (MultiBandSpectralInfoLoss, MultiWindowSpectralInfoLoss, SpectralInfoLoss,
                       patches2)
from .iterative import iterative_loss, sort_channels_descending_norm
from .multiband_spec import flattened_multiband_spectrogram, multiband_spectrogram, stft_transform
from .serial import serial_loss, serial_matching_pursuit

__all__ = [
    "AutocorrelationLoss",
    "DecayLoss",
    "CorrelationLoss",
    "correlation_loss",
    "covariance",
    "multiband_noise_loss",
    "noise_loss",
    "least_squares_disc_loss",
    "least_squares_generator_loss",
    "squared_gan_loss",
    "MultiBandSpectralInfoLoss",
    "MultiWindowSpectralInfoLoss",
    "SpectralInfoLoss",
    "patches2",
    "iterative_loss",
    "sort_channels_descending_norm",
    "flattened_multiband_spectrogram",
    "multiband_spectrogram",
    "stft_transform",
    "serial_loss",
    "serial_matching_pursuit",
    "make_gan_steps",
    "gan_cycle",
]


def __getattr__(name):
    # the training side's GAN alternation, exported lazily as mptpu does: an
    # eager import is circular when train is the first package touched
    if name in ("make_gan_steps", "gan_cycle"):
        from ..train import gan

        return getattr(gan, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
