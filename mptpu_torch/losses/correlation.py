"""Losses that ask a residual to look like noise (counterpart of
``mptpu/losses/correlation.py``). ``mptpu`` draws its noise and its
permutation from a key; here they are arguments, or drawn from a
``torch.Generator``."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops import kinks
from ..ops.decompose import fft_frequency_decompose
from .multiband_spec import stft_transform


def covariance(x: torch.Tensor) -> torch.Tensor:
    """(n, features) -> (features, features), the biased covariance."""
    m = x - torch.mean(x, dim=0, keepdim=True)
    return (m.T @ m) / x.shape[0]


def _normal(shape, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    dev = generator.device if generator is not None else like.device
    return torch.randn(shape, generator=generator, device=dev, dtype=like.dtype).to(like.device)


def _noise_and_norms(t_spec, r_spec, eps, noise, generator):
    """(residual, noise spectrum, the hinge on the recon's norm above the
    target's): the noise is ``mean + std * noise`` over the residual's
    mean and population std + ``eps``."""
    residual = t_spec - r_spec
    if noise is None:
        noise = _normal(residual.shape, residual, generator)
    noise_spec = torch.mean(residual) + (torch.std(residual, correction=0) + eps) * noise
    target_norm = torch.linalg.vector_norm(t_spec, dim=-1, keepdim=True)
    recon_norm = torch.linalg.vector_norm(r_spec, dim=-1, keepdim=True)
    return residual, noise_spec, torch.sum(kinks.clip(recon_norm - target_norm, 0.0))


def noise_loss(target: torch.Tensor, recon: torch.Tensor, window_size: int = 2048,
               step_size: int = 256, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The norm hinge plus ``sum(|residual - noise spectrum|)`` over the
    flattened STFT magnitudes; ``noise`` is the standard normal draw of the
    residual's shape (batch, features)."""
    batch = target.shape[0]
    t_spec = stft_transform(target, window_size, step_size).reshape(batch, -1)
    r_spec = stft_transform(recon, window_size, step_size).reshape(batch, -1)
    residual, noise_spec, norm_loss = _noise_and_norms(t_spec, r_spec, 1e-6, noise, generator)
    return norm_loss + torch.sum(kinks.abs(residual - noise_spec))


def multiband_noise_loss(target: torch.Tensor, recon: torch.Tensor, window_size: int, step: int,
                         min_band_size: int = 512,
                         noises: Optional[Sequence[torch.Tensor]] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """:func:`noise_loss` summed over the octave bands, ``noises[i]`` the
    draw of band ``i`` (smallest first)."""
    t = fft_frequency_decompose(target, min_band_size)
    r = fft_frequency_decompose(recon, min_band_size)
    loss = 0.0
    for i, (k, v) in enumerate(t.items()):
        loss = loss + noise_loss(v, r[k], window_size, step,
                                 None if noises is None else noises[i], generator)
    return loss


def correlation_loss(target: torch.Tensor, recon: torch.Tensor, n_elements: int = 256,
                     noise: Optional[torch.Tensor] = None, indices: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The norm hinge plus ``sum(|cov(noise subset) - cov(residual
    subset)|)`` over ``n_elements`` features: ``indices`` (the first
    ``n_elements`` of a permutation of the features) and ``noise`` are
    drawn from ``generator`` when not given."""
    batch = target.shape[0]
    t_spec = stft_transform(target).reshape(batch, -1)
    r_spec = stft_transform(recon).reshape(batch, -1)
    residual, noise_spec, norm_loss = _noise_and_norms(t_spec, r_spec, 1e-8, noise, generator)
    if indices is None:
        dev = generator.device if generator is not None else t_spec.device
        indices = torch.randperm(t_spec.shape[-1], generator=generator, device=dev)
    indices = indices[:n_elements].to(t_spec.device)
    cov = covariance(noise_spec[:, indices]) - covariance(residual[:, indices])
    return norm_loss + torch.sum(kinks.abs(cov))


class CorrelationLoss:
    """The three losses as methods; each takes its draws or a generator
    after the signals."""

    def __init__(self, n_elements: int = 256):
        self.n_elements = n_elements

    def noise_loss(self, target, recon, window_size=2048, step_size=256, noise=None,
                   generator=None):
        return noise_loss(target, recon, window_size, step_size, noise, generator)

    def multiband_noise_loss(self, target, recon, window_size, step, noises=None,
                             generator=None):
        return multiband_noise_loss(target, recon, window_size, step, noises=noises,
                                    generator=generator)

    def forward(self, target, recon, noise=None, indices=None, generator=None):
        return correlation_loss(target, recon, self.n_elements, noise, indices, generator)

    __call__ = forward
