"""Learned-centroid spectral info losses (counterpart of
``mptpu/losses/infoloss.py``): patches of a spectrogram, their 2-D rFFT
magnitudes unit-normed, embedded and scored against learned centroids; the
loss is the class-weighted cross entropy of the reconstruction's scores
against the target's codes, plus a small term on the patches' norms.

The children carry flax's names (``patch_embed``, ``proj``, ``up``;
``model_{i}``, ``band_{size}``), so ``convert.module_from_flax`` carries
``mptpu``'s trees.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..device import no_tf32
from ..nn.init import uniform_linear
from ..ops.decompose import fft_frequency_decompose
from ..ops.ste import sparse_softmax
from ..ops.stft import stft


def patches2(spec: torch.Tensor, size: Tuple[int, int], step: Tuple[int, int]):
    """(batch, channels, time) -> (magnitudes, their norms, the unit-normed
    magnitudes): patches of ``size`` every ``step`` over the two axes, the
    magnitudes of each patch's 2-D rFFT halved over its first axis (as
    ``jnp.fft.rfft2(p, axes=(-1, -2))``), flattened to (batch, patches,
    (w // 2 + 1) * h). A spectrogram smaller than a patch has none (as in
    ``mptpu``)."""
    batch = spec.shape[0]
    w, h = size
    if spec.shape[1] < w or spec.shape[2] < h:
        p = spec.new_zeros((batch, 0, (w // 2 + 1) * h))
    else:
        p = spec.unfold(1, w, step[0]).unfold(2, h, step[1])   # (batch, n1, n2, w, h)
        p = torch.abs(torch.fft.rfft2(p, dim=(-1, -2))).reshape(batch, -1, (w // 2 + 1) * h)
    norms = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    return p, norms, p / (norms + 1e-12)


class SpectralInfoLoss(nn.Module):
    """(target, recon) -> loss; the three Dense layers uniform +-0.02 with
    zero biases."""

    def __init__(self, stft_window_size: int = 2048, stft_step_size: int = 256,
                 patch_size: Tuple[int, int] = (16, 16), patch_step: Tuple[int, int] = (8, 8),
                 embedding_channels: int = 32, n_centroids: int = 1024,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.stft_window_size, self.stft_step_size = stft_window_size, stft_step_size
        self.patch_size, self.patch_step = tuple(patch_size), tuple(patch_step)
        self.n_centroids = n_centroids
        n_in = (patch_size[0] // 2 + 1) * patch_size[1]
        self.patch_embed = uniform_linear(n_in, embedding_channels, True, 0.02, gen, device)
        self.proj = uniform_linear(embedding_channels, embedding_channels, True, 0.02, gen, device)
        self.up = uniform_linear(embedding_channels, n_centroids, True, 0.02, gen, device)

    def encode(self, signal: torch.Tensor):
        """(one-hot scores, codes, class weights, patch norms, unit-normed
        patches, patches) of ``signal``: audio (batch, 1, n) or a
        spectrogram (batch, frames, coeffs)."""
        start_channels = self.stft_window_size // 2 + 1
        if signal.shape[1] != 1:
            spec = signal.reshape(-1, signal.shape[1], start_channels)
        else:
            frames = signal.shape[-1] // self.stft_step_size
            spec = stft(signal, self.stft_window_size, self.stft_step_size,
                        pad=True).reshape(-1, frames, start_channels)
        raw, norms, normed = patches2(spec, self.patch_size, self.patch_step)
        with no_tf32():
            x = self.up(self.proj(self.patch_embed(normed)))
        one_hot = sparse_softmax(x, normalize=True, axis=-1)
        codes = torch.argmax(x, dim=-1)
        counts = (torch.bincount(codes.reshape(-1), minlength=self.n_centroids) + 1).float()
        # mptpu's 1 / (counts / n) in float32, n as a tensor: CUDA divides by a
        # scalar through its reciprocal, which moved a weight by a place
        weights = 1.0 / (counts / torch.full_like(counts, codes.numel()))
        return one_hot, codes, weights, norms, normed, raw

    def forward(self, target: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        _, tc, tw, tnorms, _, _ = self.encode(target)
        foh, _, _, fnorms, _, _ = self.encode(recon)
        logp = torch.log_softmax(foh.reshape(-1, self.n_centroids), dim=-1)
        labels = tc.reshape(-1)
        picked = torch.gather(logp, 1, labels[:, None])[:, 0]
        w = tw[labels].to(logp.dtype)
        cat_loss = -torch.sum(picked * w) / (torch.sum(w) + 1e-8)
        return cat_loss + torch.mean((fnorms - tnorms.detach()) ** 2) * 1e-3


class MultiWindowSpectralInfoLoss(nn.Module):
    """The sum of :class:`SpectralInfoLoss` (STFT 2048 / 256, 256
    centroids) over ``specs``, pairs of (patch size, patch step)."""

    def __init__(self, specs: Sequence = (((16, 16), (8, 8)),),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.n_specs = len(specs)
        for i, (size, step) in enumerate(specs):
            self.add_module(f"model_{i}", SpectralInfoLoss(
                2048, 256, patch_size=size, patch_step=step, n_centroids=256, generator=gen,
                device=device))

    def forward(self, target, recon):
        total = 0.0
        for i in range(self.n_specs):
            total = total + getattr(self, f"model_{i}")(target, recon)
        return total


class MultiBandSpectralInfoLoss(nn.Module):
    """The sum of :class:`SpectralInfoLoss` (256 centroids) over the octave
    bands ``band_sizes``. A band needs at least 16 frames of
    ``stft_step_size`` for one 16 x 16 patch: at the defaults the 512-sample
    band has 8, no patch, and a loss that is NaN (``mptpu``'s too)."""

    def __init__(self, band_sizes: Sequence[int] = (512, 1024, 2048),
                 stft_window_size: int = 512, stft_step_size: int = 64,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.band_sizes = tuple(band_sizes)
        for size in self.band_sizes:
            self.add_module(f"band_{size}", SpectralInfoLoss(
                stft_window_size, stft_step_size, n_centroids=256, generator=gen, device=device))

    def forward(self, target, recon):
        tb = fft_frequency_decompose(target, min(self.band_sizes))
        rb = fft_frequency_decompose(recon, min(self.band_sizes))
        total = 0.0
        for size in self.band_sizes:
            total = total + getattr(self, f"band_{size}")(tb[size], rb[size])
        return total
