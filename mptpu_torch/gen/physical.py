"""Physical-modelling helpers (counterpart of ``mptpu/gen/physical.py``):
Gaussian windows and the transfer-function segment generator. Children
carry flax's names."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import no_tf32
from ..nn.init import uniform
from ..nn.linear import LinearOutputStack
from ..nn.upsample import ConvUpsample
from ..ops.fft import irfft, real_ends, rfft
from ..ops.kinks import clip
from ..ops.norms import max_norm
from ..ops.overlap_add import overlap_add
from ..ops.pdf import pdf
from ..ops.upsample import interpolate_last_axis
from ..ops.windows import hamming_window, linspace


def gaussian_window(means: torch.Tensor, stds: torch.Tensor, n_samples: int, mn: float = 0.0,
                    mx: float = 1.0, epsilon: float = 1e-8) -> torch.Tensor:
    """Max-normalised Gaussian windows over [0, 1], one per entry of
    ``means`` / ``stds`` (which broadcast against (1, 1, n_samples))."""
    rng = linspace(0.0, 1.0, n_samples, device=means.device, dtype=means.dtype)
    return max_norm(pdf(rng[None, None, :], mn + means * (mx - mn), epsilon + stds))


class TransferFunctionSegmentGenerator(nn.Module):
    """Latent (batch, model_dim) -> (batch, 1, n_samples): noise excitation
    times a squared envelope (``ConvUpsample_0``), convolved with the
    overlap-added frames of a complex transfer function per frame
    (``ConvUpsample_1``, or with ``cumulative`` one from
    ``LinearOutputStack_0`` cumulated over frames by a complex running
    product), each coefficient's magnitude clipped below 1 so that energy
    cannot grow. ``noise`` is the (1, 1, n_samples) uniform draw in
    [-1, 1)."""

    def __init__(self, model_dim: int, n_frames: int, window_size: int, n_samples: int,
                 cumulative: bool = False, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.model_dim, self.n_frames = model_dim, n_frames
        self.window_size, self.n_samples, self.cumulative = window_size, n_samples, cumulative
        self.n_coeffs = window_size // 2 + 1
        self.ConvUpsample_0 = ConvUpsample(model_dim, model_dim, 4, n_frames, mode="nearest",
                                           out_channels=1, generator=gen, device=device)
        if cumulative:
            self.LinearOutputStack_0 = LinearOutputStack(model_dim, 3,
                                                         out_channels=self.n_coeffs * 2,
                                                         generator=gen, device=device)
        else:
            self.ConvUpsample_1 = ConvUpsample(model_dim, model_dim, 4, n_frames, mode="nearest",
                                               out_channels=self.n_coeffs * 2, generator=gen,
                                               device=device)

    @property
    def noise_shape(self):
        return (1, 1, self.n_samples)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        nc = self.n_coeffs
        x = x.reshape(-1, self.model_dim)
        env = interpolate_last_axis(self.ConvUpsample_0(x) ** 2, self.n_samples)
        if noise is None:
            noise = uniform(self.noise_shape, -1.0, 1.0, generator, x.device)
        env = env * noise.to(x.device, x.dtype)

        if self.cumulative:
            with no_tf32():
                tf = self.LinearOutputStack_0(x)
            tf = tf.reshape(-1, nc * 2, 1).expand(-1, nc * 2, self.n_frames)
        else:
            tf = self.ConvUpsample_1(x)
        tf = tf.reshape(-1, nc, 2, self.n_frames)
        norm = torch.linalg.vector_norm(tf, dim=2, keepdim=True)
        tf = (tf / (norm + 1e-8)) * clip(norm, 0.0, 0.9999)
        tf = tf.reshape(-1, nc * 2, self.n_frames)
        tfc = torch.complex(tf[:, :nc, :], tf[:, nc:, :])
        if self.cumulative:
            tfc = torch.cumprod(tfc, dim=-1)

        # the inverse over the coefficients, frames first: (batch, frames, window)
        t = irfft(real_ends(tfc.transpose(1, 2)), n=self.window_size, norm="ortho")
        t = t.reshape(-1, 1, self.n_frames, self.window_size)
        t = t * hamming_window(self.window_size, dtype=t.dtype, device=t.device)
        t = overlap_add(t)[..., : self.n_samples]
        spec = rfft(env, norm="ortho") * rfft(t, norm="ortho")
        return irfft(real_ends(spec), n=self.n_samples, norm="ortho")
