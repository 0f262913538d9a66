"""The resonance-stack overfit (counterpart of ``OverfitResonanceStack`` and
the trainer in ``scripts/resonance_overfit.py``): a learned latent drives a
noise impulse and a chain of resonance blocks that it excites; the loss is
the multiband spectrogram l1 plus 0.01 x the autocorrelation loss plus 0.1
x the decay loss.

``mptpu`` folds the step into its key for each step's impulse noise, a
(1, 4096) uniform draw in [-1, 1) at every size (the impulse is at most
4,096 samples); here the draws are passed in, or come from a generator.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.audioiter import get_one_audio_segment
from ..device import default_device
from ..gen.impulse import GenerateImpulse
from ..gen.transfer import ResonanceChain, make_waves
from ..losses.autocorrelation import AutocorrelationLoss, DecayLoss
from ..losses.multiband_spec import flattened_multiband_spectrogram
from ..nn.init import uniform, uniform_init
from ..ops import kinks
from ..train.optim import Adam, AdamState
from ..utils.music import musical_scale_hz

SPEC = {"s": (64, 16)}


class OverfitResonanceStack(nn.Module):
    """``latent`` (1, 1, latent_dim) -> an impulse of ``min(4096,
    n_samples)`` samples (``GenerateImpulse_0``, 32 channels) zero-padded
    to ``n_samples`` -> a chain (``ResonanceChain_0``) of ``depth`` blocks
    over ``4 * n_atoms`` waves of ``n_atoms`` musical f0s, window 512, 4 mix
    channels, 32 channels -> (1, 1, n_samples). At the script's widths
    (2^15 samples, 128 f0s) it holds 34,090,383 parameters."""

    def __init__(self, n_samples: int, latent_dim: int = 16, depth: int = 2, n_atoms: int = 128,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        self.n_samples, self.latent_dim = n_samples, latent_dim
        self.impulse_samples = min(4096, n_samples)
        self.latent = nn.Parameter(uniform_init((1, 1, latent_dim), 0.1, gen).to(dev))
        self.GenerateImpulse_0 = GenerateImpulse(latent_dim, 32, self.impulse_samples, 16, 1,
                                                 generator=gen, device=dev)
        f0s = musical_scale_hz(start_midi=21, stop_midi=106, n_steps=n_atoms)
        waves = make_waves(n_samples, [float(f) for f in f0s], 22050, device=dev)
        self.ResonanceChain_0 = ResonanceChain(depth, waves.shape[0], 512, n_samples // 256,
                                               n_samples, 4, 32, latent_dim, waves,
                                               generator=gen, device=dev)

    @property
    def noise_shape(self):
        """The shape of one step's impulse noise."""
        return (1, self.impulse_samples)

    def forward(self, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        latent = self.latent.reshape(1, self.latent_dim)
        impulse = self.GenerateImpulse_0(latent, noise, generator).reshape(1, 1, -1)
        impulse = F.pad(impulse, (0, self.n_samples - self.impulse_samples))
        return torch.sum(self.ResonanceChain_0(latent, impulse), dim=1, keepdim=True)


class ResonanceLoss:
    """The script's loss against one target (1, 1, n_samples): the l1 of
    the flattened multiband spectrograms (STFT 64 / 16, bands from 512),
    plus 0.01 x ``AutocorrelationLoss(32, 128)``, plus 0.1 x
    ``DecayLoss(n_samples, 8 decays, window 256)``."""

    def __init__(self, target: torch.Tensor):
        n_samples = target.shape[-1]
        self.target = target
        self.target_spec = flattened_multiband_spectrogram(target, SPEC, 512)
        self.ac = AutocorrelationLoss(n_channels=32, filter_size=128, device=target.device)
        self.dl = DecayLoss(n_samples, n_decays=8, window_size=256, device=target.device)

    def __call__(self, recon: torch.Tensor) -> torch.Tensor:
        spec = torch.sum(kinks.abs(flattened_multiband_spectrogram(recon, SPEC, 512)
                                   - self.target_spec))
        return spec + 0.01 * self.ac(self.target, recon) + 0.1 * self.dl(self.target, recon)


def resonance_step(model: OverfitResonanceStack, adam: Adam, state: AdamState,
                   loss_fn: ResonanceLoss, noise: torch.Tensor):
    """One Adam step in place from the impulse noise ``noise``, nothing
    read on the host. Returns (loss, the new Adam state)."""
    params = list(model.parameters())
    loss = loss_fn(model(noise))
    updates, state = adam.update(torch.autograd.grad(loss, params), state)
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    return loss.detach(), state


class ResonanceRun(NamedTuple):
    model: OverfitResonanceStack
    losses: List[float]        # every step's loss, read once after the loop
    step_starts: List[float]   # host clock at each step's start
    t_end: float               # host clock after the loop (synchronised on a card)


def overfit_resonance(iterations: int = 500, tiny: bool = False,
                      target: Optional[torch.Tensor] = None,
                      noise: Optional[Callable[[int], torch.Tensor]] = None, device=None,
                      log: Callable[[str], None] = print) -> ResonanceRun:
    """``scripts/resonance_overfit.py:main`` with its flags as keywords:
    overfit an :class:`OverfitResonanceStack` (2^15 samples, 2^12 when
    ``tiny``; parameters seeded with 0) to ``target`` (default
    ``get_one_audio_segment(n, 22050, seed=9)``) by optax's Adam at lr
    1e-3, logging every 50th loss. Step ``i``'s impulse noise is
    ``noise(i)``, else a draw from a generator seeded with 0 on the
    device."""
    dev = default_device(device)
    n_samples = 2**12 if tiny else 2**15
    if target is None:
        target = get_one_audio_segment(n_samples, 22050, seed=9, device=dev)
    target = target.reshape(1, 1, -1).to(dev)
    model = OverfitResonanceStack(n_samples, generator=torch.Generator().manual_seed(0),
                                  device=dev)
    loss_fn = ResonanceLoss(target)
    adam = Adam(1e-3)
    state = adam.init(list(model.parameters()))
    noise_gen = torch.Generator(device=dev).manual_seed(0)
    losses, starts = [], []
    t0 = time.perf_counter()
    for i in range(iterations):
        starts.append(time.perf_counter())
        nz = noise(i).to(dev) if noise is not None else uniform(model.noise_shape, -1.0, 1.0,
                                                                 noise_gen)
        loss, state = resonance_step(model, adam, state, loss_fn, nz)
        losses.append(loss)
        if i % 50 == 0:
            log(f"iter {i} loss {float(loss):.2f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    values = torch.stack(losses).tolist() if losses else []
    if values:
        logged = values[::50]
        log(f"done: {iterations} iters in {t_end - t0:.1f}s ({iterations / (t_end - t0):.1f} "
            f"steps/s), loss {logged[0]:.1f} -> {logged[-1]:.1f}")
    return ResonanceRun(model, values, starts, t_end)
