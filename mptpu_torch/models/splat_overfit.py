"""The audio-splatting overfit, BASELINE #3 (counterpart of
``mptpu/models/splat_overfit.py`` and of ``overfit_splat`` in
``scripts/splat.py``): 64 events whose vectors and binary-tree times grow
by splitting, decoded by the ``SplattingEventGenerator`` and fit to one
segment with a multi-resolution spectrogram loss; after the fit, the
script's demonstration of manipulable events (the two root vectors
perturbed) and its HTML article (:func:`splat_article`).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..device import default_device
from ..gen.splat import SplattingEventGenerator
from ..losses.iterative import iterative_loss
from ..losses.multiband_spec import flattened_multiband_spectrogram
from ..nn.init import uniform, uniform_init
from ..nn.multihead import MultiHeadTransform
from ..obs.article import AudioComponent, ImageComponent, conjure_article
from ..ops import kinks, max_norm, stft
from ..train.optim import make_train_step, optimizer


def splat_loss_transform(x: torch.Tensor) -> torch.Tensor:
    """The splat loss's feature: bands from 512 samples up, each by an STFT
    of window 64, step 16, flattened."""
    return flattened_multiband_spectrogram(x, stft_spec={"short": (64, 16)}, smallest_band_size=512)


def splat_loss(recon: torch.Tensor, target: torch.Tensor, use_iterative_loss: bool = False,
               target_feature: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``scripts/splat.py``'s loss of rendered events (1, n_events, n)
    against the target (1, 1, n): the l1 distance of the features of the
    events' sum, or the iterative loss over the events. ``target_feature``
    is ``splat_loss_transform(target)`` when the caller has it."""
    if use_iterative_loss:
        return iterative_loss(target, recon, splat_loss_transform)
    if target_feature is None:
        target_feature = splat_loss_transform(target)
    return torch.sum(kinks.abs(target_feature - splat_loss_transform(recon.sum(1, keepdim=True))))


class OverfitHierarchicalEvents(nn.Module):
    """Event vectors and times grown by binary splitting. ``forward(noise=None,
    perturb=None, generator=None)`` returns (events (1, n_events, n_samples),
    vectors, times); the noise is drawn from ``generator`` when not given.

    Parameters carry flax's names and shapes: ``event_vectors`` (1, 2, C),
    ``times`` (1, 2, log2(n_samples), 2), ``hier_event_vectors_i`` and
    ``hier_time_vectors_i`` per level, uniform in [-0.1, 0.1) from
    ``init_generator`` (a CPU generator, default seed 0), as are the
    ``transform`` heads' and the ``decoder`` reverb's weights."""

    def __init__(self, n_samples: int, samplerate: int, n_events: int, context_dim: int,
                 init_generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = default_device(device)
        gen = init_generator or torch.Generator().manual_seed(0)
        self.n_samples = n_samples
        self.context_dim = context_dim
        self.event_levels = int(np.log2(n_events))
        total_levels = int(np.log2(n_samples))

        def param(shape):
            return nn.Parameter(uniform_init(shape, 0.1, gen).to(dev))

        self.event_vectors = param((1, 2, context_dim))
        self.times = param((1, 2, total_levels, 2))
        for i in range(self.event_levels - 1):
            self.register_parameter(f"hier_event_vectors_{i}", param((1, 2, context_dim)))
            self.register_parameter(f"hier_time_vectors_{i}",
                                    param((1, 2 ** (i + 2), total_levels, 2)))
        self.decoder = SplattingEventGenerator(
            n_samples=n_samples, samplerate=samplerate, n_resonance_octaves=16,
            n_frames=n_samples // 256, hard_reverb_choice=False, hierarchical_scheduler=True,
            wavetable_resonance=False, init_generator=gen, device=dev)
        self.transform = MultiHeadTransform(context_dim, hidden_channels=128,
                                            shapes=self.decoder.shape_spec, n_layers=1,
                                            generator=gen, device=dev)

    def forward(self, noise: Optional[torch.Tensor] = None, perturb: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None):
        c = self.context_dim
        events, times = self.event_vectors, self.times
        if perturb is not None:
            events = events + perturb
        for i in range(self.event_levels - 1):
            hier_ev = getattr(self, f"hier_event_vectors_{i}")
            events = (events.reshape(1, -1, 1, c) + hier_ev.reshape(1, 1, 2, c)).reshape(1, -1, c)
            times = times.repeat_interleave(2, dim=1) + getattr(self, f"hier_time_vectors_{i}")
        rendered = self.decoder(self.transform(events), times, noise=noise, generator=generator)
        return rendered, events, times


class SplatFit(NamedTuple):
    model: OverfitHierarchicalEvents
    losses: List[float]      # every step's loss, warm-up steps first
    steps_per_sec: float     # over the timed steps, host clock
    skipped: int             # steps whose non-finite loss the guard skipped


def overfit_splat(target, n_events: int = 64, event_dim: int = 16, n_iterations: int = 3000,
                  lr: float = 1e-3, use_iterative_loss: bool = False, samplerate: int = 22050,
                  warmup: int = 0, device=None, generator: torch.Generator | None = None,
                  init_generator: torch.Generator | None = None) -> SplatFit:
    """Fit an ``OverfitHierarchicalEvents`` to ``target`` (n_samples values,
    a numpy array or a tensor) with Adam (lr, betas 0.9, 0.999) and the NaN
    guard, as ``scripts/splat.py`` does; the noise is drawn anew at every
    step from ``generator`` (one on the device; default seed 0). ``warmup``
    steps run first, then ``n_iterations`` steps on the host clock, ending
    in a synchronisation on a card."""
    dev = default_device(device)
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.asarray(target, dtype=np.float32))
    target = target.to(dev, torch.float32).reshape(1, 1, -1)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    model = OverfitHierarchicalEvents(target.shape[-1], samplerate, n_events, event_dim,
                                      init_generator=init_generator, device=dev)
    with torch.no_grad():
        target_feature = splat_loss_transform(target)

    def loss_fn():
        recon, _, _ = model(generator=gen)
        return splat_loss(recon, target, use_iterative_loss, target_feature)

    step = make_train_step(loss_fn, optimizer(model.parameters(), lr=lr, b1=0.9, b2=0.999))
    losses = [float(step()) for _ in range(warmup)]
    t0 = time.perf_counter()
    losses += [float(step()) for _ in range(n_iterations)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    skipped = sum(not np.isfinite(v) for v in losses)
    return SplatFit(model, losses, n_iterations / elapsed, skipped)


class SplatDemo(NamedTuple):
    recon: torch.Tensor       # (1, 1, n) the events' sum, max-normed
    perturbed: torch.Tensor   # (1, 1, n) the same with the root vectors perturbed, max-normed
    perturb: torch.Tensor     # (1, 2, event_dim) the perturbation
    spectrogram: np.ndarray   # (coeffs, frames) the reconstruction's STFT, 512 / 256


def splat_article(fit: SplatFit, target, article_path: Optional[str] = None,
                  perturb: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                  samplerate: int = 22050, n_iterations: Optional[int] = None) -> SplatDemo:
    """``scripts/splat.py``'s demonstration after the fit: the fitted
    events' sum and the same events with the two root vectors moved by
    ``perturb`` (1, 2, event_dim), both rendered with one ``noise`` draw
    (1, 1, n) and max-normed; with ``article_path``, the article (original,
    reconstruction, perturbed, the reconstruction's spectrogram) written
    there. ``perturb`` and ``noise`` are drawn from a generator on the
    model's device seeded 99 when None: uniform in [-0.5, 0.5) and [-1,
    1). ``n_iterations`` names the fit's length in the article (the
    fit's timed steps by default)."""
    model = fit.model
    dev = model.event_vectors.device
    gen = torch.Generator(device=dev).manual_seed(99)
    if perturb is None:
        perturb = uniform((1, 2, model.context_dim), -0.5, 0.5, gen)
    if noise is None:
        noise = uniform((1, 1, model.n_samples), -1.0, 1.0, gen)
    perturb, noise = perturb.to(dev), noise.to(dev)
    with torch.no_grad():
        recon = max_norm(model(noise=noise)[0].sum(1, keepdim=True))
        perturbed = max_norm(model(noise=noise, perturb=perturb)[0].sum(1, keepdim=True))
    spec = stft(recon, 512, 256, pad=True)[0, 0].T.cpu().numpy()
    if article_path:
        if isinstance(target, torch.Tensor):
            target = target.detach().cpu().numpy()
        target = np.asarray(target, dtype=np.float32).reshape(-1)
        iterations = len(fit.losses) if n_iterations is None else n_iterations
        conjure_article(
            article_path,
            "Audio Splatting With Physics-Inspired Event Generators",
            [
                AudioComponent(target, samplerate, "Original"),
                AudioComponent(recon[0, 0].cpu().numpy(), samplerate, "Reconstruction"),
                AudioComponent(perturbed[0, 0].cpu().numpy(), samplerate,
                               "Perturbed event vectors"),
                ImageComponent(spec, "Reconstruction spectrogram"),
            ],
            intro_markdown=(
                f"# Audio splatting\n{2 ** model.event_levels} events fit for "
                f"{iterations} iterations at {fit.steps_per_sec:.1f} steps/sec."
            ),
        )
    return SplatDemo(recon, perturbed, perturb, spec)
