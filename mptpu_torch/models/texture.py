"""Texture synthesis by matching statistics (counterpart of
``scripts/texture.py``): the raw waveform is the parameter, max-normed on
render, fitted by Adam so that its gammatone-envelope texture statistics
(``features="texture"``) or its first- and second-order scattering
coefficients over 64 geometric gammatone filters of 128 taps
(``features="scattering"``) match a target segment's; progress goes to an
``obs.Collection`` dashboard."""

from __future__ import annotations

import os
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..data.audioiter import get_one_audio_segment
from ..device import default_device
from ..obs.collection import Collection
from ..ops import kinks
from ..ops.norms import max_norm
from ..perceptual.gammatone import gammatone_filter_bank
from ..perceptual.scattering import scattering_transform
from ..perceptual.texture import AudioTextureFeatures
from ..train.optim import Adam, AdamState
from ..utils.wav import write_wav


def texture_featurizer(features: str, n_samples: int, tiny: bool = False,
                       device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The script's feature of (batch, 1, n_samples) audio, (batch, -1):
    ``"texture"`` (64 filters of 64 taps, 16 when ``tiny``) or
    ``"scattering"`` (64 filters of 128 taps, 16 when ``tiny``)."""
    dev = default_device(device)
    n_filters = 16 if tiny else 64
    if features == "texture":
        return AudioTextureFeatures(n_samples, n_filters=n_filters, filter_size=64,
                                    min_band_size=min(512, n_samples), device=dev)
    if features != "scattering":
        raise ValueError(f"features is texture or scattering, not {features!r}")
    bank = torch.from_numpy(gammatone_filter_bank(n_filters, 128,
                                                  band_spacing="geometric")).to(dev)

    def featurize(x):
        c1, c2 = scattering_transform(x.reshape(x.shape[0], -1), bank)
        return torch.cat([c1.reshape(x.shape[0], -1), c2.reshape(x.shape[0], -1)], dim=-1)

    return featurize


def texture_loss(params: torch.Tensor, featurize: Callable,
                 target_features: torch.Tensor) -> torch.Tensor:
    """``sum(|featurize(max_norm(params)) - target_features|)``."""
    return kinks.abs(featurize(max_norm(params)) - target_features).sum()


def texture_step(params: torch.Tensor, adam: Adam, state: AdamState, featurize: Callable,
                 target_features: torch.Tensor):
    """One Adam step of the waveform in place, nothing read on the host.
    Returns (loss, the new Adam state)."""
    loss = texture_loss(params, featurize, target_features)
    updates, state = adam.update(torch.autograd.grad(loss, [params]), state)
    with torch.no_grad():
        params.add_(updates[0])
    return loss.detach(), state


class TextureRun(NamedTuple):
    params: torch.Tensor       # the fitted waveform (before max_norm)
    losses: List[float]        # every step's loss, read once after the loop
    step_starts: List[float]   # host clock at each step's start
    t_end: float               # host clock after the loop (synchronised on a card)


def synthesize_texture(iterations: int = 1000, lr: float = 1e-3, tiny: bool = False,
                       features: str = "texture", out: Optional[str] = "trained_weights/texture",
                       log_every: int = 50, target: Optional[torch.Tensor] = None,
                       init: Optional[torch.Tensor] = None, device=None,
                       log: Callable[[str], None] = print) -> TextureRun:
    """``scripts/texture.py:main`` with its flags as keywords: 2^17 samples
    (2^12 when ``tiny``); ``target`` defaults to the max-normed
    ``get_one_audio_segment(n, seed=5)``, ``init`` (the waveform's start)
    to 0.01 x a standard normal draw from a CPU generator seeded with 0.
    With ``out``: the dashboard under ``out/dashboard`` (target, recon and
    losses every ``log_every`` steps), ``recon.wav`` and ``target.wav``."""
    dev = default_device(device)
    n_samples = 2**12 if tiny else 2**17
    if target is None:
        target = max_norm(get_one_audio_segment(n_samples, seed=5, device=dev))
    target = target.reshape(1, 1, -1).to(dev)
    featurize = texture_featurizer(features, n_samples, tiny, dev)
    target_features = featurize(target)
    if init is None:
        init = torch.randn(target.shape, generator=torch.Generator().manual_seed(0)) * 0.01
    params = init.detach().clone().to(dev).requires_grad_()
    adam = Adam(lr)
    state = adam.init([params])
    collection = Collection(os.path.join(out, "dashboard")) if out else None
    if collection is not None:
        os.makedirs(out, exist_ok=True)
        collection.log("target", target[0, 0], kind="audio")
    losses, logged, starts = [], [], []
    t0 = time.perf_counter()
    for i in range(iterations):
        starts.append(time.perf_counter())
        loss, state = texture_step(params, adam, state, featurize, target_features)
        losses.append(loss)
        if i % log_every == 0:
            logged.append(float(loss))
            log(f"iter {i} loss {logged[-1]:.2f}")
            if collection is not None:
                collection.log("recon", max_norm(params.detach())[0, 0], kind="audio")
                collection.log("loss", np.asarray(logged))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    if out:
        write_wav(os.path.join(out, "recon.wav"), max_norm(params.detach())[0, 0].cpu().numpy(),
                  22050)
        write_wav(os.path.join(out, "target.wav"), target[0, 0].cpu().numpy(), 22050)
    values = torch.stack(losses).tolist() if losses else []
    if values:
        log(f"done: {iterations} iters in {t_end - t0:.1f}s, loss {values[0]:.1f} -> "
            f"{values[-1]:.1f}")
    return TextureRun(params.detach(), values, starts, t_end)
