"""The textural model, a binary tree of latent splitters that doubles one
root latent into ``n_events`` event latents, each with hierarchical-dirac
time logits, decoded to atom mixtures placed by FFT convolution
(counterpart of ``mptpu/models/textural.py``), and its overfit trainer
(``scripts/textural.py``: an STFT l1 loss plus the confidence loss)."""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, List, NamedTuple

import numpy as np
import torch
from torch import nn

from ..data.synthetic import synthetic_audio
from ..device import default_device, no_tf32
from ..gen.schedule import hierarchical_dirac
from ..gen.transfer import fft_convolve_correlation
from ..nn.init import uniform_linear, uniform_range_init
from ..ops import kinks
from ..ops.stft import stft
from ..ops.upsample import ensure_last_axis_length
from ..train.optim import Adam, AdamState
from ..utils.wav import write_wav


class Splitter(nn.Module):
    """Double the event axis: each event gives ``branching_factor``
    children, their time logits the parent's plus ``Dense_0(x) * scale``
    (no bias) and their latents ``Dense_1(x) * scale``; both Dense layers
    uniform +-0.02."""

    def __init__(self, latent_dim: int, time_dim: int, branching_factor: int = 2,
                 scale: float = 1.0, generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.time_dim, self.branching_factor, self.scale = time_dim, branching_factor, scale
        self.Dense_0 = uniform_linear(latent_dim, branching_factor * time_dim * 2, False, 0.02,
                                      gen, device)
        self.Dense_1 = uniform_linear(latent_dim, latent_dim * branching_factor, True, 0.02,
                                      gen, device)

    def forward(self, x: torch.Tensor, base_time: torch.Tensor):
        """x (batch, n_events, latent), base_time (batch, n_events,
        time_dim, 2) -> (offsets, split), their event axis doubled."""
        batch, n_events, latent_dim = x.shape
        bf = self.branching_factor
        with no_tf32():
            to = self.Dense_0(x).reshape(batch, n_events, bf, self.time_dim, 2)
            split = self.Dense_1(x) * self.scale
        offsets = (base_time[:, :, None] + to * self.scale).reshape(
            batch, n_events * bf, self.time_dim, 2)
        return offsets, split.reshape(batch, n_events * bf, latent_dim)


class TexturalModel(nn.Module):
    """Root latent -> ``log2(n_events)`` splitters -> atoms (``Dense_0`` of
    the latents times the learned ``atoms``, scaled by ``Dense_1``) placed
    by soft hierarchical diracs. ``forward()`` gives (audio (1, 1,
    n_samples), the choices (1, n_events, log2(n_samples), 2))."""

    def __init__(self, n_samples: int = 2**17, n_events: int = 128, n_atoms: int = 32,
                 atom_size: int = 512, latent_dim: int = 16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        self.n_samples = n_samples
        self.total_layers = int(math.log2(n_events))
        self.time_dim = int(math.log2(n_samples))
        self.base_latent = nn.Parameter(
            uniform_range_init((1, latent_dim), -0.01, 0.01, gen).to(dev))
        self.atoms = nn.Parameter(uniform_range_init((n_atoms, atom_size), -1.0, 1.0, gen).to(dev))
        for i in range(self.total_layers):
            self.add_module(f"Splitter_{i}", Splitter(latent_dim, self.time_dim, 2, 1.0 / (i + 1),
                                                      gen, dev))
        self.Dense_0 = uniform_linear(latent_dim, n_atoms, True, 0.02, gen, dev)
        self.Dense_1 = uniform_linear(latent_dim, 1, True, 0.02, gen, dev)

    def forward(self):
        x = self.base_latent[:, None, :]
        base_times = torch.zeros(1, 1, self.time_dim, 2, device=x.device, dtype=x.dtype)
        for i in range(self.total_layers):
            base_times, x = getattr(self, f"Splitter_{i}")(x, base_times)
        with no_tf32():
            event_atoms = self.Dense_0(x) @ self.atoms
            amps = self.Dense_1(x)
        event_atoms = ensure_last_axis_length(event_atoms, self.n_samples) * amps
        scheduled, logits = hierarchical_dirac(base_times, soft=True, return_logits=True)
        placed = fft_convolve_correlation(event_atoms, scheduled)
        return torch.sum(placed, dim=1, keepdim=True), logits


def confidence_loss(logits: torch.Tensor) -> torch.Tensor:
    """``sum(|1 - max(choice)|)``: pushes every soft binary choice towards
    a hard one. ``torch.amax`` splits a tie's gradient evenly, as
    ``jnp.max`` does."""
    return torch.sum(kinks.abs(1.0 - torch.amax(logits, dim=-1)))


def textural_loss(model: TexturalModel, target_spec: torch.Tensor,
                  confidence_weight: float = 0.5):
    """The script's loss: the l1 distance of ``stft(recon, 2048, 256,
    pad=True)`` from the target's, plus ``confidence_weight`` times the
    confidence loss. Returns (loss, recon)."""
    recon, logits = model()
    spec = stft(recon, 2048, 256, pad=True)
    return (torch.sum(kinks.abs(spec - target_spec))
            + confidence_weight * confidence_loss(logits)), recon


def textural_step(model: TexturalModel, adam: Adam, state: AdamState, target_spec: torch.Tensor,
                  confidence_weight: float = 0.5):
    """One Adam step in place, nothing read on the host. Returns (loss,
    recon, the new Adam state)."""
    params = list(model.parameters())
    loss, recon = textural_loss(model, target_spec, confidence_weight)
    updates, state = adam.update(torch.autograd.grad(loss, params), state)
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    return loss.detach(), recon.detach(), state


SMOKE = dict(n_samples=2**12, n_events=8, n_atoms=8, atom_size=128)


class TexturalRun(NamedTuple):
    model: TexturalModel
    losses: List[float]        # every step's loss, read once after the loop
    step_starts: List[float]   # host clock at each step's start
    t_end: float               # host clock after the loop (synchronised on a card)


def textural_target(n_samples: int, seed: int = 0) -> np.ndarray:
    """The script's target: ``synthetic_audio`` at 22,050 Hz with 8 events
    a second (at least 4)."""
    return synthetic_audio(n_samples, 22050, n_events=max(4, int(n_samples / 22050 * 8)),
                           seed=seed)


def train_textural(iterations: int = 2000, n_samples: int = 2**16, n_events: int = 64,
                   n_atoms: int = 64, atom_size: int = 2048, latent_dim: int = 16,
                   lr: float = 1e-3, confidence_weight: float = 0.5, seed: int = 0,
                   out: str | None = "trained_weights/textural", smoke: bool = False,
                   device=None,
                   log: Callable[[str], None] = print) -> TexturalRun:
    """``scripts/textural.py:main`` with its flags as keywords (``smoke``
    its ``--smoke`` sizes): overfit a :class:`TexturalModel` (seeded with
    ``seed``) to :func:`textural_target` by optax's Adam; with ``out``,
    ``target.wav``, ``recon.wav`` and ``metrics.json`` written there."""
    dev = default_device(device)
    if smoke:
        n_samples, n_events = SMOKE["n_samples"], SMOKE["n_events"]
        n_atoms, atom_size = SMOKE["n_atoms"], SMOKE["atom_size"]
    seg = textural_target(n_samples, seed)
    target = torch.from_numpy(seg).reshape(1, 1, -1).to(dev)
    model = TexturalModel(n_samples, n_events, n_atoms, atom_size, latent_dim,
                          torch.Generator().manual_seed(seed), dev)
    adam = Adam(lr)
    state = adam.init(list(model.parameters()))
    tspec = stft(target, 2048, 256, pad=True)
    losses, logged, starts, recon = [], [], [], None
    t0 = time.perf_counter()
    for i in range(iterations):
        starts.append(time.perf_counter())
        loss, recon, state = textural_step(model, adam, state, tspec, confidence_weight)
        losses.append(loss)
        if i % 25 == 0:
            logged.append([i, round(float(loss), 2)])
            log(f"iter {i} loss {float(loss):.2f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    elapsed = t_end - t0
    if out:
        os.makedirs(out, exist_ok=True)
        write_wav(os.path.join(out, "target.wav"), seg, 22050)
        if recon is not None:
            r = recon[0, 0].cpu().numpy()
            write_wav(os.path.join(out, "recon.wav"), r / (np.abs(r).max() + 1e-9), 22050)
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump({"losses": logged, "steps_per_s": iterations / max(elapsed, 1e-9)}, f,
                      indent=1)
    log(f"done in {elapsed:.1f}s")
    return TexturalRun(model, torch.stack(losses).tolist() if losses else [], starts, t_end)
