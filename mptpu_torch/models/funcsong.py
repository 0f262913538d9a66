"""The functional song, a network from absolute song position to audio
decoded through three chained banks of closed-form oscillators
(counterpart of ``mptpu/models/funcsong.py``), and its trainer
(``scripts/funcsong.py``: random crops of a synthetic song, their
absolute-position encodings, an STFT l1 loss).

As in ``mptpu``, the oscillator has no exponential decay (the energy
envelope supplies it), and each bank's tension is modulated by the bank
before it item by item. Its phases ``omega t`` reach 3e5 rad (``omega`` up
to ``sqrt(10^9)`` over ten units of time): float32 keeps about 0.03 rad of
such a phase and ``10^tension`` amplifies one place of the tension to
0.3 rad, so two float32 implementations (``mptpu``'s jitted forward and
this one, or either and float64) give audio that differs by about half
its peak. Only float64 holds the two packages to each other.

The position encoding takes ``sin(t * f)`` with ``f`` up to half the
song's samples: for a 30 s song the arguments reach about 2e6 rad, where
float32 keeps no digit of the phase. ``mptpu``'s jitted and eager forms
of it differ by up to 0.249 there, and the port's is a third float32
rounding; it agrees with ``mptpu``'s where the song is short.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.synthetic import synthetic_audio
from ..device import default_device, no_tf32
from ..nn.init import flax_linear, uniform_range_init
from ..ops import kinks
from ..ops.stft import stft
from ..ops.windows import linspace
from ..train.optim import Adam, AdamState
from ..utils.wav import write_wav


class DampedOscillatorBank(nn.Module):
    """One bank of oscillators: ``a * energy * cos(omega t - phi)`` on ten
    units of time, with ``omega = sqrt(|10^tension - x^2|)``, ``x =
    damping / (2 mass)`` (mass ``2 sigmoid``, damping ``30 sigmoid`` of the
    parameters), ``phi = atan2(x d0, d0 omega)`` and ``a = d0 / cos(phi)``,
    times ``amplitudes`` and summed over the oscillators."""

    def __init__(self, n_samples: int, n_oscillators: int, n_resonances: int, expressivity: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        shape = (1, n_oscillators, n_resonances, expressivity)
        self.n_samples = n_samples

        def param(lo, hi, s=shape):
            return nn.Parameter(uniform_range_init(s, lo, hi, gen).to(dev))

        self.damping = param(0.5, 1.5)
        self.mass = param(-2.0, 2.0)
        self.tension = param(4.0, 9.0)
        self.initial_displacement = param(-1.0, 2.0)
        self.amplitudes = param(-1.0, 1.0, shape + (1,))

    def forward(self, energy: torch.Tensor, tension_modifier: Optional[torch.Tensor] = None,
                scaling: Optional[torch.Tensor] = None) -> torch.Tensor:
        """energy (batch, 1, n_resonances, 1, n_samples) -> (batch, 1,
        n_resonances, expressivity, n_samples)."""
        time_ = linspace(0.0, 10.0, self.n_samples, device=energy.device,
                         dtype=energy.dtype).reshape(1, 1, 1, 1, -1)
        t = self.tension[..., None]
        if tension_modifier is not None:
            t = t + tension_modifier * scaling
        mass = torch.sigmoid(self.mass[..., None]) * 2.0
        damping = torch.sigmoid(self.damping[..., None]) * 30.0
        d0 = self.initial_displacement[..., None]
        x = damping / (2.0 * mass)
        omega = torch.sqrt(kinks.abs(torch.pow(10.0, t) - x**2))
        phi = torch.atan2(x * d0, d0 * omega)
        a = d0 / torch.cos(phi)
        z = a * energy * torch.cos(omega * time_ - phi) * self.amplitudes
        return torch.sum(z, dim=1, keepdim=True)


class OscillatorStack(nn.Module):
    """Three banks, the second's tension moved by the first's output times
    ``influence`` and the third's by the second's times ``influence2``,
    mixed by a softmax over the three (``mix``)."""

    def __init__(self, n_samples: int, n_oscillators: int, n_resonances: int, expressivity: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        kw = (n_samples, n_oscillators, n_resonances, expressivity, gen, dev)
        self.dho1 = DampedOscillatorBank(*kw)
        self.dho2 = DampedOscillatorBank(*kw)
        self.dho3 = DampedOscillatorBank(*kw)
        ishape = (n_oscillators, n_resonances, expressivity, 1)
        self.influence = nn.Parameter(uniform_range_init(ishape, -0.01, 0.01, gen).to(dev))
        self.influence2 = nn.Parameter(uniform_range_init(ishape, -0.01, 0.01, gen).to(dev))
        self.mix = nn.Parameter(uniform_range_init((1, 1, n_resonances, expressivity, 1, 3),
                                                   -1.0, 1.0, gen).to(dev))

    def forward(self, energy: torch.Tensor) -> torch.Tensor:
        x1 = self.dho1(energy)
        x2 = self.dho2(energy, x1, self.influence)
        x3 = self.dho3(energy, x2, self.influence2)
        outputs = torch.stack([x1, x2, x3], dim=-1)
        return torch.sum(outputs * torch.softmax(self.mix, dim=-1), dim=-1)


class ResidualSeluLayer(nn.Module):
    """``x + selu(Dense_0(x))``, the Dense at flax's default."""

    def __init__(self, channels: int, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.Dense_0 = flax_linear(channels, channels, True,
                                   generator or torch.Generator().manual_seed(0), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return x + F.selu(self.Dense_0(x))


class FuncSong(nn.Module):
    """pos (batch, in_channels, segment) -> audio (batch, 1, segment):
    ``Dense_0``, ``n_layers`` residual SELU layers, ``|Dense_1|`` as each
    resonance's energy, and the oscillator stack (2 oscillators, one
    expression), summed over the resonances."""

    def __init__(self, segment_size: int, in_channels: int, hidden_channels: int, n_layers: int,
                 n_resonances: int = 64, generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.segment_size, self.n_layers, self.n_resonances = segment_size, n_layers, n_resonances
        self.Dense_0 = flax_linear(in_channels, hidden_channels, True, gen, device)
        for i in range(n_layers):
            self.add_module(f"ResidualSeluLayer_{i}", ResidualSeluLayer(hidden_channels, gen,
                                                                        device))
        self.Dense_1 = flax_linear(hidden_channels, n_resonances, True, gen, device)
        self.OscillatorStack_0 = OscillatorStack(segment_size, 2, n_resonances, 1, gen, device)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        batch = pos.shape[0]
        with no_tf32():
            x = self.Dense_0(pos.transpose(1, 2))
        for i in range(self.n_layers):
            x = getattr(self, f"ResidualSeluLayer_{i}")(x)
        with no_tf32():
            e = kinks.abs(self.Dense_1(x))   # (batch, time, resonances)
        e = e.transpose(1, 2).reshape(batch, 1, self.n_resonances, 1, self.segment_size)
        d = self.OscillatorStack_0(e).reshape(batch, self.n_resonances, self.segment_size)
        return torch.sum(d, dim=1, keepdim=True)


def song_pos_encoding(start_sample, n_segment_samples: int, total_samples: int,
                      n_channels: int, device=None) -> torch.Tensor:
    """Absolute-position sin / cos features of crops, float32, as
    ``mptpu``'s eager form computes them: ``n_channels // 2`` frequencies
    from 1 to ``total_samples // 2`` cycles a song over each crop's phase
    range. ``start_sample`` is an int or an integer tensor of starts
    (batch,); the result is (n_channels, n) or (batch, n_channels, n), on
    the starts' device (``default_device(device)`` for an int)."""
    if not isinstance(start_sample, torch.Tensor):
        start_sample = torch.tensor(start_sample, device=default_device(device))
    s = start_sample.to(torch.int32)
    dev = s.device
    factor = 2.0 * math.pi
    start = s.to(torch.float32) / total_samples
    end = (s + n_segment_samples).to(torch.float32) / total_samples
    grid = linspace(0.0, 1.0, n_segment_samples, device=dev)
    t = (start[..., None] * factor + (end - start)[..., None] * factor * grid)[..., None, :]
    freqs = linspace(1.0, total_samples // 2, n_channels // 2, device=dev)[:, None]
    return torch.cat([torch.sin(t * freqs), torch.cos(t * freqs)], dim=-2)


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def funcsong_loss(model: FuncSong, target: torch.Tensor, pos: torch.Tensor):
    """The script's loss: the l1 distance of ``stft(recon, 2048, 256,
    pad=True)`` from the target crops'. Returns (loss, recon)."""
    recon = model(pos)
    r = stft(recon, 2048, 256, pad=True)
    t = stft(target, 2048, 256, pad=True)
    return torch.sum(kinks.abs(r - t)), recon


def crop_batch(song: torch.Tensor, starts: torch.Tensor, segment_samples: int,
               pos_channels: int):
    """The crops (batch, 1, n) of ``song`` (a tensor on the training
    device) at ``starts`` (batch,), and their position encodings."""
    idx = starts.to(song.device)[:, None] + torch.arange(segment_samples, device=song.device)
    pos = song_pos_encoding(starts.to(song.device), segment_samples, song.shape[-1],
                            pos_channels)
    return song[idx][:, None, :], pos


def funcsong_step(model: FuncSong, adam: Adam, state: AdamState, target: torch.Tensor,
                  pos: torch.Tensor):
    """One Adam step in place, nothing read on the host. Returns (loss,
    recon, the new Adam state)."""
    params = list(model.parameters())
    loss, recon = funcsong_loss(model, target, pos)
    updates, state = adam.update(torch.autograd.grad(loss, params), state)
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    return loss.detach(), recon.detach(), state


SMOKE = dict(segment_samples=2**11, pos_channels=8, hidden=32, layers=2, batch_size=2)


class FuncSongRun(NamedTuple):
    model: FuncSong
    n_params: int
    total_samples: int
    losses: List[float]        # every step's loss, read once after the loop
    step_starts: List[float]   # host clock at each step's start
    t_end: float               # host clock after the loop (synchronised on a card)


def funcsong_song(song_seconds: float = 30.0, seed: int = 0, samplerate: int = 22050):
    """The script's default song: ``synthetic_audio`` of ``song_seconds``
    with 4 events a second over sustained tones."""
    return synthetic_audio(int(song_seconds * samplerate), samplerate,
                           n_events=int(song_seconds * 4), seed=seed, sustained=True)


def train_funcsong(song_seconds: float = 30.0, iterations: int = 2000, batch_size: int = 4,
                   segment_samples: int = 2**15, pos_channels: int = 256, hidden: int = 256,
                   layers: int = 4, lr: float = 1e-3, seed: int = 0,
                   out: str | None = "trained_weights/funcsong", smoke: bool = False,
                   device=None,
                   log: Callable[[str], None] = print) -> FuncSongRun:
    """``scripts/funcsong.py:main`` with its flags as keywords (``smoke``
    its ``--smoke`` sizes; the synthetic song, there being no ``--path``):
    fit a :class:`FuncSong` (seeded with ``seed``) by optax's Adam on crops
    whose starts ``np.random.default_rng(seed)`` draws, as the script does;
    with ``out``, ``recon_crop.wav`` and ``metrics.json`` written there."""
    dev = default_device(device)
    if smoke:
        segment_samples, pos_channels = SMOKE["segment_samples"], SMOKE["pos_channels"]
        hidden, layers, batch_size = SMOKE["hidden"], SMOKE["layers"], SMOKE["batch_size"]
    song = funcsong_song(song_seconds, seed)
    total = len(song)
    song_t = torch.from_numpy(song).to(dev)
    model = FuncSong(segment_samples, pos_channels, hidden, layers,
                     generator=torch.Generator().manual_seed(seed), device=dev)
    n_params = count_parameters(model)
    ratio = n_params / total
    log(f"{n_params} params / {total} samples = compression ratio {ratio:.2f}")
    adam = Adam(lr)
    state = adam.init(list(model.parameters()))
    rng = np.random.default_rng(seed)
    losses, logged, starts_t, recon = [], [], [], None
    t0 = time.perf_counter()
    for i in range(iterations):
        starts_t.append(time.perf_counter())
        starts = torch.from_numpy(rng.integers(0, total - segment_samples, size=batch_size))
        target, pos = crop_batch(song_t, starts, segment_samples, pos_channels)
        loss, recon, state = funcsong_step(model, adam, state, target, pos)
        losses.append(loss)
        if i % 25 == 0:
            logged.append([i, round(float(loss), 2)])
            log(f"iter {i} loss {float(loss):.2f} ratio {ratio:.2f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    elapsed = t_end - t0
    if out:
        os.makedirs(out, exist_ok=True)
        if recon is not None:
            write_wav(os.path.join(out, "recon_crop.wav"), recon[0, 0].cpu().numpy(), 22050)
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump({"n_params": n_params, "total_samples": total, "compression_ratio": ratio,
                       "losses": logged, "steps_per_s": iterations / max(elapsed, 1e-9)}, f,
                      indent=1)
    log(f"done in {elapsed:.1f}s")
    return FuncSongRun(model, n_params, total, torch.stack(losses).tolist() if losses else [],
                       starts_t, t_end)
