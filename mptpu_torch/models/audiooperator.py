"""The audio operator, a neural operator from an event's symbolic
parameters (start, duration, envelope, latent) to its rasterised audio,
trained on endless synthetic gamma envelopes (counterpart of
``mptpu/models/audiooperator.py``), and its trainer
(``scripts/audiooperator.py``, with its ``--overfit`` branch).

The rasterisation is ``mptpu``'s: each output sample gathers the envelope
at its coordinate within the event, one expression over the whole
(batch, resolution) grid.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device, no_tf32
from ..nn.init import uniform_linear
from ..nn.linear import LinearOutputStack
from ..ops import kinks
from ..ops.pdf import gamma_pdf
from ..ops.windows import linspace
from ..train.optim import Adam, AdamState

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def band_pos_encode(x: torch.Tensor, n_bands: int, min_freq: float = 0.01,
                    max_freq: float = 128.0) -> torch.Tensor:
    """(batch, n_events, time) -> (batch, n_events, 2 n_bands, time):
    ``sin`` and ``cos`` of ``x`` at ``n_bands`` linearly spaced
    frequencies, interleaved (even channels ``sin``, odd ``cos``)."""
    freqs = linspace(min_freq, max_freq, n_bands, device=x.device, dtype=x.dtype).reshape(
        1, 1, -1, 1)
    s = torch.sin(x[:, :, None, :] * freqs)
    c = torch.cos(x[:, :, None, :] * freqs)
    return torch.stack([s, c], dim=3).reshape(x.shape[0], x.shape[1], 2 * n_bands, x.shape[-1])


def training_batch_from_draws(start_times: torch.Tensor, durations: torch.Tensor,
                              a: torch.Tensor, b: torch.Tensor, resolution: int,
                              envelope_resolution: int):
    """``generate_training_batch`` from its four uniform draws: start times
    (n,) in [0, 1), durations (n,) in [1e-3, 1), and the gamma shape and
    rate draws (n, 1) in [0, 10) (1e-12 is added here). Returns (target (n,
    1, resolution), start_times, durations, envelopes (n,
    envelope_resolution))."""
    a, b = 1e-12 + a, 1e-12 + b
    envelopes = gamma_pdf(a[:, 0], b[:, 0], envelope_resolution)
    dev = start_times.device
    start_samples = torch.floor(start_times * resolution).to(torch.int32)
    duration_samples = torch.floor(durations * resolution).to(torch.int32)
    rel = torch.arange(resolution, dtype=torch.int32, device=dev)[None, :] - start_samples[:, None]
    scale = envelope_resolution / torch.clamp(duration_samples[:, None], min=1).to(torch.float32)
    coords = (rel + 0.5) * scale - 0.5
    inside = (rel >= 0) & (rel < duration_samples[:, None])
    cc = kinks.clip(coords, 0.0, envelope_resolution - 1)
    lo = torch.floor(cc).to(torch.int64)
    hi = torch.clamp(lo + 1, max=envelope_resolution - 1)
    w = cc - lo
    gathered = (torch.gather(envelopes, 1, lo) * (1.0 - w) + torch.gather(envelopes, 1, hi) * w)
    target = torch.where(inside, gathered, torch.zeros((), device=dev))[:, None, :]
    return target, start_times, durations, envelopes


def generate_training_batch(generator: torch.Generator, n_examples: int, resolution: int,
                            envelope_resolution: int, device=None):
    """Random gamma envelopes rasterised at random starts and durations:
    the four draws from ``generator`` (on its device), then
    :func:`training_batch_from_draws` on ``default_device(device)``."""
    def draw(shape, lo, hi):
        return (torch.rand(shape, generator=generator, device=generator.device) * (hi - lo)
                + lo).to(default_device(device))

    return training_batch_from_draws(draw((n_examples,), 0.0, 1.0),
                                     draw((n_examples,), 1e-3, 1.0),
                                     draw((n_examples, 1), 0.0, 10.0),
                                     draw((n_examples, 1), 0.0, 10.0),
                                     resolution, envelope_resolution)


class AudioOperator(nn.Module):
    """Embed the event's start, duration, envelope and latent (``Dense_0``
    to ``Dense_3``) and every sample's position (``Dense_4``), combine the
    event's (``Dense_5``), add the positions, and decode each sample as
    ``LinearOutputStack_0(h) * relu(LinearOutputStack_1(h))``; every Dense
    uniform +-0.02."""

    def __init__(self, envelope_resolution: int, latent_dim: int, pos_encoding_dim: int,
                 model_dim: int, generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.model_dim = model_dim
        for i, n_in in enumerate((pos_encoding_dim, pos_encoding_dim, envelope_resolution,
                                  latent_dim, pos_encoding_dim, 4 * model_dim)):
            self.add_module(f"Dense_{i}", uniform_linear(n_in, model_dim, True, 0.02, gen, device))
        for i in range(2):
            self.add_module(f"LinearOutputStack_{i}", LinearOutputStack(
                model_dim, 2, out_channels=1, in_channels=model_dim, init_scale=0.02,
                activation=F.selu, generator=gen, device=device))

    def forward(self, start, duration, envelope, event_properties, pos) -> torch.Tensor:
        """start / duration (batch, n_events, pos_dim), envelope (batch,
        n_events, envelope_resolution), event_properties (batch, n_events,
        latent_dim), pos (batch, n_events, pos_dim, resolution) -> (batch,
        n_events, resolution)."""
        resolution = pos.shape[-1]
        batch, n_events = start.shape[:2]
        with no_tf32():
            s, d = self.Dense_0(start), self.Dense_1(duration)
            e, p = self.Dense_2(envelope), self.Dense_3(event_properties)
            pe = self.Dense_4(pos.transpose(2, 3)).reshape(batch, resolution, self.model_dim)
            x = self.Dense_5(torch.cat([s, d, e, p], dim=-1))
            orig = x + pe
            out = self.LinearOutputStack_0(orig) * F.relu(self.LinearOutputStack_1(orig))
        return out.reshape(batch, n_events, resolution)


def envelope_loss(target: torch.Tensor, recon: torch.Tensor, window: int,
                  step: int) -> torch.Tensor:
    """Energy removal on pooled rectified envelopes: the mean of ``|x|``
    over ``window`` samples every ``step`` (``step`` zeros at each end
    counted), then ``-sum(||target|| - ||target - recon||)`` over the
    pooled envelopes."""
    def pool(x):
        return F.avg_pool1d(kinks.abs(x), window, step, padding=step, count_include_pad=True)

    td, rd = pool(target), pool(recon)
    start_norm = torch.sqrt(torch.sum(td * td, dim=-1))
    diff = td - rd
    end_norm = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return torch.sum(-(start_norm - end_norm))


SMOKE = dict(n_samples=2**11, n_bands=16, model_dim=32, envelope_resolution=32, latent_dim=8,
             pool_window=128, pool_step=32)


def times_encoding(batch_size: int, n_samples: int, n_bands: int, max_freq: float,
                   device=None) -> torch.Tensor:
    """Every sample's position in [0, 1] encoded, (batch, 1, 2 n_bands,
    n_samples)."""
    times = linspace(0.0, 1.0, n_samples, device=default_device(device)).reshape(1, 1, -1)
    return band_pos_encode(times.expand(batch_size, 1, n_samples), n_bands, max_freq=max_freq)


def make_batch(generator: torch.Generator, batch_size: int, n_samples: int, n_bands: int,
               max_freq: float, envelope_resolution: int, latent_dim: int,
               device=None) -> Batch:
    """The script's batch (target, start encoding, duration encoding,
    envelopes (batch, 1, envelope_resolution), latents (batch, 1,
    latent_dim) in [-1, 1)), every draw from ``generator``."""
    dev = default_device(device)
    target, starts, durs, envs = generate_training_batch(generator, batch_size, n_samples,
                                                         envelope_resolution, dev)
    latents = (torch.rand((batch_size, 1, latent_dim), generator=generator,
                          device=generator.device) * 2.0 - 1.0).to(dev)
    es = band_pos_encode(starts.reshape(-1, 1, 1), n_bands, max_freq=max_freq).reshape(
        batch_size, 1, -1)
    ed = band_pos_encode(durs.reshape(-1, 1, 1), n_bands, max_freq=max_freq).reshape(
        batch_size, 1, -1)
    return target, es, ed, envs[:, None, :], latents


def operator_loss(model: AudioOperator, batch: Batch, times_enc: torch.Tensor, window: int,
                  step: int) -> torch.Tensor:
    target, es, ed, envs, latents = batch
    return envelope_loss(target, model(es, ed, envs, latents, times_enc), window, step)


def operator_step(model: AudioOperator, adam: Adam, state: AdamState, batch: Batch,
                  times_enc: torch.Tensor, window: int, step: int):
    """One Adam step in place, nothing read on the host. Returns (loss, the
    new Adam state)."""
    params = list(model.parameters())
    loss = operator_loss(model, batch, times_enc, window, step)
    updates, state = adam.update(torch.autograd.grad(loss, params), state)
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    return loss.detach(), state


class OperatorRun(NamedTuple):
    model: AudioOperator
    losses: List[float]        # every step's loss, read once after the loop
    step_starts: List[float]   # host clock at each step's start
    t_end: float               # host clock after the loop (synchronised on a card)


def train_audiooperator(iterations: int = 2000, batch_size: int = 4, n_samples: int = 2**15,
                        n_bands: int = 512, max_freq: float = 2048.0,
                        envelope_resolution: int = 128, latent_dim: int = 64,
                        model_dim: int = 512, lr: float = 1e-3, pool_window: int = 512,
                        pool_step: int = 128, overfit: bool = False, seed: int = 0,
                        out: str | None = "trained_weights/audiooperator", smoke: bool = False,
                        device=None,
                        log: Callable[[str], None] = print) -> OperatorRun:
    """``scripts/audiooperator.py:main`` with its flags as keywords
    (``smoke`` its ``--smoke`` sizes): train an :class:`AudioOperator`
    (seeded with ``seed``) by optax's Adam, on a fresh batch every step
    or, with ``overfit``, on the first batch throughout; every draw from a
    CPU generator seeded with ``seed``, so that a card and the CPU train
    on the same batches. With ``out``, ``metrics.json`` is written
    there."""
    dev = default_device(device)
    if smoke:
        n_samples, n_bands, model_dim = SMOKE["n_samples"], SMOKE["n_bands"], SMOKE["model_dim"]
        envelope_resolution, latent_dim = SMOKE["envelope_resolution"], SMOKE["latent_dim"]
        pool_window, pool_step = SMOKE["pool_window"], SMOKE["pool_step"]
    gen = torch.Generator().manual_seed(seed)
    model = AudioOperator(envelope_resolution, latent_dim, 2 * n_bands, model_dim,
                          torch.Generator().manual_seed(seed), dev)
    times_enc = times_encoding(batch_size, n_samples, n_bands, max_freq, dev)

    def new_batch():
        return make_batch(gen, batch_size, n_samples, n_bands, max_freq, envelope_resolution,
                          latent_dim, dev)

    first = new_batch()
    adam = Adam(lr)
    state = adam.init(list(model.parameters()))
    losses, logged, starts = [], [], []
    t0 = time.perf_counter()
    for i in range(iterations):
        starts.append(time.perf_counter())
        batch = first if overfit else new_batch()
        loss, state = operator_step(model, adam, state, batch, times_enc, pool_window, pool_step)
        losses.append(loss)
        if i % 25 == 0:
            logged.append([i, round(float(loss), 4)])
            log(f"iter {i} loss {float(loss):.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    elapsed = t_end - t0
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump({"losses": logged, "steps_per_s": iterations / max(elapsed, 1e-9)}, f,
                      indent=1)
    log(f"done in {elapsed:.1f}s")
    return OperatorRun(model, torch.stack(losses).tolist() if losses else [], starts, t_end)
