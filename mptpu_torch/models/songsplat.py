"""Whole-song splatting (counterpart of ``mptpu/models/songsplat.py`` and
of ``scripts/songsplat.py``): one bank of events spans the whole song, a
latent vector and a row of time logits over the song's frames each;
training samples a segment, renders the events whose hard time falls in
an extended window around it, and fits a spectrogram loss.

As in ``mptpu``, the range query takes a fixed capacity of
``events_per_segment`` events by a top-k over the in-range mask: every
score is 0 or 1, so the order of ties decides which events render, and
the port's top-k gives ``lax.top_k``'s (lower index first,
``sparse/topk.py``). ``start_frame`` is a host int (the segment stream
draws it with numpy), checked on the host; the window of logits is a
slice, with no read of the device.

The decoder's noise, one (1, 1, 2 x segment) uniform draw in [-1, 1) a
call, is passed in or drawn from a ``torch.Generator``; ``mptpu`` draws it
from its key (``fold_in(key, i)`` at step ``i``), which the tests feed in.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import convert
from ..data.synthetic import synthetic_audio
from ..device import default_device, no_tf32
from ..gen.splat import SplattingEventGenerator
from ..nn.init import uniform, uniform_init
from ..nn.multihead import MultiHeadTransform
from ..obs import Collection, serve_collection
from ..ops import kinks
from ..ops.refit import refit_gains
from ..ops.ste import sparse_softmax
from ..ops.stft import stft
from ..sparse.topk import _top_k
from ..train.checkpoint import CheckpointManager, save_checkpoint
from ..train.optim import Adam, AdamState, adam_state_from_tree, adam_state_tree
from ..utils.wav import fft_resample_np, read_wav, write_wav


class SongSplatModel(nn.Module):
    """A song-length event bank and a splatting decoder.

    ``forward(start_frame, noise=None, generator=None)`` renders the
    segment starting at ``start_frame`` of the song's frame grid (a step of
    ``step_size`` samples) and returns (events (1, K, segment samples), the
    in-range mask (K,), the schedules (K, 2 x segment frames), the true
    in-range count), K = ``events_per_segment``. Parameters carry flax's
    names (``events``, ``times``, ``transform``; the generator's reverb as
    ``decoder``), drawn from ``init_generator`` (a CPU generator, default
    seed 0); ``convert.songsplat_from_flax`` carries ``mptpu``'s."""

    def __init__(self, total_samples: int, n_segment_samples: int, samplerate: int = 22050,
                 event_latent_dim: int = 32, events_per_second: float = 8.0,
                 events_per_segment: int = 32, step_size: int = 256,
                 init_generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = default_device(device)
        gen = init_generator or torch.Generator().manual_seed(0)
        self.total_samples = total_samples
        self.n_segment_samples = n_segment_samples
        self.samplerate = samplerate
        self.event_latent_dim = event_latent_dim
        self.events_per_second = events_per_second
        self.events_per_segment = events_per_segment
        self.step_size = step_size
        self.events = nn.Parameter(
            uniform_init((self.total_events, event_latent_dim), 0.01, gen).to(dev))
        self.times = nn.Parameter(
            uniform_init((self.total_events, self.total_frames), 0.01, gen).to(dev))
        # the render window is twice the segment, so that onsets before the
        # segment ring into it
        self.decoder = SplattingEventGenerator(
            n_samples=2 * n_segment_samples, samplerate=samplerate, n_resonance_octaves=16,
            n_frames=(2 * n_segment_samples) // step_size, hard_reverb_choice=False,
            hierarchical_scheduler=False, wavetable_resonance=False, init_generator=gen,
            device=dev)
        self.transform = MultiHeadTransform(event_latent_dim, hidden_channels=128,
                                            shapes=self.decoder.shape_spec, n_layers=1,
                                            generator=gen, device=dev)

    @property
    def total_frames(self) -> int:
        return self.total_samples // self.step_size

    @property
    def segment_frames(self) -> int:
        return self.n_segment_samples // self.step_size

    @property
    def total_events(self) -> int:
        return int(self.total_samples / self.samplerate * self.events_per_second)

    @property
    def compression_ratio(self) -> float:
        return self.total_events * (self.event_latent_dim + 1) / self.total_samples

    @property
    def noise_shape(self) -> Tuple[int, int, int]:
        return (1, 1, 2 * self.n_segment_samples)

    def start_range(self) -> Tuple[int, int]:
        """The valid start frames, [segment_frames, total_frames -
        segment_frames]."""
        return self.segment_frames, self.total_frames - self.segment_frames

    def range_query(self, start_frame: int):
        """(indices (K,), their in-range mask, the true in-range count) of
        the events whose hard time lands in [start_frame - segment_frames,
        start_frame + segment_frames): ``lax.top_k``'s K of the 0/1 mask,
        in-range events first, lowest index first. A count above K means
        that the capacity dropped events."""
        hard = torch.argmax(self.times, dim=-1)
        in_range = (hard >= start_frame - self.segment_frames) & (
            hard < start_frame + self.segment_frames)
        _, idx = _top_k(in_range.to(torch.float32), self.events_per_segment)
        return idx, in_range[idx], in_range.sum()

    def forward(self, start_frame: int, noise: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None):
        lo, hi = self.start_range()
        if hi < lo:
            raise ValueError(f"total_samples must cover at least two segments (total_frames "
                             f"{self.total_frames} < 2 x segment_frames {self.segment_frames})")
        start_frame = int(start_frame)
        if not lo <= start_frame <= hi:
            raise ValueError(f"start_frame {start_frame} outside valid range [{lo}, {hi}]")
        idx, mask, n_in_range = self.range_query(start_frame)
        vecs = self.events[idx]
        window = self.times.narrow(-1, start_frame - self.segment_frames,
                                   2 * self.segment_frames)[idx]
        sched = sparse_softmax(window, normalize=True, axis=-1) * mask[:, None]
        rendered = self.decoder(self.transform(vecs[None]), sched[None], noise=noise,
                                generator=generator)
        rendered = rendered * mask[None, :, None]
        # the second half is the segment: events placed before it bring only
        # their ringing tails
        return rendered[..., self.n_segment_samples:], mask, sched, n_in_range

    def generate_random(self, n_events: int = 8, generator: torch.Generator | None = None,
                        perm: Optional[torch.Tensor] = None, raw: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A preview: ``n_events`` of the bank's vectors (the first of a
        random permutation ``perm`` of the events) at random times (the
        hard softmax of logits ``raw`` (n_events, 2 x segment frames),
        uniform in [-1, 1)), rendered with ``noise``. What is not given is
        drawn from ``generator``, in that order."""
        dev = self.events.device
        if perm is None:
            perm = torch.randperm(self.total_events, generator=generator,
                                  device=generator.device if generator is not None else dev)
        if raw is None:
            raw = uniform((n_events, 2 * self.segment_frames), -1.0, 1.0, generator, dev)
        if noise is None:
            noise = uniform(self.noise_shape, -1.0, 1.0, generator, dev)
        vecs = self.events[perm.to(dev)[:n_events]]
        sched = sparse_softmax(raw.to(dev), normalize=True, axis=-1)
        rendered = self.decoder(self.transform(vecs[None]), sched[None], noise=noise.to(dev))
        return rendered[..., self.n_segment_samples:]


# ---- scripts/songsplat.py ---------------------------------------------------------------

# --tiny and the reference configuration: (song samples, segment samples,
# events a second, range-query capacity)
TINY = (2**15, 2**12, 16.0, 8)
REFERENCE = (2**19, 2**15, 8.0, 32)


def get_song(path: Optional[str], total_samples: int, samplerate: int) -> np.ndarray:
    """The song: the WAV at ``path`` (resampled, zero-padded to
    ``total_samples``, a window at a start drawn from numpy's global
    generator), else the synthetic song of 4 note events a second over
    pedal tones (seed 42)."""
    if path and os.path.exists(path):
        samples, sr = read_wav(path)
        if sr != samplerate:
            samples = fft_resample_np(samples, sr, samplerate)
        if samples.shape[-1] < total_samples:
            samples = np.pad(samples, (0, total_samples - samples.shape[-1]))
        start = np.random.randint(0, max(1, samples.shape[-1] - total_samples))
        return samples[start: start + total_samples].astype(np.float32)
    return synthetic_audio(total_samples, n_events=int(total_samples / 22050 * 4), seed=42,
                           sustained=True)


def segment_stream(song: torch.Tensor, model: SongSplatModel,
                   seed: int = 0) -> Iterator[Tuple[torch.Tensor, int]]:
    """Endless (segment (1, 1, segment samples), start_frame): start frames
    drawn by ``np.random.default_rng(seed)`` in [segment_frames,
    total_frames - segment_frames), ``mptpu``'s; each segment a view of
    ``song`` (a tensor, on the device that trains)."""
    rng = np.random.default_rng(seed)
    lo, hi = model.start_range()
    while True:
        start_frame = int(rng.integers(lo, hi))
        s = start_frame * model.step_size
        yield song[s: s + model.n_segment_samples].reshape(1, 1, -1), start_frame


def spec_transform(x: torch.Tensor) -> torch.Tensor:
    """The loss's feature: ``stft(x, 2048, 256, pad=True)``."""
    return stft(x, 2048, 256, pad=True)


def songsplat_loss(model: SongSplatModel, target: torch.Tensor, start_frame: int,
                   noise: torch.Tensor, sparsity: float = 0.0):
    """The script's loss: the l1 distance of the segment's spectrogram from
    the sum of the rendered events', plus ``sparsity`` times the sum of the
    straight-through schedules. Returns (loss, recon (1, 1, n), the true
    in-range count)."""
    rendered, _, sched, n_in_range = model(start_frame, noise=noise)
    recon = torch.sum(rendered, dim=1, keepdim=True)
    loss = kinks.abs(spec_transform(recon) - spec_transform(target)).sum()
    if sparsity:
        loss = loss + sparsity * torch.sum(sched)
    return loss, recon, n_in_range


def songsplat_step(model: SongSplatModel, adam: Adam, opt_state: AdamState,
                   target: torch.Tensor, start_frame: int, noise: torch.Tensor,
                   sparsity: float = 0.0):
    """One training step, nothing read on the host: the loss, its gradient
    and optax's Adam update applied to the parameters in place. Returns
    (loss, recon, the true in-range count, the new Adam state)."""
    params = list(model.parameters())
    loss, recon, n_in_range = songsplat_loss(model, target, start_frame, noise, sparsity)
    # the f0 branch leaves the decay_choice head unused: its gradient is 0
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    updates, opt_state = adam.update(grads, opt_state)
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    return loss.detach(), recon.detach(), n_in_range, opt_state


@torch.no_grad()
def render_song(model: SongSplatModel, song: np.ndarray, refit: float = 0.0,
                noise: Optional[Callable[[int], torch.Tensor]] = None,
                device=None) -> Tuple[np.ndarray, Dict[str, float]]:
    """The whole-song render: segments tiled from ``segment_frames`` on, each
    rendered with ``noise(start_frame)`` (default a draw from a generator
    seeded with 100,000 plus the start frame), its events summed or, with
    ``refit`` > 0, weighted by ``refit_gains`` against the song at that
    ridge. Returns (the song's reconstruction, {covered_snr_db,
    covered_lsd_db, covered_samples}) over the covered span, the LSD over
    ``spec_transform``'s magnitudes."""
    dev = default_device(device)
    n_total = song.shape[-1]
    song_t = torch.from_numpy(np.ascontiguousarray(song, np.float32)).to(dev)
    recon = np.zeros(n_total, np.float32)
    seg_frames, step, seg = model.segment_frames, model.step_size, model.n_segment_samples
    for start_frame in range(seg_frames, model.total_frames - seg_frames, seg_frames):
        nz = (noise(start_frame) if noise is not None else uniform(
            model.noise_shape, -1.0, 1.0,
            torch.Generator(device=dev).manual_seed(100_000 + start_frame)))
        rendered = model(start_frame, noise=nz.to(dev))[0]
        s = start_frame * step
        tgt = song_t[s: s + seg].reshape(1, 1, -1)
        if refit:
            g = refit_gains(tgt, rendered[..., : tgt.shape[-1]], ridge=refit)
            with no_tf32():
                out = torch.einsum("be,ben->bn", g, rendered)[0]
        else:
            out = torch.sum(rendered, dim=1)[0]
        out = out.reshape(-1).cpu().numpy()
        n = min(len(out), n_total - s)
        recon[s: s + n] = out[:n]
    lo, hi = seg_frames * step, (model.total_frames - seg_frames) * step
    t_cov, r_cov = song[lo:hi], recon[lo:hi]
    snr = float(10 * np.log10((np.sum(t_cov**2) + 1e-12)
                              / (np.sum((t_cov - r_cov) ** 2) + 1e-12)))
    ts = torch.abs(spec_transform(song_t[lo:hi].reshape(1, 1, -1)))
    rs = torch.abs(spec_transform(torch.from_numpy(r_cov).to(dev).reshape(1, 1, -1)))
    lsd = float(torch.sqrt(torch.mean(
        (20 * torch.log10(ts + 1e-8) - 20 * torch.log10(rs + 1e-8)) ** 2)))
    return recon, {"covered_snr_db": snr, "covered_lsd_db": lsd, "covered_samples": hi - lo}


class SongSplatRun(NamedTuple):
    model: SongSplatModel
    losses: List[float]         # the logged losses, one a log step
    step_losses: List[float]    # every step's loss, read once after the loop
    step_starts: List[float]    # host clock at each step's start
    t_end: float                # host clock after the loop (synchronised on a card)
    eval: dict                  # what song_eval.json holds


def train_songsplat(iterations: int = 1000, tiny: bool = False, song: Optional[str] = None,
                    port: int = 0, out: str = "trained_weights/songsplat", log_every: int = 25,
                    sparsity: float = 0.0, refit: float = 0.0, resume: bool = False,
                    render_only: bool = False, device=None,
                    log: Callable[[str], None] = print) -> SongSplatRun:
    """``scripts/songsplat.py:main`` with its flags as keywords: fit a
    ``SongSplatModel`` (seeded with 0) to the song by Adam (lr 1e-3) on
    segments of ``segment_stream``, one noise draw a step from a generator
    on the device seeded with 0; log at every ``log_every``-th step (the
    loss read on the host, the range query's overflow, the dashboard's
    audio and loss), a random preview every 100 steps, a checkpoint every
    250 (flax-named parameters, the Adam state in the port's tree); then
    render the whole song and write ``song_eval.json``, ``song_target.wav``
    and ``song_recon.wav`` under ``out``. ``resume`` starts from the newest
    checkpoint in ``out``; ``render_only`` trains nothing."""
    dev = default_device(device)
    if render_only:
        resume = True
    total_samples, segment_samples, eps, cap = TINY if tiny else REFERENCE
    model = SongSplatModel(total_samples, segment_samples, events_per_second=eps,
                           events_per_segment=cap, device=dev)
    audio = get_song(song, total_samples, model.samplerate)
    song_t = torch.from_numpy(audio).to(dev)
    stream = segment_stream(song_t, model)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    log(f"song {total_samples} samples, {model.total_events} events, "
        f"{sum(p.numel() for p in params)} params, compression ratio "
        f"{model.compression_ratio:.4f}")

    adam = Adam(1e-3)
    opt_state: AdamState = adam.init(params)
    ckpt = CheckpointManager(out, every=250)
    start_iter = 0
    if resume:
        payload = ckpt.latest()
        if payload is None:
            if render_only:
                raise SystemExit(f"--render-only: no checkpoint in {out}")
            log("resume requested but no checkpoint found")
        else:
            convert.songsplat_from_flax(model, payload["params"])
            if payload.get("opt_state") is not None:
                opt_state = adam_state_from_tree(payload["opt_state"], names, dev)
            start_iter = int(payload["step"]) + 1
            log(f"resumed from step {payload['step']}")
    if render_only:
        iterations = 0
    collection = Collection(os.path.join(out, "dashboard"))
    server = serve_collection(collection, port=port) if port else None

    noise_gen = torch.Generator(device=dev).manual_seed(0)
    losses, step_losses, starts = [], [], []
    t0 = time.perf_counter()
    i = start_iter
    for i in range(start_iter, iterations):
        starts.append(time.perf_counter())
        target, start_frame = next(stream)
        noise = uniform(model.noise_shape, -1.0, 1.0, noise_gen)
        loss, recon, n_in_range, opt_state = songsplat_step(model, adam, opt_state, target,
                                                            start_frame, noise, sparsity)
        step_losses.append(loss)
        if i % log_every == 0:
            value = float(loss)
            losses.append(value)
            overflow = int(n_in_range) - model.events_per_segment
            extra = (f" [RANGE-QUERY OVERFLOW: {overflow} events dropped]"
                     if overflow > 0 else "")
            log(f"iter {i} loss {value:.2f}{extra}")
            collection.log("orig", target[0, 0], kind="audio")
            collection.log("recon", recon[0, 0], kind="audio")
            collection.log("loss", np.asarray(losses[-200:]))
        if i % 100 == 0 and i > 0:
            with torch.no_grad():
                rnd = model.generate_random(
                    generator=torch.Generator(device=dev).manual_seed(2_000_000 + i))
            collection.log("random", torch.sum(rnd, 1)[0], kind="audio")
        if i % ckpt.every == 0:
            ckpt.maybe_save(i, convert.songsplat_to_flax(model),
                            adam_state_tree(opt_state, names))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    elapsed = t_end - t0
    n_steps = len(starts)
    if n_steps:
        save_checkpoint(os.path.join(out, f"ckpt_{i:09d}.pkl"), convert.songsplat_to_flax(model),
                        adam_state_tree(opt_state, names), step=i)
    trend = f", loss {losses[0]:.1f} -> {losses[-1]:.1f}" if losses else ""
    log(f"done: {n_steps} iters in {elapsed:.1f}s ({n_steps / max(elapsed, 1e-9):.2f} "
        f"steps/s){trend}")

    recon_song, metrics = render_song(model, audio, refit, device=dev)
    eval_out = {
        "covered_snr_db": round(metrics["covered_snr_db"], 3),
        "covered_lsd_db": round(metrics["covered_lsd_db"], 3),
        "covered_samples": int(metrics["covered_samples"]),
        "total_samples": int(total_samples),
        "iterations": iterations,
        "trained_steps": start_iter - 1 + n_steps if start_iter else n_steps,
        "refit_ridge": refit,
        "final_loss": losses[-1] if losses else None,
    }
    log("song eval " + json.dumps(eval_out))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "song_eval.json"), "w") as f:
        json.dump(eval_out, f, indent=1)
    write_wav(os.path.join(out, "song_target.wav"), audio, model.samplerate)
    write_wav(os.path.join(out, "song_recon.wav"), recon_song, model.samplerate)
    if server:
        server.shutdown()
        server.server_close()
    every = torch.stack(step_losses).tolist() if step_losses else []
    return SongSplatRun(model, losses, every, starts, t_end, eval_out)
