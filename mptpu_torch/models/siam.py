"""The SIAM iterative-decomposition codec, BASELINE config #4
(counterpart of ``mptpu/models/siam.py``).

An anti-causal dilated-convolution encoder picks one event per step (a
vector and a frame in the first half of the window); the
``OverfitResonanceModel`` decoder renders it; the rendered event's
magnitude spectrogram is subtracted from the residual (detached), which
feeds the next step. ``mptpu`` runs the steps under ``lax.scan``; here
they are a Python loop of eager PyTorch.

The decoder's noise is part of a trained model's state: a model trained
with a pinned noise draw has memorised it. Every entry point takes
``noise`` (the draws themselves, one per event: (n_events, batch or 1, 1,
min(8192, n_samples))) or a ``generator`` to draw them from. Where
``mptpu`` folds event ``i`` into its key, the port takes ``noise[i]``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device, no_tf32
from ..gen.overfitresonance import OverfitResonanceModel
from ..nn.anticausal import AntiCausalAnalysis
from ..nn.init import uniform, uniform_linear
from ..nn.multihead import MultiHeadTransform
from ..ops import kinks
from ..ops.fft import irfft, real_ends, rfft
from ..ops.refit import refit_gains
from ..ops.ste import leaky_relu_ste, sparse_softmax, straight_through
from ..ops.stft import stft
from ..ops.windows import linspace
from ..sparse.topk import sparsify, sparsify_vectors


def siam_transform(x: torch.Tensor, window_size: int = 2048, step_size: int = 256,
                   mag_epsilon: float = 0.0) -> torch.Tensor:
    """Audio (batch, 1, n) -> (batch, window_size // 2 + 1, n // step_size)
    magnitude STFT; ``mag_epsilon`` > 0 smooths |z| at 0."""
    batch = x.shape[0]
    spec = stft(x, window_size, step_size, pad=True, mag_epsilon=mag_epsilon)
    return spec.reshape(batch, -1, window_size // 2 + 1).permute(0, 2, 1)


_MEL_CACHE: dict = {}


def _mel_basis(n_bins: int, n_bands: int, samplerate: int = 22050) -> np.ndarray:
    """Fixed log-spaced triangular filterbank (n_bands, n_bins) over
    [0, samplerate / 2], rows l1-normalised (float32 numpy, cached): the
    conditioning feature of ``SIAMModel.spectral_filter``."""
    key = (n_bins, n_bands, samplerate)
    if key not in _MEL_CACHE:
        freqs = np.linspace(0.0, samplerate / 2.0, n_bins)
        lo, hi = 30.0, samplerate / 2.0
        edges = np.geomspace(lo, hi, n_bands + 2)
        basis = np.zeros((n_bands, n_bins), np.float32)
        for b in range(n_bands):
            l, c, r = edges[b], edges[b + 1], edges[b + 2]
            up = (freqs - l) / max(c - l, 1e-6)
            down = (r - freqs) / max(r - c, 1e-6)
            tri = np.clip(np.minimum(up, down), 0.0, None)
            s = tri.sum()
            basis[b] = tri / (s if s > 0 else 1.0)
        _MEL_CACHE[key] = basis
    return _MEL_CACHE[key]


def _integer_pow(x: torch.Tensor, power: int) -> torch.Tensor:
    """``x ** power`` for a positive integer ``power`` by binary
    exponentiation, the float32 products ``jnp``'s ``x ** 8`` makes
    (``torch.pow`` rounds otherwise)."""
    acc = None
    while power > 0:
        if power & 1:
            acc = x if acc is None else acc * x
        power >>= 1
        if power > 0:
            x = x * x
    return acc


def fade_tail(n_samples: int, power: int = 8, device=None) -> torch.Tensor:
    """The codec's analysis-window envelope (1, 1, n_samples): ones over
    the first half, ``linspace(1, 0) ** power`` over the second. Events
    are confined to a window's first half, and every trainer encodes the
    faded window, so an unfaded tail is out of distribution."""
    half = n_samples // 2
    ramp = _integer_pow(linspace(1.0, 0.0, n_samples - half, device=device), power)
    ones = torch.ones(half, dtype=ramp.dtype, device=ramp.device)
    return torch.cat([ones, ramp]).reshape(1, 1, n_samples)


class SIAMModel(nn.Module):
    """Encoder, event heads and resonance decoder.

    The flags are ``mptpu``'s fields, with its defaults (0 or False keeps
    the reference's semantics):

    - ``attn_floor``: added to the selected event's amplitude;
    - ``attn_leak``: leaky backward of the attention relu (forward exact);
    - ``switch_bias_init``: initial bias of the event-switch head;
    - ``switch_clamp``: straight-through cap of the selected amplitude;
    - ``residual_clamp_scale``: the residual clipped to +-scale x the
      initial spectrogram's largest magnitude, per item;
    - ``encoder_clamp``: straight-through clip of each encoder block;
    - ``spectral_skip``: a Dense image of the residual column at the
      selected frame (signed log) added to the event vector;
    - ``spectral_filter``: each event shaped by a zero-phase envelope from
      a 64-band log-mel feature of that column (needs ``spectral_skip``);
    - ``vec_clamp``: straight-through clip of the event vector.

    Parameters are drawn from ``generator`` (a CPU one, default seed 0) in
    ``mptpu``'s ranges; ``convert.siam_from_flax`` carries a flax tree.
    """

    def __init__(self, n_samples: int = 2**17, samplerate: int = 22050, context_dim: int = 32,
                 in_channels: int = 1025, hidden_channels: int = 128, n_events: int = 32,
                 transform_window_size: int = 2048, transform_step_size: int = 256,
                 with_activation_norm: bool = False, fft_resonance: bool = True,
                 attn_floor: float = 0.0, attn_leak: float = 0.0, switch_bias_init: float = 0.0,
                 switch_clamp: float = 0.0, residual_clamp_scale: float = 0.0,
                 encoder_clamp: float = 0.0, spectral_skip: bool = False,
                 spectral_filter: bool = False, vec_clamp: float = 0.0,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        self.n_samples = n_samples
        self.samplerate = samplerate
        self.context_dim = context_dim
        self.in_channels = in_channels
        self.hidden_channels = hidden_channels
        self.n_events = n_events
        self.transform_window_size = transform_window_size
        self.transform_step_size = transform_step_size
        self.attn_floor = attn_floor
        self.attn_leak = attn_leak
        self.switch_clamp = switch_clamp
        self.residual_clamp_scale = residual_clamp_scale
        self.spectral_skip = spectral_skip
        self.spectral_filter = spectral_filter
        self.vec_clamp = vec_clamp

        self.encoder = AntiCausalAnalysis(
            in_channels, hidden_channels, kernel_size=2, dilations=[1, 2, 4, 8, 16, 32, 64, 1],
            with_activation_norm=with_activation_norm, activation_clamp=encoder_clamp,
            generator=gen, device=dev)
        self.to_event_vectors = uniform_linear(hidden_channels, context_dim, True, 0.02, gen, dev)
        self.to_event_switch = uniform_linear(hidden_channels, 1, True, 0.02, gen, dev)
        with torch.no_grad():
            self.to_event_switch.bias.fill_(switch_bias_init)
        self.resonance = OverfitResonanceModel(
            n_noise_filters=32, noise_expressivity=8, noise_filter_samples=128,
            noise_deformations=16, instr_expressivity=8, n_events=1, n_resonances=4096,
            n_envelopes=64, n_deformations=64, n_samples=n_samples, n_frames=self.n_frames,
            samplerate=samplerate, hidden_channels=hidden_channels, context_dim=context_dim,
            fine_positioning=True, fft_resonance=fft_resonance, generator=gen, device=dev)
        self.multihead = MultiHeadTransform(context_dim, hidden_channels,
                                            self.resonance.shape_spec, n_layers=2,
                                            generator=gen, device=dev)
        if spectral_skip:
            self.spec_skip_proj = uniform_linear(in_channels, context_dim, True, 0.02, gen, dev)
        if spectral_filter:
            # zero kernel and softplus(bias) = 1: the filter is the identity
            # at init, so turning it on cannot regress an untrained model
            self.spec_filter_gate = nn.Linear(64, in_channels, device=dev)
            with torch.no_grad():
                self.spec_filter_gate.weight.zero_()
                self.spec_filter_gate.bias.fill_(0.5413248546)

    @property
    def n_frames(self) -> int:
        return self.n_samples // self.transform_step_size

    @property
    def noise_size(self) -> int:
        """Samples of one event's noise draw."""
        return min(8192, self.n_samples)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return siam_transform(x, self.transform_window_size, self.transform_step_size)

    def encode(self, transformed: torch.Tensor):
        """One event: (vecs (batch, 1, context), scheduling (batch, 1,
        frames)), its frame the first argmax of the attention over the
        window's first half."""
        batch = transformed.shape[0]
        encoded = self.encoder(transformed)   # (batch, hidden, frames)
        ev_in = encoded.transpose(1, 2)
        with no_tf32():
            event_vecs = self.to_event_vectors(ev_in)   # (batch, frames, context)
            switch = self.to_event_switch(ev_in)
        attn = leaky_relu_ste(switch, self.attn_leak) if self.attn_leak else torch.relu(switch)
        attn = attn.reshape(batch, 1, -1)
        frames = attn.shape[-1]
        mask = torch.ones_like(attn)
        mask[:, :, frames // 2:] = 0.0
        attn, _, _ = sparsify(attn * mask, n_to_keep=1, return_indices=True)
        vecs, indices = sparsify_vectors(event_vecs.transpose(1, 2), attn, n_to_keep=1)
        if self.vec_clamp:
            vecs = straight_through(torch.clamp(vecs, -self.vec_clamp, self.vec_clamp), vecs)
        if self.spectral_skip:
            idx = indices[:, :, None].expand(batch, transformed.shape[1], 1)
            col = transformed.gather(2, idx)[:, :, 0]   # (batch, in_channels)
            col = torch.sign(col) * torch.log1p(torch.abs(col))
            with no_tf32():
                vecs = vecs + self.spec_skip_proj(col)[:, None, :]
        sel = attn[:, 0, :].gather(-1, indices)   # (batch, 1)
        if self.attn_floor:
            sel = sel + self.attn_floor
        if self.switch_clamp:
            sel = straight_through(torch.clamp_max(sel, self.switch_clamp), sel)
        scheduling = torch.zeros((batch, 1, frames), dtype=attn.dtype, device=attn.device)
        return vecs, scheduling.scatter(-1, indices[:, None, :], sel[:, None, :])

    def generate(self, vecs: torch.Tensor, scheduling: torch.Tensor,
                 noise: Optional[torch.Tensor] = None, generator: torch.Generator | None = None,
                 spec: Optional[torch.Tensor] = None, spec_feat: Optional[torch.Tensor] = None):
        """Render events (batch, n, n_samples) from their vectors and
        schedules; with ``spectral_filter``, shaped by the residual
        ``spec`` at their frames, or by the feature ``spec_feat`` that the
        wire carries instead."""
        ch = self.resonance(self.multihead(vecs), scheduling, noise=noise, generator=generator)
        if self.spectral_filter and (spec is not None or spec_feat is not None):
            if spec_feat is None:
                spec_feat = self.spectral_feat_static(spec, scheduling, self.in_channels)
            with no_tf32():
                env = F.softplus(self.spec_filter_gate(spec_feat))
            # jax.image.resize's "linear": half-pixel centres, the edge samples held
            n_bins = self.n_samples // 2 + 1
            env_full = F.interpolate(env[:, None, :], size=n_bins, mode="linear",
                                     align_corners=False)[:, 0]
            spec_ch = rfft(ch, n=self.n_samples)
            ch = irfft(real_ends(spec_ch * env_full[:, None, :]), n=self.n_samples)
        return ch

    @staticmethod
    def spectral_feat_static(spec: torch.Tensor, scheduling: torch.Tensor,
                             in_channels: int) -> torch.Tensor:
        """The 64-band log-mel feature of the residual ``spec`` (batch, C,
        F) at the frame of ``scheduling`` (batch, 1, F): (batch, 64), what
        the wire carries per event when the filter is part of the codec."""
        idx = torch.argmax(scheduling[:, 0, :], dim=-1)
        col = spec.gather(2, idx[:, None, None].expand(spec.shape[0], spec.shape[1], 1))[:, :, 0]
        mel = torch.from_numpy(_mel_basis(in_channels, 64)).to(col.device, col.dtype)
        with no_tf32():
            return torch.log1p(kinks.abs(col) @ mel.T)

    def iterative(self, audio_or_spec: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  generator: torch.Generator | None = None, do_transform: bool = True,
                  return_residual: bool = False):
        """``n_events`` steps of encode / generate / subtract: (channels
        (batch, E, n), vecs (batch, E, C), schedules (batch, E, F)[,
        residual spec])."""
        channels, vecs, schedules, residual, _ = _iterate(
            self, audio_or_spec, noise, generator, do_transform, False)
        if return_residual:
            return channels, vecs, schedules, residual
        return channels, vecs, schedules

    def forward(self, audio: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None):
        return self.iterative(audio, noise, generator)


def draw_noise(model: SIAMModel, shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform draws in [-1, 1) of ``shape + (1, model.noise_size)`` from
    ``generator``, on its device: ``shape`` is (n_events, batch) for one
    window, (n_windows, n_events, batch) for a walk."""
    return uniform(tuple(shape) + (1, model.noise_size), -1.0, 1.0, generator)


def _iterate(model: SIAMModel, audio_or_spec, noise, generator, do_transform, collect_feats):
    spec = model.transform(audio_or_spec) if do_transform else audio_or_spec
    bound = None
    if model.residual_clamp_scale:
        bound = model.residual_clamp_scale * torch.amax(kinks.abs(spec), dim=(-2, -1),
                                                        keepdim=True)
    chs, vs, scheds, feats = [], [], [], []
    for i in range(model.n_events):
        v, sched = model.encode(spec)
        ch = model.generate(v, sched, noise=None if noise is None else noise[i],
                            generator=generator, spec=spec)
        if collect_feats:
            feats.append(model.spectral_feat_static(spec, sched, model.in_channels))
        new_spec = (spec - model.transform(ch)).detach()
        if bound is not None:
            new_spec = torch.clamp(new_spec, -bound, bound)
        spec = new_spec
        chs.append(ch)
        vs.append(v)
        scheds.append(sched)
    feats = torch.stack(feats, dim=1) if collect_feats else None
    return torch.cat(chs, dim=1), torch.cat(vs, dim=1), torch.cat(scheds, dim=1), spec, feats


def make_iterative_fn(model: SIAMModel):
    """``fn(audio_or_spec, noise=None, generator=None, do_transform=True,
    return_feats=False) -> (channels, vecs, schedules, residual_spec[,
    feats (batch, E, 64)])``: the iterative decomposition with the
    model's shared weights (``feats`` only with ``spectral_filter``)."""

    def iterative(audio_or_spec, noise=None, generator=None, do_transform: bool = True,
                  return_feats: bool = False):
        collect = bool(return_feats and model.spectral_filter)
        channels, vecs, schedules, residual, feats = _iterate(
            model, audio_or_spec, noise, generator, do_transform, collect)
        if collect:
            return channels, vecs, schedules, residual, feats
        return channels, vecs, schedules, residual

    return iterative


def refit_event_gains(target: torch.Tensor, channels: torch.Tensor, ridge: float = 1e-3,
                      span: int | None = None) -> torch.Tensor:
    """Jointly least-squares amplitudes of the decoded events against
    ``target`` (batch, 1, n): (batch, n_events) gains, the orthogonal-MP
    fix-up of the greedy amplitudes (``ops.refit.refit_gains``)."""
    return refit_gains(target, channels, ridge=ridge, span=span)


def _roll_each(x: torch.Tensor, lags: torch.Tensor) -> torch.Tensor:
    """Each row of ``x`` (..., n) delayed circularly by its own lag
    (``lags`` shaped like ``x`` without its last axis)."""
    n = x.shape[-1]
    idx = (torch.arange(n, device=x.device) - lags[..., None]) % n
    return x.gather(-1, idx)


def refine_event_alignment(target: torch.Tensor, channels: torch.Tensor, max_shift: int = 256,
                           n_iters: int = 2, ridge: float = 1e-3, span: int | None = None):
    """Coordinate-descent shift and gain refinement of decoded events.

    Events sit on the encoder's frame grid, up to half a frame off the
    content they explain. For each event in turn: the circular lag within
    +-``max_shift`` samples that best correlates it with the residual of
    all the others (the first such lag), and its closed-form gain; then a
    joint refit of the gains. ``span`` runs the analysis on the first
    ``span`` samples and applies the shifts to the whole channels.

    Returns (refined channels, shifts (batch, E) in samples, positive
    delayed, gains (batch, E)): ``einsum('be,ben->bn', gains, refined)``
    is the reconstruction.
    """
    if span is not None:
        _, shifts, gains = refine_event_alignment(target[..., :span], channels[..., :span],
                                                  max_shift=max_shift, n_iters=n_iters,
                                                  ridge=ridge)
        return _roll_each(channels, shifts), shifts, gains

    batch, n_events, n = channels.shape
    tgt = target[:, 0]
    # start from the joint refit, so that the result is never worse than it
    cum = refit_event_gains(target, channels, ridge=ridge)
    lag_ok = torch.zeros(n, dtype=torch.bool, device=channels.device)
    lag_ok[: max_shift + 1] = True
    lag_ok[n - max_shift:] = True
    chs = channels.clone()
    shifts = torch.zeros((batch, n_events), dtype=torch.int64, device=channels.device)
    for _ in range(n_iters):
        for e in range(n_events):
            ch, ce = chs[:, e], cum[:, e]
            with no_tf32():
                total = torch.einsum("be,ben->bn", cum, chs)
            resid = tgt - (total - ce[:, None] * ch)
            # xc[k] = <resid, roll(ch, k)> at every circular lag k
            xc = irfft(rfft(resid) * torch.conj(rfft(ch)), n=n)
            score = torch.where(lag_ok[None], xc**2, float("-inf"))
            k = torch.argmax(score, dim=-1)
            best = xc.gather(-1, k[:, None])[:, 0]
            gain = best / torch.clamp_min(torch.sum(ch**2, dim=-1), 1e-12)
            chs, cum, shifts = chs.clone(), cum.clone(), shifts.clone()
            chs[:, e] = _roll_each(ch, k)
            cum[:, e] = gain
            # the lag as a signed shift in [-max_shift, max_shift], summed over sweeps
            shifts[:, e] += torch.where(k > n // 2, k - n, k)
    return chs, shifts, refit_event_gains(target, chs, ridge=ridge)


def make_streaming_fn(model: SIAMModel):
    """``stream(audio, noise=None, generator=None, ...)``: the half-overlap
    window walk over (1, 1, n) audio of any length, windows of
    ``model.n_samples`` every half window.

    ``mode``:

    - ``"handoff"`` (default): window k encodes the transform of ``(audio
      slice - decoded so far) * fade_tail``, the subtraction done in the
      time domain where it is exact;
    - ``"spec"``: one transform of the whole audio; each window's residual
      spectrogram is written back in place (the reference's convention);
    - ``"pristine"`` (or ``pristine_windows=True``): every window encoded
      as a standalone fade-tailed slice, no handoff.

    ``noise``: (n_windows, n_events, 1, 1, noise_size), one draw per
    window and event; with ``fixed_noise`` every window takes the same
    (n_events, 1, 1, noise_size) draw (a checkpoint trained with a pinned
    noise draw needs this). Without ``noise`` the draws come from
    ``generator``. ``refit_gains_against``: re-project every (window,
    event) channel's amplitude against this (1, 1, n) target before the
    sum (``align_refine`` > 0: shift and gain refinement within that many
    samples). Returns the (1, 1, n) decode, with ``return_event_vectors``
    also the vectors, schedules and channels of every window and event.
    """
    window_size = model.n_samples
    frame_window = model.n_frames
    frame_step = frame_window // 2
    step_samples = model.transform_step_size
    iterative = make_iterative_fn(model)

    @torch.no_grad()
    def stream(audio: torch.Tensor, noise: Optional[torch.Tensor] = None,
               generator: torch.Generator | None = None, return_event_vectors: bool = False,
               fixed_noise: bool = False, refit_gains_against: Optional[torch.Tensor] = None,
               refit_ridge: float = 1e-3, align_refine: int = 0, pristine_windows: bool = False,
               mode: str = "handoff"):
        if pristine_windows:
            mode = "pristine"
        if mode not in ("handoff", "spec", "pristine"):
            raise ValueError(f"unknown streaming mode {mode!r}")
        if noise is None and generator is None:
            raise ValueError("a walk needs noise or a generator")
        samps = audio.shape[-1]
        spec = model.transform(audio).clone()
        starts = list(range(0, spec.shape[-1] - frame_window, frame_step))
        if noise is None and fixed_noise:
            noise = draw_noise(model, (model.n_events, 1), generator)
        fade = fade_tail(window_size, device=audio.device).to(audio.dtype)
        dev, dtype = audio.device, audio.dtype
        segments = torch.zeros((1, model.n_events, samps + window_size), dtype=dtype, device=dev)
        decoded = torch.zeros((1, 1, samps + window_size), dtype=dtype, device=dev)
        all_vecs, all_times, all_events = [], [], []
        for w, i in enumerate(starts):
            s = i * step_samples
            nz = noise if (noise is None or fixed_noise) else noise[w]
            if mode == "spec":
                channels, vecs, schedules, residual = iterative(
                    spec[:, :, i: i + frame_window], nz, generator, do_transform=False)
                spec[:, :, i: i + frame_window] = residual
            else:
                win = audio[..., s: s + window_size]
                if mode == "handoff":
                    d = decoded[..., s: s + window_size]
                    win = win - d
                channels, vecs, schedules, _ = iterative(
                    model.transform(win * fade), nz, generator, do_transform=False)
                if mode == "handoff":
                    decoded[..., s: s + window_size] = d + torch.sum(channels, dim=1,
                                                                     keepdim=True)
            segments[..., s: s + window_size] += channels
            all_vecs.append(vecs)
            all_times.append(schedules)
            all_events.append(channels)

        final = torch.sum(segments, dim=1, keepdim=True)[..., :samps]
        if refit_gains_against is not None:
            # every (window, event) channel at its absolute position, so that
            # each gets its own gain
            tracks = torch.zeros((1, len(starts) * model.n_events, samps + window_size),
                                 dtype=dtype, device=dev)
            for w, (i, ch) in enumerate(zip(starts, all_events)):
                s = i * step_samples
                tracks[:, w * model.n_events:(w + 1) * model.n_events, s: s + window_size] = ch
            tracks = tracks[..., :samps]
            if align_refine:
                tracks, _, gains = refine_event_alignment(
                    refit_gains_against, tracks, max_shift=align_refine, ridge=refit_ridge)
            else:
                gains = refit_event_gains(refit_gains_against, tracks, ridge=refit_ridge)
            with no_tf32():
                final = torch.einsum("be,ben->bn", gains, tracks)[:, None]
        if not return_event_vectors:
            return final
        return (final, torch.cat(all_vecs, dim=1), torch.cat(all_times, dim=1),
                torch.cat(all_events, dim=1))

    return stream


def make_random_sequence_fn(model: SIAMModel):
    """``random_sequence(vecs, normal=None, uniform_draw=None,
    bernoulli=None, noise=None, generator=None) -> (audio (batch, E, n),
    vecs, times)``: render events from (reservoir-sampled) vectors at
    random sparse times. Each event's time is the one-hot sparse softmax of
    a normal draw over the window's first half, scaled by a uniform draw
    and kept with probability 0.5. ``normal``, ``uniform_draw`` and
    ``bernoulli`` (0 or 1), each (batch, E, frames), are those draws, and
    ``noise`` the decoder's (E, batch, 1, noise size); whichever is None is
    drawn from ``generator`` (``mptpu`` splits one key four ways for
    them)."""
    n_events, n_frames = model.n_events, model.n_frames

    @torch.no_grad()
    def random_sequence(vecs: torch.Tensor, normal=None, uniform_draw=None, bernoulli=None,
                        noise=None, generator: torch.Generator | None = None):
        batch = vecs.shape[0]
        shape = (batch, n_events, n_frames)
        dev = vecs.device
        if normal is None:
            normal = torch.randn(shape, generator=generator, device=dev)
        if uniform_draw is None:
            uniform_draw = torch.rand(shape, generator=generator, device=dev)
        if bernoulli is None:
            bernoulli = torch.rand(shape, generator=generator, device=dev) < 0.5
        raw = normal.clone()
        raw[:, :, n_frames // 2:] = 0.0
        times = sparse_softmax(raw, normalize=True, axis=-1)
        times = times * uniform_draw * bernoulli.to(times.dtype)
        if noise is None:
            noise = draw_noise(model, (n_events, batch), generator)
        outs = [model.generate(vecs[:, i: i + 1], times[:, i: i + 1], noise=noise[i])
                for i in range(n_events)]
        return torch.cat(outs, dim=1), vecs, times

    return random_sequence


class Reservoir:
    """Host-side reservoir of recent event vectors for the self-supervised
    previews (numpy, as ``mptpu``'s: the same draws from the same seed)."""

    def __init__(self, size: int, context_dim: int, seed: int = 0):
        self.size = size
        self.buffer = np.zeros((size, context_dim), dtype=np.float32)
        self.rng = np.random.default_rng(seed)

    def update(self, vecs) -> None:
        v = np.asarray(vecs).reshape(-1, self.buffer.shape[1])
        indices = self.rng.permutation(self.size)[: v.shape[0]]
        self.buffer[indices] = v[: len(indices)]

    def sample(self, batch_size: int, n_events: int) -> np.ndarray:
        indices = self.rng.permutation(self.size)[: batch_size * n_events]
        return self.buffer[indices].reshape(batch_size, n_events, self.buffer.shape[1])


def streaming_encode(model: SIAMModel, audio: torch.Tensor, noise: Optional[torch.Tensor] = None,
                     generator: torch.Generator | None = None, **kwargs):
    """One call of :func:`make_streaming_fn` (``kwargs`` are its
    ``stream``'s)."""
    return make_streaming_fn(model)(audio, noise, generator, **kwargs)
