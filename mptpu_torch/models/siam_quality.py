"""The SIAM flagship's quality and throughput run (counterpart of
``scripts/siam_quality.py``): train the reference configuration (2^17
samples, 32 events, batch 2, STFT 2048/256, Adam at 1e-4) on streamed
audio and report

- the step time two ways: with each step's loss read on the host
  (``ms_per_step_synced``) and with one wait at the end
  (``ms_per_step_pipelined``);
- the reconstruction of a held-out segment every ``eval_every`` steps
  (SNR, log-spectral distance, PIF distance, whole and first half) and,
  every ``stream_eval_every`` steps, of a held-out segment three windows
  long through the streaming walk (plain, gain refit, pristine windows);
- ``metrics.json`` (the keys ``scripts/report.py`` reads) and checkpoints.

The loss is the greedy magnitude loss of the decomposition of the unfaded
target against the faded target (the second half of the window faded to 0
unless ``no_fade``), plus with ``waveform_weight`` the first half's relative
waveform error, with ``gain_refit`` taken after the joint gain refit. The
step is :class:`SIAMOverfitStep`'s with this loss: global-norm clip at
5e4, Adam, an optional trust clip, and the gate that keeps the state on a
non-finite loss or gradient norm.

Noise: step ``i`` draws the decoder's noise from a generator seeded
``STEP_SEED + i`` (``mptpu`` folds ``i`` into ``PRNGKey(0)``), so that a
resumed run draws what the uninterrupted one would; ``fixed_noise`` takes
one draw from a generator seeded 42 for every step and eval; the evals
draw from generators seeded 7 and 11 (``mptpu``'s keys).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import convert
from ..config.dotenv import cache_path
from ..data.audioiter import AudioIterator
from ..data.synthetic import ensure_demo_dataset, fresh_segment_stream
from ..device import default_device, no_tf32
from ..losses.iterative import iterative_loss
from ..perceptual import pif_distance
from ..sparse import quantize
from ..train.checkpoint import CheckpointManager, save_checkpoint
from ..utils.jsonio import dump_json
from .siam import (SIAMModel, draw_noise, fade_tail, make_iterative_fn, make_streaming_fn,
                   siam_transform)
from .siam_overfit import (LossSettings, SIAMOverfitStep, lsd_db, siam_overfit_objective,
                           siam_sizes, snr_db)

STEP_SEED = 2**32   # step i's noise generator is seeded STEP_SEED + i
GRAD_CLIP = 5e4


def siam_quality_loss(model: SIAMModel, settings: LossSettings, noise, wave_w: float, f_tgt,
                      tgt, tgt_e_half, generator: Optional[torch.Generator] = None):
    """The script's ``loss_fn``: the decomposition of the unfaded target
    ``tgt`` with the decoder's ``noise``, the magnitude loss against the
    faded ``f_tgt``; with ``wave_w`` the waveform term and the refit of
    :func:`siam_overfit_objective`. Returns (loss, (recon, wave,
    raw_tail))."""
    channels = make_iterative_fn(model)(tgt, noise, generator)[0]
    if wave_w:
        return siam_overfit_objective(channels, settings, wave_w, f_tgt, tgt, tgt_e_half)
    loss = iterative_loss(
        f_tgt, channels,
        lambda x: siam_transform(x, settings.window, settings.step, mag_epsilon=1e-6))
    raw = torch.sum(channels, dim=1, keepdim=True)
    half = channels.shape[-1] // 2
    return loss, (raw, torch.zeros((), device=raw.device), raw[..., half:].detach())


class SIAMQualityStep(SIAMOverfitStep):
    """:class:`SIAMOverfitStep` with :func:`siam_quality_loss`."""

    loss_fn = staticmethod(siam_quality_loss)


def quality_model(tiny: bool = False, medium: bool = False, device=None, attn_floor: float = 0.0,
                  attn_leak: float = 0.0, switch_clamp: float = 100.0,
                  residual_clamp: float = 4.0, encoder_clamp: float = 1e4,
                  switch_bias_init: float = 0.0, spectral_skip: bool = False,
                  spectral_filter: bool = False):
    """(the run's model, its sizes): the reference configuration, or
    ``medium``'s (2^15 samples, 16 events, hidden 64) or ``tiny``'s, from a
    generator seeded 0; the flags' defaults are the script's."""
    if medium and not tiny:
        sz = siam_sizes(n_samples_log2=15, n_events=16, hidden=64)
    else:
        sz = siam_sizes(tiny)
    window = sz["window"]
    model = SIAMModel(
        n_samples=sz["n_samples"], context_dim=sz["context_dim"], in_channels=window // 2 + 1,
        hidden_channels=sz["hidden"], n_events=sz["n_events"], transform_window_size=window,
        transform_step_size=sz["step"], fft_resonance=True, attn_floor=attn_floor,
        attn_leak=attn_leak, switch_clamp=switch_clamp, residual_clamp_scale=residual_clamp,
        encoder_clamp=encoder_clamp, switch_bias_init=switch_bias_init,
        spectral_skip=spectral_skip, spectral_filter=spectral_filter,
        generator=torch.Generator().manual_seed(0), device=default_device(device))
    return model, sz


def step_noise(model: SIAMModel, i: int, batch: int, device=None) -> torch.Tensor:
    """Step ``i``'s decoder noise (n_events, batch, 1, noise size): a draw
    from a generator seeded ``STEP_SEED + i`` on ``device`` (the model's
    when None)."""
    dev = device or next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(STEP_SEED + i)
    return draw_noise(model, (model.n_events, batch), gen)


def spectral_metrics(target, recon, window: int, step: int):
    """(SNR, log-spectral distance) in dB."""
    return float(snr_db(target, recon)), float(lsd_db(target, recon, window, step))


@dataclass
class SIAMQualityRun:
    """One run's model, trainer and inputs; ``step(i, batch)`` is the loop's
    step ``i`` on ``batch`` (its noise drawn for ``i``), returning the loss
    as a tensor on the device."""

    model: SIAMModel
    trainer: SIAMQualityStep
    fade: torch.Tensor
    wave_w: float
    fixed_noise: Optional[torch.Tensor]
    knobs: tuple = (0.0, 0.0)   # the selection leak and floor

    def noise(self, i: int, batch: int) -> torch.Tensor:
        if self.fixed_noise is not None:
            return self.fixed_noise[:, :batch]
        return step_noise(self.model, i, batch)

    def step(self, i: int, batch: torch.Tensor) -> torch.Tensor:
        half = batch.shape[-1] // 2
        with quantize.selection_knobs(*self.knobs):
            loss, _, _, _, _ = self.trainer.step(
                self.noise(i, batch.shape[0]), self.wave_w, GRAD_CLIP, 1.0, batch * self.fade,
                batch, torch.sum(batch[..., :half] ** 2))
        return loss


@dataclass
class SIAMQualityResult:
    """What :func:`run_siam_quality` leaves: the run, ``metrics.json``'s
    dict, every step's loss as (step, loss), and on resume (the step
    resumed from, the parameters and the optimiser state as restored)."""

    run: SIAMQualityRun
    metrics: dict
    step_losses: List[tuple] = field(default_factory=list)
    resumed: Optional[tuple] = None


def run_siam_quality(
    out: str, iterations: int = 2000, batch_size: int = 2, eval_every: int = 250,
    stream_eval_every: int = 1000, timing_steps: int = 100, attn_floor: float = 0.0,
    switch_clamp: float = 100.0, residual_clamp: float = 4.0, encoder_clamp: float = 1e4,
    attn_leak: float = 0.0, waveform_weight: float = 0.0, selection_leak: float = 0.0,
    selection_floor: float = 0.0, switch_bias_init: float = 0.0, lr: float = 1e-4,
    fixed_noise: bool = False, gain_refit: float = 0.0, gain_reg: float = 0.0, b2: float = 0.999,
    trust_ratio: float = 0.0, watchdog_s: int = 14000, medium: bool = False, tiny: bool = False,
    resume: bool = False, dense: bool = False, fresh_corpus: bool = False,
    spectral_skip: bool = False, spectral_filter: bool = False, no_fade: bool = False,
    audio_path: Optional[str] = None, stream=None, device=None,
    log: Callable[[str], None] = print,
) -> SIAMQualityResult:
    """``scripts/siam_quality.py``'s ``main`` as a function writing into
    ``out``: its flags are the keywords (``watchdog_s`` is the run's time
    budget; the stall watchdog is the caller's). The port's own:

    - ``dense`` corpora go under the cache directory
      (``config.cache_path()``: ``dense_corpus`` and
      ``dense_corpus_holdout``), not under ``trained_weights``;
    - ``stream``: the training batches ((batch, 1, n) arrays or tensors),
      in place of the corpus's or the fresh stream; ``audio_path`` the
      corpus otherwise (the demo corpus when None);
    - the parameters come from a generator seeded 0;
    - ``device``: ``cuda`` unless ``"cpu"`` is asked for; ``log``: where
      the script's lines go.
    """
    dev = default_device(device)
    os.makedirs(out, exist_ok=True)
    # the knobs as a fresh process of the script has them, whatever the caller set
    with quantize.selection_knobs(selection_leak, selection_floor):
        return _run(locals(), dev)


def _run(a: dict, dev: torch.device) -> SIAMQualityResult:
    out, log = a["out"], a["log"]
    t0 = time.perf_counter()
    model, sz = quality_model(
        a["tiny"], a["medium"], dev, attn_floor=a["attn_floor"], attn_leak=a["attn_leak"],
        switch_clamp=a["switch_clamp"], residual_clamp=a["residual_clamp"],
        encoder_clamp=a["encoder_clamp"], switch_bias_init=a["switch_bias_init"],
        spectral_skip=a["spectral_skip"], spectral_filter=a["spectral_filter"])
    n_samples, n_events, window, step_sz = (sz[k] for k in ("n_samples", "n_events", "window",
                                                            "step"))
    init_s = time.perf_counter() - t0
    log(f"init {init_s:.1f}s")

    dense = a["dense"] or a["fresh_corpus"]
    audio_path, holdout_path = a["audio_path"], None
    if dense:
        audio_path = ensure_demo_dataset(os.path.join(cache_path(), "dense_corpus"), n_files=6,
                                         seconds=24.0, dense=True)
        # held-out content: seeds disjoint from every training file
        holdout_path = ensure_demo_dataset(os.path.join(cache_path(), "dense_corpus_holdout"),
                                           n_files=2, seconds=24.0, dense=True,
                                           seed_offset=1000)
    holdout = next(iter(AudioIterator(1, n_samples, normalize=True, seed=987654,
                                      audio_path=holdout_path or audio_path, device=dev)))
    # three windows long, for the streaming walk
    stream_holdout = next(iter(AudioIterator(1, 3 * n_samples, normalize=True, seed=13579,
                                             audio_path=holdout_path or audio_path, device=dev)))

    fade = (torch.ones((1, 1, n_samples), device=dev) if a["no_fade"]
            else fade_tail(n_samples, device=dev))
    settings = LossSettings(window, step_sz, a["gain_refit"], a["gain_reg"])
    trainer = SIAMQualityStep(model, settings, lr=a["lr"], b2=a["b2"],
                              trust_ratio=a["trust_ratio"])
    fixed = None
    if a["fixed_noise"]:
        fixed = draw_noise(model, (n_events, a["batch_size"]),
                           torch.Generator(device=dev).manual_seed(42))
    run = SIAMQualityRun(model, trainer, fade, float(a["waveform_weight"]), fixed,
                         (a["selection_leak"], a["selection_floor"]))
    ckpt = CheckpointManager(out, every=250)
    resume_step, resumed = 0, None
    if a["resume"]:
        payload = ckpt.latest()
        if payload is not None:
            convert.siam_from_flax(model, payload["params"])
            if payload["opt_state"] is not None:
                trainer.load_opt_state_tree(payload["opt_state"])
            resume_step = payload["step"]
            resumed = (resume_step, *trainer.snapshot())
            log(f"resumed from step {resume_step}")

    eval_noise = fixed[:, :1] if fixed is not None else draw_noise(
        model, (n_events, 1), torch.Generator(device=dev).manual_seed(7))
    walk = make_streaming_fn(model)

    if a["stream"] is not None:
        stream = (torch.as_tensor(b).to(dev) for b in a["stream"])
    elif a["fresh_corpus"]:
        # a resumed run goes on into unseen seeds
        stream = (torch.from_numpy(b).to(dev) for b in fresh_segment_stream(
            a["batch_size"], n_samples, seed_base=1_000_000 + resume_step * a["batch_size"]))
    else:
        stream = iter(AudioIterator(batch_size=a["batch_size"], n_samples=n_samples,
                                    samplerate=22050, normalize=True, seed=1,
                                    audio_path=audio_path, device=dev))

    losses_dev: List[tuple] = []

    def step(i):
        loss = run.step(i, next(stream))
        losses_dev.append((i, loss))
        return loss

    # the first step and one more (not on resume: they would change the
    # restored state before any recorded step)
    compile_s = 0.0
    if not a["resume"]:
        t0 = time.perf_counter()
        first_loss = float(step(0))
        compile_s = time.perf_counter() - t0
        log(f"first step (incl compile) {compile_s:.1f}s loss {first_loss:.1f}")
        float(step(1))

    metrics = {
        "config": (
            f"n_samples 2^{int(np.log2(n_samples))}, {n_events} events, "
            f"batch {a['batch_size']}, STFT {window}/{step_sz}, "
            f"attn_floor {a['attn_floor']:.3f}, attn_leak {a['attn_leak']:.3f}, "
            f"switch_clamp {a['switch_clamp']:g}, residual_clamp {a['residual_clamp']:g}, "
            f"waveform_weight {a['waveform_weight']:g}, "
            f"selection_leak {a['selection_leak']:g}, selection_floor {a['selection_floor']:g}, "
            f"switch_bias_init {a['switch_bias_init']:g}, lr {a['lr']:g}, "
            f"spectral_skip {a['spectral_skip']}, spectral_filter {a['spectral_filter']}, "
            f"corpus {'fresh-infinite' if a['fresh_corpus'] else ('dense' if dense else 'sparse')}, "
            f"fade {'off' if a['no_fade'] else 'on'}, fixed_noise {a['fixed_noise']}, "
            f"b2 {a['b2']:g}, trust_ratio {a['trust_ratio']:g}, "
            f"gain_refit {a['gain_refit']:g}, gain_reg {a['gain_reg']:g}, "
            f"holdout {'disjoint-content' if holdout_path else 'same-corpus crop'}"
        ),
        "init_s": round(init_s, 1),
        "first_step_s": round(compile_s, 1),
        "eval": [],
    }
    prior_losses = []
    if a["resume"]:
        # the original run's record goes on across resumes
        try:
            with open(os.path.join(out, "metrics.json")) as f:
                prior = json.load(f)
            metrics["eval"] = prior.get("eval", [])
            prior_losses = prior.get("losses", [])
            for k in ("first_step_s", "ms_per_step_synced", "ms_per_step_pipelined"):
                if prior.get(k):
                    metrics[k] = prior[k]
        except (OSError, ValueError):
            pass

    timing_steps = 0 if a["resume"] else a["timing_steps"]
    if timing_steps:
        # each step's loss read on the host
        t0 = time.perf_counter()
        acc = 0.0
        for i in range(timing_steps):
            acc += float(step(100 + i))
        synced = (time.perf_counter() - t0) / timing_steps
        log(f"per-step-synced: {synced*1e3:.1f} ms/step ({1/synced:.2f} steps/s, mean loss "
            f"{acc/timing_steps:.1f})")
        # one wait at the end
        t0 = time.perf_counter()
        for i in range(timing_steps):
            loss = step(300 + i)
        float(loss)
        pipelined = (time.perf_counter() - t0) / timing_steps
        log(f"pipelined: {pipelined*1e3:.1f} ms/step ({1/pipelined:.2f} steps/s)")
        metrics["ms_per_step_synced"] = round(synced * 1e3, 1)
        metrics["ms_per_step_pipelined"] = round(pipelined * 1e3, 1)

    def write_metrics():
        with open(os.path.join(out, "metrics.json"), "w") as f:
            dump_json({**metrics, "losses": prior_losses + losses}, f, indent=1)

    step0 = max(2 + 2 * timing_steps, resume_step + 1)
    losses = []
    run_start = time.perf_counter()
    last_i = step0
    for i in range(step0, a["iterations"]):
        last_i = i
        loss = step(i)
        if i % 25 == 0:
            l = float(loss)
            losses.append([i, round(l, 2)])
            log(f"iter {i} loss {l:.2f}")
        if i % a["eval_every"] == 0:
            entry = evaluate(run, i, holdout, stream_holdout, eval_noise, walk, a, window,
                             step_sz)
            metrics["eval"].append(entry)
            log("eval " + json.dumps(entry))
            write_metrics()
        if i % ckpt.every == 0:
            ckpt.maybe_save(i, trainer.flax_variables(), trainer.opt_state_tree())
        if time.perf_counter() - run_start > a["watchdog_s"]:
            log("time budget reached — exiting cleanly")
            break
        if os.path.exists(os.path.join(out, "STOP")):
            log("STOP file found — exiting cleanly")
            break

    # the final parameters always (the periodic save fires on multiples of
    # ``every`` only)
    final_step = max(last_i, step0)
    save_checkpoint(os.path.join(out, f"ckpt_{final_step:09d}.pkl"), trainer.flax_variables(),
                    trainer.opt_state_tree(), final_step)
    write_metrics()
    log("done")
    step_losses = []
    if losses_dev:
        values = torch.stack([v.detach().float() for _, v in losses_dev]).cpu().tolist()
        step_losses = [(i, v) for (i, _), v in zip(losses_dev, values)]
    return SIAMQualityResult(run, metrics, step_losses, resumed)


@torch.no_grad()
def evaluate(run: SIAMQualityRun, i: int, holdout, stream_holdout, eval_noise, walk, a: dict,
             window: int, step_sz: int) -> dict:
    """The script's eval entry at step ``i``: the held-out segment's
    decode, whole and first half, and every ``stream_eval_every`` steps the
    three streaming walks over the long held-out segment."""
    model = run.model
    half = model.n_samples // 2
    with no_tf32():
        channels, _, schedules, _ = make_iterative_fn(model)(holdout, eval_noise)
        recon = torch.sum(channels, dim=1, keepdim=True)
        snr, lsd = spectral_metrics(holdout, recon, window, step_sz)
        # the encoder's mask confines a window's events to its first half:
        # first-half metrics are the single-window codec's quality
        snr_h, lsd_h = spectral_metrics(holdout[..., :half], recon[..., :half], window, step_sz)
        entry = {
            "step": i,
            "holdout_snr_db": round(snr, 3),
            "holdout_lsd_db": round(lsd, 3),
            "first_half_snr_db": round(snr_h, 3),
            "first_half_lsd_db": round(lsd_h, 3),
            "recon_rms": round(float(torch.sqrt(torch.mean(recon**2))), 6),
            "first_half_pif_dist": round(float(pif_distance(holdout[..., :half],
                                                            recon[..., :half])), 4),
            # 0.0 when every event is silent
            "sched_max": round(float(torch.max(schedules)), 6),
        }
        if a["stream_eval_every"] and i % a["stream_eval_every"] == 0:
            fixed = run.fixed_noise is not None

            def walk_noise():
                if fixed:
                    return dict(noise=run.fixed_noise[:, :1], fixed_noise=True)
                return dict(generator=torch.Generator(device=holdout.device).manual_seed(11))

            s_recon = walk(stream_holdout, **walk_noise())
            s_snr, s_lsd = spectral_metrics(stream_holdout, s_recon, window, step_sz)
            entry["streaming_snr_db"] = round(s_snr, 3)
            entry["streaming_lsd_db"] = round(s_lsd, 3)
            # the gain refit is part of the codec's encode
            r_recon = walk(stream_holdout, refit_gains_against=stream_holdout, **walk_noise())
            r_snr, r_lsd = spectral_metrics(stream_holdout, r_recon, window, step_sz)
            entry["streaming_refit_snr_db"] = round(r_snr, 3)
            entry["streaming_refit_lsd_db"] = round(r_lsd, 3)
            entry["streaming_refit_pif_dist"] = round(float(pif_distance(stream_holdout,
                                                                         r_recon)), 4)
            # each window encoded as the trainer presents it
            p_recon = walk(stream_holdout, refit_gains_against=stream_holdout,
                           pristine_windows=True, **walk_noise())
            p_snr, p_lsd = spectral_metrics(stream_holdout, p_recon, window, step_sz)
            entry["streaming_pristine_snr_db"] = round(p_snr, 3)
            entry["streaming_pristine_lsd_db"] = round(p_lsd, 3)
    return entry
