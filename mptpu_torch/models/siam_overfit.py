"""The SIAM overfit trainer (counterpart of ``scripts/siam_overfit.py``,
the trainer that made the sw6 checkpoint): fit the codec to one segment,
or to the half-overlap windows of a longer one, until its reconstruction
SNR is clearly positive.

The loss is the greedy magnitude loss (``iterative_loss`` over
``siam_transform``) plus, with ``waveform_weight``, the relative waveform
error of the first half, with ``gain_refit`` taken after a joint least-
squares refit of the event gains. The step (:class:`SIAMOverfitStep`) is
``mptpu``'s jitted one in eager PyTorch: global-norm clip and ``lr_mult``
scale the gradients, Adam in optax's form (``train.optim.adam_update``),
an optional per-parameter trust clip, and a gate that keeps the
parameters, the optimiser state, the EMA and the handoff tail when the
loss or the gradient norm is not finite. Nothing in a step is read on the
host: :func:`overfit_siam` reads each step's scalars one step late, while
the next step runs, as ``mptpu`` does.

The decoder's noise is passed in: with ``fixed_noise`` every step, eval
and walk takes the one draw ``noise`` ((n_events, 1, 1, noise size);
``mptpu`` folds event ``i`` into ``PRNGKey(42)``), else the steps draw from
a generator.

Snapshots are clones: ``mptpu``'s arrays are immutable and it snapshots by
reference, but the port's parameters change in place, so a rollback to a
reference would restore the poisoned state.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import convert
from ..data.synthetic import streaming_windows, synthetic_audio
from ..device import default_device, no_tf32
from ..losses.iterative import iterative_loss
from ..ops.kinks import clip
from ..ops.windows import linspace
from ..perceptual import pif_distance
from ..sparse import quantize
from ..train.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from ..train.guard import StormGuard
from ..train.optim import (Adam, adam_state_from_tree, adam_state_tree, apply_gated, global_norm,
                           trust_ratio_clip)
from ..utils.jsonio import dump_json
from ..utils.wav import write_wav
from .siam import (SIAMModel, _integer_pow, draw_noise, fade_tail, make_iterative_fn,
                   make_streaming_fn, refine_event_alignment, refit_event_gains, siam_transform)


def snr_db(target: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """10 log10(energy of ``target`` / energy of the error), each floored
    at 1e-12."""
    return 10.0 * torch.log10(clip(torch.sum(target**2), 1e-12)
                              / clip(torch.sum((target - recon) ** 2), 1e-12))


def lsd_db(target: torch.Tensor, recon: torch.Tensor, window: int, step: int) -> torch.Tensor:
    """Log-spectral distance in dB between the magnitude STFTs."""
    ts = siam_transform(target, window, step)
    rs = siam_transform(recon, window, step)
    return torch.sqrt(torch.mean((20 * torch.log10(ts + 1e-8) - 20 * torch.log10(rs + 1e-8)) ** 2))


def pif_dist(target: torch.Tensor, recon: torch.Tensor) -> float:
    """Phase-invariant perceptual distance (lower is better, 1 against
    silence)."""
    return float(pif_distance(target, recon))


def siam_sizes(tiny: bool = False, n_samples_log2: int = 0, n_events: int = 0, hidden: int = 0,
               context_dim: int = 0) -> dict:
    """The script's sizes: the reference configuration (2^17 samples, 32
    events, hidden 128, context 32, STFT 2048/256), or ``tiny``'s (2^13, 4,
    32, 16, 512/256), each overridable."""
    if tiny:
        sizes = dict(n_samples=2**13, n_events=4, hidden=32, context_dim=16, window=512, step=256)
    else:
        sizes = dict(n_samples=2**17, n_events=32, hidden=128, context_dim=32, window=2048,
                     step=256)
    if n_samples_log2:
        sizes["n_samples"] = 2**n_samples_log2
    for k, v in (("n_events", n_events), ("hidden", hidden), ("context_dim", context_dim)):
        sizes[k] = v or sizes[k]
    return sizes


def refit_recon(channels: torch.Tensor, tgt: torch.Tensor, half: int, ridge: float,
                stop_grad: bool = False):
    """The first half's joint gain refit, the gains clipped to +-10 (as
    ``jnp.clip``, half the gradient at a bound); ``stop_grad`` takes them
    as constants in the backward, whose solve is ill-conditioned when
    events have collapsed onto near-collinear channels. Returns (recon
    (batch, 1, n), gains (batch, E))."""
    gains = clip(refit_event_gains(tgt, channels, ridge=ridge, span=half), -10.0, 10.0)
    if stop_grad:
        gains = gains.detach()
    with no_tf32():
        recon = torch.einsum("be,ben->bn", gains, channels)[:, None]
    return recon, gains


@dataclass
class LossSettings:
    """The loss's flags: STFT window and step, the gain refit's ridge (0 =
    off), ``gain_reg`` (pull the alive events' refit gains toward 1) and
    ``refit_stop_grad``."""

    window: int
    step: int
    gain_refit: float = 0.0
    gain_reg: float = 0.0
    refit_stop_grad: bool = False


def siam_overfit_objective(channels: torch.Tensor, settings: LossSettings, wave_w, f_tgt, tgt,
                           tgt_e_half):
    """The loss of decoded ``channels`` (batch, E, n): (loss, (recon,
    wave, raw_tail)). The magnitude loss is against the window's faded
    input ``f_tgt``, the waveform term (``wave_w`` times the first half's
    error over ``tgt_e_half``) against ``tgt``; ``raw_tail``, the raw
    decode's second half without gradient, is what the walk hands the next
    window."""
    half = channels.shape[-1] // 2
    loss = iterative_loss(
        f_tgt, channels,
        lambda x: siam_transform(x, settings.window, settings.step, mag_epsilon=1e-6))
    raw = torch.sum(channels, dim=1, keepdim=True)
    recon = raw
    if settings.gain_refit:
        recon, gains = refit_recon(channels, tgt, half, settings.gain_refit,
                                   settings.refit_stop_grad)
        if settings.gain_reg:
            # only alive events: a dead channel's gain is ~0 by the ridge, and
            # pulling it to 1 would fight the selection floor
            alive = torch.sum(channels[..., :half] ** 2, dim=-1) > 1e-12
            loss = loss + settings.gain_reg * torch.sum(
                torch.where(alive, (gains - 1.0) ** 2, torch.zeros_like(gains))
            ) / torch.clamp_min(torch.sum(alive), 1)
    wave = torch.sum((recon[..., :half] - tgt[..., :half]) ** 2) / clip(tgt_e_half, 1e-12)
    loss = loss + wave_w * wave
    return loss, (recon, wave, raw[..., half:].detach())


def siam_overfit_loss(model: SIAMModel, settings: LossSettings, noise, wave_w, f_tgt, tgt,
                      tgt_e_half, generator: torch.Generator | None = None):
    """``scripts/siam_overfit.py``'s ``loss_fn``: the decomposition of
    ``f_tgt`` with the decoder's ``noise``, then
    :func:`siam_overfit_objective`."""
    channels, _, _, _ = make_iterative_fn(model)(f_tgt, noise, generator)
    return siam_overfit_objective(channels, settings, wave_w, f_tgt, tgt, tgt_e_half)


@contextmanager
def parameters_swapped(model: torch.nn.Module, tensors: Sequence[torch.Tensor]):
    """Run the block with ``tensors`` as the model's parameters (in
    ``named_parameters`` order), no copy either way: the EMA is scored and
    walked through the model's own code."""
    params = list(model.parameters())
    saved = [p.data for p in params]
    try:
        for p, t in zip(params, tensors):
            p.data = t
        yield model
    finally:
        for p, d in zip(params, saved):
            p.data = d


class SIAMOverfitStep:
    """The trainer's state and its jitted pieces in eager PyTorch: the
    model (its parameters updated in place), optax's Adam state, the EMA
    (a list of tensors, averaged when ``ema`` > 0), the loss's settings and
    the optimiser's (``lr``, ``b1`` 0.9, ``b2``, ``trust_ratio``).

    ``step(noise, wave_w, grad_clip, lr_mult, f_tgt, tgt, tgt_e_half)``
    returns (loss, wave, gnorm, ok, raw_tail) as tensors on the device and
    reads nothing on the host. ``reconstruct`` is the eval decode. The
    loss is ``loss_fn``, :func:`siam_overfit_loss` here."""

    loss_fn = staticmethod(siam_overfit_loss)

    def __init__(self, model: SIAMModel, settings: LossSettings, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.999, trust_ratio: float = 0.0, ema: float = 0.0,
                 align_refine: int = 0):
        self.model = model
        self.settings = settings
        self.names = [n for n, _ in model.named_parameters()]
        self.params = list(model.parameters())
        self.opt = Adam(lr, b1, b2)
        self.trust_ratio = trust_ratio
        self.ema_decay = ema
        self.align_refine = align_refine
        self.opt_state = self.opt.init(self.params)
        self.ema = [p.detach().clone() for p in self.params]

    def grads(self, noise, wave_w, f_tgt, tgt, tgt_e_half, generator=None):
        """(loss, aux, gradients), forward and backward in full float32:
        autograd runs the backward after the forward's own ``no_tf32``
        blocks have closed, so both run inside one here."""
        with no_tf32():
            loss, aux = self.loss_fn(self.model, self.settings, noise, wave_w, f_tgt, tgt,
                                     tgt_e_half, generator)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        return loss.detach(), aux, grads

    def step(self, noise, wave_w, grad_clip: float, lr_mult: float, f_tgt, tgt, tgt_e_half,
             generator: torch.Generator | None = None):
        loss, (recon, wave, raw_tail), grads = self.grads(noise, wave_w, f_tgt, tgt, tgt_e_half,
                                                          generator)
        with torch.no_grad():
            gnorm = global_norm(grads)
            scale = lr_mult * torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
            grads = torch._foreach_mul(grads, scale)
            updates, new_opt = self.opt.update(grads, self.opt_state)
            if self.trust_ratio:
                updates = trust_ratio_clip(updates, self.params, self.trust_ratio)
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            # a non-finite step's decode must not poison the handoff chain
            raw_tail = torch.where(ok, raw_tail, torch.zeros_like(raw_tail))
            self.opt_state = apply_gated(self.params, updates, self.opt_state, new_opt, ok)
            if self.ema_decay:
                e = self.ema_decay
                self.ema = [torch.where(ok, e * m + (1.0 - e) * p, m)
                            for m, p in zip(self.ema, self.params)]
        return loss, wave.detach(), gnorm, ok, raw_tail

    @torch.no_grad()
    def reconstruct(self, noise, f_tgt, tgt, params: Optional[Sequence[torch.Tensor]] = None):
        """(raw, refit, aligned, largest schedule value, each event's
        first-half energy (batch, E)) of the model, or of ``params`` (the
        EMA) in its place."""
        if params is not None:
            with parameters_swapped(self.model, params):
                return self.reconstruct(noise, f_tgt, tgt)
        s = self.settings
        with no_tf32():
            channels, _, schedules, _ = make_iterative_fn(self.model)(f_tgt, noise)
            half = channels.shape[-1] // 2
            ev_energy = torch.sum(channels[..., :half] ** 2, dim=-1)
            raw = torch.sum(channels, dim=1, keepdim=True)
            refit = refit_recon(channels, tgt, half, s.gain_refit)[0] if s.gain_refit else raw
            if self.align_refine:
                refined, _, gains = refine_event_alignment(
                    tgt, channels, max_shift=self.align_refine, n_iters=2,
                    ridge=s.gain_refit or 1e-3, span=half)
                aligned = torch.einsum("be,ben->bn", gains, refined)[:, None]
            else:
                aligned = refit
        return raw, refit, aligned, torch.max(schedules), ev_energy

    def snapshot(self):
        """(parameters, optimiser state), cloned: the step changes the
        parameters in place and replaces the optimiser state."""
        return [p.detach().clone() for p in self.params], self.opt_state

    def restore(self, state) -> None:
        params, opt_state = state
        with torch.no_grad():
            for p, s in zip(self.params, params):
                p.copy_(s)
        self.opt_state = opt_state

    def opt_state_tree(self) -> dict:
        """The optimiser state in the port's checkpoint layout
        (``train.optim.adam_state_tree``)."""
        return adam_state_tree(self.opt_state, self.names)

    def load_opt_state_tree(self, tree: dict) -> None:
        self.opt_state = adam_state_from_tree(tree, self.names, self.params[0].device)

    def flax_variables(self, params: Optional[Sequence[torch.Tensor]] = None) -> dict:
        """``mptpu``'s flax variables of the model or of ``params``."""
        if params is None:
            return convert.module_to_flax(self.model)
        with parameters_swapped(self.model, params):
            return convert.module_to_flax(self.model)


class _LaggedRead:
    """One step's scalars copied to the host without blocking: the copy is
    queued behind the step's work, and ``get`` (a step later) waits for
    that copy alone."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        stats = torch.stack([t.detach().reshape(()).to(torch.float32) for t in tensors])
        if stats.is_cuda:
            self.host = torch.empty(stats.shape, dtype=stats.dtype, pin_memory=True)
            self.host.copy_(stats, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = stats.clone(), None

    def get(self) -> List[float]:
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()


class ArtifactSink:
    """Which of a run's files should be kept beyond the run
    (``--commit-artifacts``' rule, without ``git``): at each call
    ``metrics.json`` and ``storm.log`` when it exists, and ``paths`` (the
    best checkpoints) at most once every ``MIN_INTERVAL_S`` seconds of
    ``clock`` unless ``force``. The list goes to ``on_artifacts``; an error
    there is logged, never raised, so that bookkeeping cannot end a run."""

    MIN_INTERVAL_S = 900.0

    def __init__(self, out: str, on_artifacts: Optional[Callable[[List[str]], None]],
                 clock: Callable[[], float] = time.time, log: Callable[[str], None] = print):
        self.out = out
        self.on_artifacts = on_artifacts
        self.clock = clock
        self.log = log
        self.last = 0.0

    def __call__(self, paths: Sequence[str] = (), force: bool = False) -> None:
        if self.on_artifacts is None:
            return
        now = self.clock()
        to_add = [os.path.join(self.out, "metrics.json")]
        slog = os.path.join(self.out, "storm.log")
        if os.path.exists(slog):
            to_add.append(slog)
        if paths and (force or now - self.last > self.MIN_INTERVAL_S):
            to_add += [p for p in paths if os.path.exists(p)]
            self.last = now
        try:
            self.on_artifacts(to_add)
        except Exception as e:   # a run's bookkeeping must not end it
            self.log(f"on_artifacts failed: {e!r}")


# scripts/siam_overfit.py's flags that sw6 ran with (its metrics.json "config")
SW6 = dict(lr=3e-4, attn_floor=0.01, attn_leak=0.1, waveform_weight=2000.0, fixed_noise=True,
           switch_bias_init=1.0, selection_leak=0.02, selection_floor=0.02, eval_regress_db=2.0,
           gain_refit=1e-3, align_refine=256, ema=0.999, audio_events=12, stream_windows=3,
           balance_windows=True, b2=0.999, vec_clamp=10.0, gain_reg=10.0, seed=3)


@dataclass
class SIAMOverfitResult:
    """What :func:`overfit_siam` leaves: the trainer (model, optimiser
    state, EMA), ``metrics.json``'s dict, every host-read step as (step,
    loss, wave, gnorm, ok), and the host clock at the start of each
    iteration."""

    trainer: SIAMOverfitStep
    metrics: dict
    steps: List[tuple] = field(default_factory=list)
    iter_starts: List[float] = field(default_factory=list)
    last_step: int = 0


def overfit_siam(
    iterations: int = 20000, eval_every: int = 100, lr: float = 3e-4, attn_floor: float = 0.01,
    attn_leak: float = 0.1, waveform_weight: float = 0.0, switch_clamp: float = 20.0,
    grad_clip: float = 1e3, spike_thresh: float = 1e5, residual_clamp: float = 4.0,
    encoder_clamp: float = 1e4, switch_bias_init: float = 0.0, selection_leak: float = 0.0,
    selection_floor: float = 0.0, gain_refit: float = 0.0, align_refine: int = 0,
    ema: float = 0.0, residual_handoff: int = 0, walk_eval_every: int = 0, b2: float = 0.999,
    trust_ratio: float = 0.0, gain_reg: float = 0.0, balance_windows: bool = False,
    stream_windows: int = 1, fixed_noise: bool = False, tiny: bool = False,
    n_samples_log2: int = 0, n_events: int = 0, audio_events: int = 0, hidden: int = 0,
    context_dim: int = 0, seed: int = 3, out: str = "trained_weights/siam_overfit",
    watchdog_s: int = 12600, target_snr: float = 0.0, eval_catastrophe_db: float = 6.0,
    eval_regress_db: float = 0.0, resume: bool = False, spectral_skip: bool = False,
    refit_stop_grad: bool = False, vec_clamp: float = 0.0, lr_floor: float = 0.0,
    lr_recover_steps: int = 250, spectral_filter: bool = False, grad_anatomy_from: int = 0,
    holdout_eval: bool = False, init_from: Optional[str] = None,
    noise: Optional[torch.Tensor] = None, device=None, log: Callable[[str], None] = print,
    on_artifacts: Optional[Callable[[List[str]], None]] = None,
) -> SIAMOverfitResult:
    """``scripts/siam_overfit.py``'s ``main`` as a function: its flags are
    the keywords (the stall watchdog is the caller's). The port's own:

    - ``noise``: the fixed draw (n_events, 1, 1, noise size) that
      ``fixed_noise`` uses for every step, eval and walk; drawn from a
      generator seeded 0 when None. Without ``fixed_noise`` the steps
      draw from that generator and the evals and walks from generators
      seeded 7 and 11 (``mptpu``'s keys), one draw each. The parameters
      come from a generator seeded 0 (``init_from`` and ``resume`` load
      over them);
    - ``device``: ``cuda`` unless ``"cpu"`` is asked for; ``log``: where
      the script's lines go;
    - ``on_artifacts``: ``--commit-artifacts`` without ``git``: called with
      the files to keep (:class:`ArtifactSink`'s rule) at every write of
      ``metrics.json``, at each new best checkpoint and at the end.

    Writes ``metrics.json``, ``target.wav``, the best WAVs,
    ``ema_best.pkl`` and ``walk_best.pkl`` (params as ``mptpu``'s flax
    variables, loadable by ``mptpu`` and by the port's ``SIAMCodec``) and
    checkpoints every 250 steps (the optimiser state in the port's layout,
    ``SIAMOverfitStep.opt_state_tree``) under ``out``.
    """
    dev = default_device(device)
    os.makedirs(out, exist_ok=True)
    knobs = (quantize.RELU_SELECTION_LEAK, quantize.RELU_SELECTION_FLOOR)
    if selection_leak or selection_floor:
        quantize.set_selection_leak(selection_leak)
        quantize.set_selection_floor(selection_floor)
    try:
        return _overfit(locals(), dev)
    finally:
        quantize.set_selection_leak(knobs[0])
        quantize.set_selection_floor(knobs[1])


def _overfit(a: dict, dev: torch.device) -> SIAMOverfitResult:
    sz = siam_sizes(a["tiny"], a["n_samples_log2"], a["n_events"], a["hidden"], a["context_dim"])
    n_samples, n_events, window, step_sz = (sz[k] for k in ("n_samples", "n_events", "window",
                                                            "step"))
    out, log = a["out"], a["log"]
    model = SIAMModel(
        n_samples=n_samples, context_dim=sz["context_dim"], in_channels=window // 2 + 1,
        hidden_channels=sz["hidden"], n_events=n_events, transform_window_size=window,
        transform_step_size=step_sz, fft_resonance=True, attn_floor=a["attn_floor"],
        attn_leak=a["attn_leak"], switch_clamp=a["switch_clamp"],
        residual_clamp_scale=a["residual_clamp"], encoder_clamp=a["encoder_clamp"],
        switch_bias_init=a["switch_bias_init"], spectral_skip=a["spectral_skip"],
        spectral_filter=a["spectral_filter"], vec_clamp=a["vec_clamp"],
        generator=torch.Generator().manual_seed(0), device=dev)

    # one fixed dense segment, and its half-overlap windows
    half = n_samples // 2
    n_win = max(1, a["stream_windows"])
    total_len = n_samples + (n_win - 1) * half
    base_events = a["audio_events"] or int(n_samples / 22050 * 8)
    seg = synthetic_audio(total_len, 22050, n_events=int(round(base_events * total_len / n_samples)),
                          seed=a["seed"], sustained=True)
    targets = torch.from_numpy(streaming_windows(seg, n_samples, n_win).copy()).to(dev)
    targets = targets.reshape(n_win, 1, 1, n_samples)
    target = targets[0]
    write_wav(os.path.join(out, "target.wav"), seg, 22050)
    holdout = None
    if a["holdout_eval"]:
        ho = synthetic_audio(n_samples, 22050, n_events=base_events, seed=a["seed"] + 100000,
                             sustained=True)
        holdout = torch.from_numpy(ho.copy()).to(dev).reshape(1, 1, n_samples)

    settings = LossSettings(window, step_sz, a["gain_refit"], a["gain_reg"], a["refit_stop_grad"])
    trainer = SIAMOverfitStep(model, settings, lr=a["lr"], b2=a["b2"],
                              trust_ratio=a["trust_ratio"], ema=a["ema"],
                              align_refine=a["align_refine"])
    ckpt = CheckpointManager(out, every=250)
    start_step = 0
    if a["init_from"]:
        payload = load_checkpoint(a["init_from"])
        if payload is None:
            raise FileNotFoundError(f"no loadable checkpoint at {a['init_from']}")
        convert.siam_from_flax(model, payload["params"])
        log(f"params initialized from {a['init_from']} (step {payload['step']})")
    if a["resume"]:
        payload = ckpt.latest()
        if payload is not None:
            convert.siam_from_flax(model, payload["params"])
            if payload["opt_state"] is not None:
                trainer.load_opt_state_tree(payload["opt_state"])
            start_step = payload["step"] + 1
            log(f"resumed from step {payload['step']}")
    # the EMA restarts from the (loaded) parameters: an eval-side average,
    # not checkpointed
    trainer.ema = [p.detach().clone() for p in trainer.params]

    fade = fade_tail(n_samples, device=dev)
    faded_targets = targets * fade
    faded_target = faded_targets[0]
    tgt_energy_halves = torch.sum(targets[..., :half] ** 2, dim=(-1, -2, -3))
    target_energy_half = tgt_energy_halves[0]

    step_gen = torch.Generator(device=dev).manual_seed(0)
    noise = a["noise"]
    if noise is None:
        noise = draw_noise(model, (n_events, 1), step_gen)
    noise = noise.to(dev)
    eval_noise = noise if a["fixed_noise"] else draw_noise(
        model, (n_events, 1), torch.Generator(device=dev).manual_seed(7))
    wave_w = torch.tensor(a["waveform_weight"], dtype=torch.float32, device=dev)

    cfg_line = (
        f"overfit 1 segment seed {a['seed']}, n_samples 2^{int(np.log2(n_samples))}, "
        f"{n_events} events, STFT {window}/{step_sz}, lr {a['lr']}, attn_floor "
        f"{a['attn_floor']}, attn_leak {a['attn_leak']}, waveform_weight "
        f"{a['waveform_weight']}, fixed_noise {a['fixed_noise']}, switch_bias_init "
        f"{a['switch_bias_init']}, selection_leak {a['selection_leak']}, selection_floor "
        f"{a['selection_floor']}, eval_regress_db {a['eval_regress_db']}, gain_refit "
        f"{a['gain_refit']}, align_refine {a['align_refine']}, ema {a['ema']}, audio_events "
        f"{a['audio_events'] or 'default(8/sec)'}, stream_windows {n_win}, residual_handoff "
        f"{a['residual_handoff']}, balance_windows {a['balance_windows']}, b2 {a['b2']}, "
        f"trust_ratio {a['trust_ratio']}, spectral_skip {a['spectral_skip']}, vec_clamp "
        f"{a['vec_clamp']}, spectral_filter {a['spectral_filter']}, gain_reg {a['gain_reg']}")
    metrics = {"config": cfg_line, "eval": [], "losses": []}
    if a["resume"]:
        try:
            with open(os.path.join(out, "metrics.json")) as f:
                prior = json.load(f)
            metrics["eval"] = prior.get("eval", [])
            metrics["losses"] = prior.get("losses", [])
            if prior.get("walk"):
                metrics["walk"] = prior["walk"]
            # flags that change the model must survive a resume (as mptpu,
            # vec_clamp is not among those checked)
            pc = prior.get("config", "")
            for flag, cur in (("spectral_skip", a["spectral_skip"]),
                              ("spectral_filter", a["spectral_filter"])):
                if f"{flag} {not cur}" in pc:
                    log(f"WARNING: --resume with {flag}={cur} but the run was recorded with "
                        f"{flag}={not cur} — the model semantics FORK here (stale params are "
                        "silently ignored by flax). Pass the original flag unless the fork is "
                        "intentional.")
        except (IOError, ValueError):
            pass

    keep = ArtifactSink(out, a["on_artifacts"], log=log)

    def write_metrics():
        with open(os.path.join(out, "metrics.json"), "w") as f:
            dump_json(metrics, f, indent=1)
        keep()

    result = SIAMOverfitResult(trainer, metrics)
    run_start = time.perf_counter()
    best_snr = -np.inf
    best_aligned = -np.inf
    best_artifact = -np.inf
    best_ema = -np.inf
    nan_steps = 0
    regress_rollbacks = 0
    good_streak = 0
    lr_mult = 1.0
    worst_window = -1
    guard = StormGuard(grad_clip=a["grad_clip"], loss_catastrophe=a["spike_thresh"])
    guard.set_initial(trainer.snapshot(), start_step)
    best_eval = (*trainer.snapshot(), start_step)
    handoff_tails: list = [None] * n_win
    perturb_until = start_step
    last_rb_step = -1
    wsnrs: list = []

    def rollback(i):
        """Restore the guard's rollback target; True on abort."""
        nonlocal lr_mult, good_streak, perturb_until, last_rb_step
        state, good_step = guard.rollback_target()
        trainer.restore(state)
        abort = guard.note_rollback()
        trainer.ema = [p.detach().clone() for p in trainer.params]
        lr_mult = max(lr_mult * 0.5, a["lr_floor"])
        good_streak = 0
        extra = ""
        if good_step == last_rb_step and a["fixed_noise"]:
            # the same snapshot again: under fixed noise the objective is
            # deterministic, so detour through drawn noise for 30 steps
            perturb_until = i + 30
            extra = "; perturbing step key for 30 steps"
        last_rb_step = good_step
        for k in range(n_win):
            handoff_tails[k] = None
        log(f"ROLLBACK #{guard.total_rollbacks} at iter {i} to step {good_step}; lr_mult -> "
            f"{lr_mult:g}{extra}")
        return abort

    def window_inputs(w, i):
        """(faded input, waveform target, first-half energy) of window w,
        in residual-handoff form once the curriculum has elapsed."""
        tail = (handoff_tails[w] if (a["residual_handoff"] and n_win > 1 and w > 0
                                     and i >= a["residual_handoff"]) else None)
        if tail is None:
            return faded_targets[w], targets[w], tgt_energy_halves[w]
        tgt_w = targets[w].clone()
        tgt_w[..., :half] = tgt_w[..., :half] - tail
        return tgt_w * fade, tgt_w, torch.sum(tgt_w[..., :half] ** 2)

    best_walk = -np.inf
    if a["walk_eval_every"]:
        walk_stream = make_streaming_fn(model)
        walk_target = torch.from_numpy(seg.copy()).to(dev).reshape(1, 1, total_len)
        walk_target[..., total_len - half:] *= _integer_pow(linspace(1.0, 0.0, half, device=dev), 8)
        walk_padded = torch.nn.functional.pad(walk_target, (0, n_samples))
        metrics.setdefault("walk", [])
        walk_noise = noise if a["fixed_noise"] else None

    anatomy_f = None
    paths = None
    if a["grad_anatomy_from"]:
        anatomy_f = open(os.path.join(out, "grad_anatomy.jsonl"), "a")
        paths = convert.flax_paths(model)

    pending = None
    nonfinite_iters: List[int] = []
    last_i = start_step
    try:
        for i in range(start_step, a["iterations"]):
            last_i = i
            result.iter_starts.append(time.perf_counter())
            fixed = a["fixed_noise"] and i >= perturb_until
            step_noise = noise if fixed else draw_noise(model, (n_events, 1), step_gen)
            if a["balance_windows"] and n_win > 1 and worst_window >= 0:
                r = i % (n_win + 1)
                w = worst_window if r == n_win else r
            else:
                w = i % n_win
            f_tgt_w, tgt_w, tgt_e_w = window_inputs(w, i)
            if anatomy_f is not None and i >= a["grad_anatomy_from"]:
                _, _, grads = trainer.grads(step_noise, wave_w, f_tgt_w, tgt_w, tgt_e_w)
                flat = {"".join(f"['{k}']" for k in ("params",) + paths[n]):
                        float(torch.linalg.vector_norm(g)) for n, g in zip(trainer.names, grads)}
                anatomy_f.write(json.dumps({"iter": i, "window": w, "leaf_gnorms": flat}) + "\n")
                anatomy_f.flush()
            loss, wave, gnorm, ok, raw_tail = trainer.step(
                step_noise, wave_w, a["grad_clip"], lr_mult, f_tgt_w, tgt_w, tgt_e_w)
            if a["residual_handoff"] and n_win > 1 and w + 1 < n_win:
                handoff_tails[w + 1] = raw_tail
            # the previous step's scalars, read while this one runs: the
            # decisions lag one step, as mptpu's
            this = (i, _LaggedRead((loss, wave, gnorm, ok)))
            if pending is None:
                pending = this
                continue
            ci, read = pending
            pending = this
            l, wv, g, okf = read.get()
            ok_b = bool(okf)
            result.steps.append((ci, l, wv, g, ok_b))
            nan_steps += int(not ok_b)
            if not ok_b:
                # the gate skipped the update: only a high rate of these is
                # pathological
                nonfinite_iters.append(ci)
                nonfinite_iters[:] = [t for t in nonfinite_iters if ci - t <= 100]
                if len(nonfinite_iters) > 40:
                    log(f"iter {ci} non-finite RATE pathological ({len(nonfinite_iters)}/100 "
                        "recent) — rolling back")
                    nonfinite_iters.clear()
                    aborted = rollback(ci)
                    pending = None
                    if aborted:
                        log("ABORT: persistent divergence")
                        metrics["aborted"] = True
                        break
                elif ci % 5 == 0:
                    log(f"iter {ci} non-finite step skipped (no-op)")
                continue
            verdict = guard.classify(ci, l, g, ok_b)
            if verdict == StormGuard.SPIKE:
                log(f"iter {ci} transient spike tolerated: loss {l:.2f} gnorm {g:.1f}")
            elif verdict == StormGuard.BAD:
                if guard.last_escalation_iter == ci:
                    log(f"iter {ci} second spike within {guard.near_window} steps (gnorm "
                        f"{g:.1f}) — escalating cliff, treating as poisoning")
                log(f"iter {ci} BAD: loss {l:.2f} gnorm {g:.1f} ok {ok_b}")
                aborted = rollback(ci)
                pending = None
                if aborted:
                    log("ABORT: persistent divergence")
                    metrics["aborted"] = True
                    break
                continue
            good_streak += 1
            if good_streak >= a["lr_recover_steps"] and lr_mult < 1.0:
                lr_mult = min(1.0, lr_mult * 2.0)
                good_streak = 0
                log(f"lr_mult recovered -> {lr_mult:g}")
            if ci % 25 == 0:
                metrics["losses"].append([ci, round(l, 2)])
                log(f"iter {ci} loss {l:.2f} wave {wv:.4f} gnorm {g:.1f} lr_mult {lr_mult:g}")
            if i % 50 == 0 and i > start_step:
                # snapshot only a verified-healthy state: finite forward and
                # switches clear of the clamp
                snap_sched = float(trainer.reconstruct(eval_noise, faded_target, target)[3])
                if not snap_sched >= 0.8 * a["switch_clamp"]:
                    ev = guard.healthy_boundary(i, trainer.snapshot())
                    if ev.startswith("promoted"):
                        log(f"iter {i} hindsight snapshot promoted (rollback target now step "
                            f"{guard.good[1]})")
                    elif ev.startswith("discarded"):
                        log(f"iter {i} snapshot candidate discarded (escalation at "
                            f"{guard.last_escalation_iter})")
                    if ev.endswith("+deferred"):
                        log(f"iter {i} candidate capture deferred (spike at "
                            f"{guard.last_spike_iter})")
                else:
                    log(f"iter {i} switch at clamp (sched_max {snap_sched:.2f}) — rolling back")
                    aborted = rollback(i)
                    pending = None
                    if aborted:
                        log("ABORT: persistent divergence")
                        metrics["aborted"] = True
                        break
                    continue
            if i % a["eval_every"] == 0:
                raw_recon, recon, aligned_recon, sched_max, ev_energy = trainer.reconstruct(
                    eval_noise, faded_target, target)
                tgt_e = float(target_energy_half)
                alive = int(np.sum(ev_energy.cpu().numpy() > 1e-6 * tgt_e))
                s_half = float(snr_db(target[..., :half], recon[..., :half]))
                l_half = float(lsd_db(target[..., :half], recon[..., :half], window, step_sz))
                s_full = float(snr_db(target, recon))
                p_half = pif_dist(target[..., :half], recon[..., :half])
                entry = {
                    "step": i,
                    "first_half_snr_db": round(s_half, 3),
                    "first_half_lsd_db": round(l_half, 3),
                    "first_half_pif_dist": round(p_half, 4),
                    "full_snr_db": round(s_full, 3),
                    "sched_max": round(float(sched_max), 4),
                    "alive_events": alive,
                    "nan_steps_so_far": nan_steps,
                    "lr_mult": lr_mult,
                    "rollbacks": guard.total_rollbacks,
                    "regress_rollbacks": regress_rollbacks,
                }
                if a["gain_refit"]:
                    entry["raw_first_half_snr_db"] = round(
                        float(snr_db(target[..., :half], raw_recon[..., :half])), 3)
                if holdout is not None:
                    _, ho_recon, _, _, _ = trainer.reconstruct(eval_noise, holdout * fade, holdout)
                    entry["holdout_first_half_snr_db"] = round(float(
                        snr_db(holdout[..., :half], ho_recon[..., :half])), 3)
                    entry["holdout_first_half_lsd_db"] = round(float(
                        lsd_db(holdout[..., :half], ho_recon[..., :half], window, step_sz)), 3)
                    entry["holdout_first_half_pif_dist"] = round(
                        pif_dist(holdout[..., :half], ho_recon[..., :half]), 4)
                if n_win > 1:
                    entry["handoff"] = bool(a["residual_handoff"] and i >= a["residual_handoff"])
                    wsnrs = [round(s_half, 3)]
                    for wi in range(1, n_win):
                        wf_tgt, wtgt, _ = window_inputs(wi, i)
                        w_recon = trainer.reconstruct(eval_noise, wf_tgt, wtgt)[1]
                        wsnrs.append(round(float(snr_db(wtgt[..., :half],
                                                        w_recon[..., :half])), 3))
                    entry["window_snr_db"] = wsnrs
                    worst_window = int(np.argmin(wsnrs))
                if a["ema"]:
                    # best_snr stays the training parameters' (it drives the
                    # rollback); the EMA competes for the artifacts only
                    e_recon = trainer.reconstruct(eval_noise, faded_target, target,
                                                  params=trainer.ema)[1]
                    e_half = float(snr_db(target[..., :half], e_recon[..., :half]))
                    entry["ema_first_half_snr_db"] = round(e_half, 3)
                    e_sel = e_half
                    if n_win > 1:
                        e_wins = [e_half]
                        for wi in range(1, n_win):
                            wf_tgt, wtgt, _ = window_inputs(wi, i)
                            ew = trainer.reconstruct(eval_noise, wf_tgt, wtgt,
                                                     params=trainer.ema)[1]
                            e_wins.append(float(snr_db(wtgt[..., :half], ew[..., :half])))
                        e_sel = sum(e_wins) / len(e_wins)
                        entry["ema_mean_window_snr_db"] = round(e_sel, 3)
                    if e_sel > best_ema:
                        best_ema = e_sel
                        save_checkpoint(os.path.join(out, "ema_best.pkl"),
                                        trainer.flax_variables(trainer.ema), None, i)
                        keep([os.path.join(out, "ema_best.pkl")])
                    if e_sel > best_artifact:
                        best_artifact = e_sel
                        write_wav(os.path.join(out, "recon_best.wav"),
                                  e_recon[0, 0].cpu().numpy(), 22050)
                if a["align_refine"]:
                    a_half = float(snr_db(target[..., :half], aligned_recon[..., :half]))
                    if a_half > best_aligned:
                        best_aligned = a_half
                        write_wav(os.path.join(out, "recon_aligned_best.wav"),
                                  aligned_recon[0, 0].cpu().numpy(), 22050)
                    entry["aligned_first_half_snr_db"] = round(a_half, 3)
                    entry["aligned_first_half_lsd_db"] = round(float(lsd_db(
                        target[..., :half], aligned_recon[..., :half], window, step_sz)), 3)
                metrics["eval"].append(entry)
                log("eval " + json.dumps(entry))
                write_metrics()
                s_sel = sum(wsnrs) / len(wsnrs) if n_win > 1 else s_half
                if s_sel > best_artifact:
                    best_artifact = s_sel
                    write_wav(os.path.join(out, "recon_best.wav"), recon[0, 0].cpu().numpy(),
                              22050)
                if s_half > best_snr:
                    best_snr = s_half
                    best_eval = (*trainer.snapshot(), i)
                elif (a["eval_regress_db"] and best_snr > 0.5
                      and s_half < best_snr - a["eval_regress_db"]):
                    regress_rollbacks += 1
                    if s_half < best_snr - a["eval_catastrophe_db"]:
                        # a fall into the silence basin: restore and halve
                        # without the floor, so that the trajectory changes
                        be_params, be_opt, be_step = best_eval
                        trainer.restore((be_params, be_opt))
                        trainer.ema = [p.detach().clone() for p in trainer.params]
                        lr_mult = max(lr_mult * 0.5, a["lr_floor"])
                        good_streak = 0
                        guard.catastrophic_restore(trainer.snapshot(), be_step)
                        pending = None
                        for k in range(n_win):
                            handoff_tails[k] = None
                        log(f"EVAL-CATASTROPHE restore #{regress_rollbacks} at iter {i}: SNR "
                            f"{s_half:.2f} < best {best_snr:.2f} - {a['eval_catastrophe_db']}; "
                            f"restored step {be_step}, lr_mult -> {lr_mult:g}")
                    else:
                        log(f"eval regression #{regress_rollbacks} at iter {i}: SNR "
                            f"{s_half:.2f} vs best {best_snr:.2f} — wandering on")
                if a["target_snr"] and s_half >= a["target_snr"]:
                    log(f"target SNR {a['target_snr']} dB reached")
                    break
            if a["walk_eval_every"] and i % a["walk_eval_every"] == 0 and i > start_step:
                walk_params = trainer.ema if a["ema"] else trainer.params
                wn = walk_noise
                if wn is None:
                    gen = torch.Generator(device=dev).manual_seed(11)
                    n_windows = len(range(0, (total_len + n_samples) // step_sz - model.n_frames,
                                          model.n_frames // 2))
                    wn = draw_noise(model, (n_windows, n_events, 1), gen)
                with parameters_swapped(model, walk_params), no_tf32():
                    w_raw = walk_stream(walk_padded, wn, fixed_noise=a["fixed_noise"])
                    w_refit = walk_stream(walk_padded, wn, fixed_noise=a["fixed_noise"],
                                          refit_gains_against=walk_padded,
                                          refit_ridge=a["gain_refit"] or 1e-3,
                                          align_refine=a["align_refine"])
                w_raw, w_refit = w_raw[..., :total_len], w_refit[..., :total_len]
                wentry = {
                    "step": i,
                    "raw_full_snr_db": round(float(snr_db(walk_target, w_raw)), 3),
                    "refit_full_snr_db": round(float(snr_db(walk_target, w_refit)), 3),
                    "refit_full_lsd_db": round(float(lsd_db(walk_target, w_refit, window,
                                                            step_sz)), 3),
                    "refit_first_half_snr_db": round(float(snr_db(
                        walk_target[..., :half], w_refit[..., :half])), 3),
                    "refit_second_half_snr_db": round(float(snr_db(
                        walk_target[..., half:], w_refit[..., half:])), 3),
                    "refit_full_pif_dist": round(pif_dist(walk_target, w_refit), 4),
                    "source": "ema" if a["ema"] else "params",
                }
                metrics["walk"].append(wentry)
                log("walk " + json.dumps(wentry))
                write_metrics()
                if wentry["refit_full_snr_db"] > best_walk:
                    best_walk = wentry["refit_full_snr_db"]
                    save_checkpoint(os.path.join(out, "walk_best.pkl"),
                                    trainer.flax_variables(walk_params), None, i)
                    keep([os.path.join(out, "walk_best.pkl")])
                    write_wav(os.path.join(out, "recon_walk_best.wav"),
                              w_refit[0, 0].cpu().numpy(), 22050)
            if i % ckpt.every == 0:
                ckpt.maybe_save(i, trainer.flax_variables(), trainer.opt_state_tree())
            if time.perf_counter() - run_start > a["watchdog_s"] - 300:
                log("time budget reached — exiting cleanly")
                break
            if os.path.exists(os.path.join(out, "STOP")):
                log("STOP file found — exiting cleanly")
                break
    finally:
        if anatomy_f is not None:
            anatomy_f.close()

    save_checkpoint(os.path.join(out, f"ckpt_{last_i:09d}.pkl"), trainer.flax_variables(),
                    trainer.opt_state_tree(), last_i)
    metrics["best_first_half_snr_db"] = round(float(best_snr), 3)
    if n_win > 1:
        metrics["artifact_selection"] = "mean_window_first_half"
        metrics["best_artifact_mean_window_snr_db"] = round(float(best_artifact), 3)
    else:
        metrics["artifact_selection"] = "window0_first_half"
        metrics["best_artifact_first_half_snr_db"] = round(float(best_artifact), 3)
    if a["walk_eval_every"] and np.isfinite(best_walk):
        metrics["best_walk_refit_full_snr_db"] = round(float(best_walk), 3)
    if a["align_refine"]:
        metrics["best_aligned_first_half_snr_db"] = round(float(best_aligned), 3)
    write_metrics()
    keep([os.path.join(out, n) for n in ("ema_best.pkl", "walk_best.pkl")], force=True)
    if metrics.get("aborted"):
        log(f"aborted: best first-half SNR {best_snr:.2f} dB")
    else:
        log(f"done: best first-half SNR {best_snr:.2f} dB")
    result.last_step = last_i
    return result
