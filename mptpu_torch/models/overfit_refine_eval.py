"""Score a SIAM overfit checkpoint with the encode-time refinement passes
(counterpart of ``scripts/overfit_refine_eval.py``): the raw greedy
decode against the joint gain re-fit (``refit_event_gains``) and against
the shift and gain alignment refinement (``refine_event_alignment``), all
on the first-half eval of one fade-tailed window, as the trainer reports
it.

The script builds its model at sw6's widths (``WIDTHS``) and fits nothing:
one forward of the newest ``ckpt_*.pkl`` of the run (or of ``ckpt``) on
``synthetic_audio``'s segment of ``seed``, with the trainer's
``--fixed-noise`` draw (event ``i`` renders with ``noise[i]``; ``mptpu``
folds ``i`` into ``PRNGKey(noise_seed)``). The port writes its report and
WAV into the directory the caller gives (the script writes into the run).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import torch

from .. import convert
from ..device import default_device, no_tf32
from ..sparse import quantize
from ..train.checkpoint import load_checkpoint
from ..utils.wav import write_wav
from .codec_rate import SAMPLE_RATE, segment
from .siam import (SIAMModel, draw_noise, fade_tail, make_iterative_fn, refine_event_alignment,
                   refit_event_gains)
from .siam_overfit import lsd_db, snr_db

# the model and window the four evaluation scripts hard-code (sw6's)
WIDTHS = dict(n_samples=2**17, n_events=32, hidden=128, context_dim=32, window=2048, step=256)
DEFAULTS = dict(seed=3, attn_floor=0.01, attn_leak=0.1, selection_leak=0.02,
                selection_floor=0.02, switch_clamp=20.0, noise_seed=42, gain_refit=1e-3,
                align_refine=256, align_iters=3)


def check_flags(flags: dict, defaults: dict) -> dict:
    """``defaults`` updated by ``flags``; raises on a flag the script lacks."""
    unknown = set(flags) - set(defaults)
    if unknown:
        raise TypeError(f"unknown flags {sorted(unknown)}")
    return dict(defaults, **flags)


def eval_model(widths: dict, device, **flags) -> SIAMModel:
    """The scripts' eval model at ``widths``: fft resonance, residual clamp
    4, encoder clamp 1e4, and ``flags`` (``attn_floor``, ``attn_leak``,
    ``switch_clamp``, ...)."""
    w = widths
    return SIAMModel(n_samples=w["n_samples"], context_dim=w["context_dim"],
                     in_channels=w["window"] // 2 + 1, hidden_channels=w["hidden"],
                     n_events=w["n_events"], transform_window_size=w["window"],
                     transform_step_size=w["step"], fft_resonance=True, residual_clamp_scale=4.0,
                     encoder_clamp=1e4, device=device, **flags)


def newest_checkpoint(run: str, ckpt: Optional[str] = None) -> str:
    """``ckpt``, else ``run``'s last ``ckpt_*.pkl`` by name; raises when
    there is none."""
    if ckpt is not None:
        return ckpt
    cands = sorted(f for f in os.listdir(run) if f.startswith("ckpt_") and f.endswith(".pkl"))
    if not cands:
        raise FileNotFoundError(f"no ckpt_*.pkl in {run}: pass ckpt explicitly")
    return os.path.join(run, cands[-1])


def load_into(model: SIAMModel, path: str, log: Callable[[str], None]) -> int:
    """Copy the checkpoint at ``path`` into ``model`` (evaluation mode) and
    return its step."""
    payload = load_checkpoint(path)
    if payload is None:
        raise FileNotFoundError(f"no loadable checkpoint at {path}")
    convert.siam_from_flax(model, payload["params"])
    model.eval()
    log(f"loaded {path} (step {payload['step']})")
    return payload["step"]


def first_window(model: SIAMModel, seed: int, noise: Optional[torch.Tensor], noise_seed: int):
    """(target (1, 1, n), the iterative decomposition of the fade-tailed
    target: channels, vecs, schedules, residual), with ``noise`` or a draw
    from a generator seeded ``noise_seed`` on the model's device, in the
    model's dtype."""
    weight = model.to_event_switch.weight
    dev, dtype = weight.device, weight.dtype
    n = model.n_samples
    target = torch.from_numpy(segment(n, seed)).to(dev, dtype).reshape(1, 1, n)
    if noise is None:
        noise = draw_noise(model, (model.n_events, 1),
                           torch.Generator(device=dev).manual_seed(noise_seed))
    fade = fade_tail(n, device=dev).to(dtype)
    return target, make_iterative_fn(model)(target * fade, noise.to(dev, dtype))


def refine_eval(run: str, out: str, ckpt: Optional[str] = None,
                noise: Optional[torch.Tensor] = None, device=None,
                log: Callable[[str], None] = print, widths: Optional[dict] = None,
                keep: Optional[dict] = None, dtype: torch.dtype = torch.float32,
                **flags) -> dict:
    """The script's report on the newest checkpoint of ``run`` (or
    ``ckpt``), written into ``out`` as ``refine_eval.json`` (rounded as the
    script rounds) with ``recon_aligned_best.wav``; returns it unrounded.
    ``flags`` are the script's (``DEFAULTS``), ``widths`` the model's
    (``WIDTHS``), ``noise`` the decoder's draw (n_events, 1, 1, noise
    size). ``keep``, when given, receives the window's ``channels`` and
    ``schedules``. ``dtype``: the model's and the segment's (float32 as in
    the script; float64 measures how far float32 puts each metric).
    ``device``: ``cuda`` unless ``"cpu"``."""
    a = check_flags(flags, DEFAULTS)
    w = dict(WIDTHS, **(widths or {}))
    dev = default_device(device)
    # the knobs as a fresh process of the script has them, whatever the caller set
    with quantize.selection_knobs(a["selection_leak"], a["selection_floor"]), torch.no_grad(), \
            no_tf32():
        model = eval_model(w, dev, attn_floor=a["attn_floor"], attn_leak=a["attn_leak"],
                           switch_clamp=a["switch_clamp"])
        path = newest_checkpoint(run, ckpt)
        step = load_into(model, path, log)
        model.to(dtype)
        t0 = time.perf_counter()
        target, (channels, _, schedules, _) = first_window(model, a["seed"], noise,
                                                           a["noise_seed"])
        if keep is not None:
            keep.update(channels=channels, schedules=schedules)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log(f"forward {time.perf_counter() - t0:.1f}s (device {dev})")
        half = w["n_samples"] // 2
        raw = torch.sum(channels, dim=1, keepdim=True)
        gains = torch.clamp(refit_event_gains(target, channels, ridge=a["gain_refit"], span=half),
                            -10.0, 10.0)
        refit = torch.einsum("be,ben->bn", gains, channels)[:, None]
        refined, shifts, a_gains = refine_event_alignment(
            target, channels, max_shift=a["align_refine"], n_iters=a["align_iters"],
            ridge=a["gain_refit"], span=half)
        aligned = torch.einsum("be,ben->bn", a_gains, refined)[:, None]
        t_h = target[..., :half]
        report = {"ckpt": path, "step": step}
        for name, recon in (("raw", raw), ("refit", refit), ("aligned", aligned)):
            report[f"{name}_first_half_snr_db"] = float(snr_db(t_h, recon[..., :half]))
            report[f"{name}_first_half_lsd_db"] = float(lsd_db(t_h, recon[..., :half], w["window"],
                                                               w["step"]))
        report.update(gain_refit_ridge=a["gain_refit"], align_max_shift=a["align_refine"],
                      align_iters=a["align_iters"], refit_gains=gains[0].tolist(),
                      align_shifts=[int(s) for s in shifts[0].tolist()])
    written = {k: (round(v, 3) if k.endswith("_db") else v) for k, v in report.items()}
    written["refit_gains"] = [round(g, 4) for g in report["refit_gains"]]
    log(json.dumps(written, indent=1))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "refine_eval.json"), "w") as f:
        json.dump(written, f, indent=1)
    # the name the trainer's best aligned eval writes, which the report page reads
    write_wav(os.path.join(out, "recon_aligned_best.wav"), aligned[0, 0].cpu().numpy(),
              SAMPLE_RATE)
    return report
