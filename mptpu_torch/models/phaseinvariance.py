"""The phase-invariance study (counterpart of ``scripts/phaseinvariance.py``):
overfit raw audio samples so that a transform of them matches the
transform of a target, for three transforms (magnitude STFTs of 512 / 256
and 2048 / 256, and the auditory image model over 128 geometric gammatone
filters of 256 taps), and report each one's transform loss, waveform SNR
and log-spectral distance, with a page of the audio."""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..data.synthetic import synthetic_audio
from ..device import default_device
from ..nn.init import uniform
from ..ops.stft import stft
from ..perceptual.aim import auditory_image_model
from ..perceptual.gammatone import gammatone_filter_bank
from ..train.overfit import overfit_model
from ..utils.reporting import audio_element, html_page
from ..utils.wav import read_wav, write_wav

TRANSFORMS = ("mag_spec_512", "mag_spec_2048", "aim")


def snr_db(target: torch.Tensor, recon: torch.Tensor) -> float:
    """``10 log10(|target|^2 / |target - recon|^2)``, each floored at 1e-12."""
    signal = torch.clamp(torch.sum(target**2), min=1e-12)
    noise = torch.clamp(torch.sum((target - recon) ** 2), min=1e-12)
    return float(10.0 * torch.log10(signal / noise))


def lsd_db(target: torch.Tensor, recon: torch.Tensor) -> float:
    """The rms difference in dB of the 2048 / 256 STFT magnitudes (+1e-8)."""
    ts = stft(target, 2048, 256, pad=True)
    rs = stft(recon, 2048, 256, pad=True)
    return float(torch.sqrt(torch.mean((20 * torch.log10(ts + 1e-8)
                                        - 20 * torch.log10(rs + 1e-8)) ** 2)))


def transforms(device=None) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """The script's three transforms by name, the AIM's bank on
    ``default_device(device)``."""
    fb = torch.from_numpy(gammatone_filter_bank(n_filters=128, size=256,
                                                band_spacing="geometric")).to(
        default_device(device))
    return {"mag_spec_512": lambda x: stft(x, 512, 256, pad=True),
            "mag_spec_2048": lambda x: stft(x, 2048, 256, pad=True),
            "aim": lambda x: auditory_image_model(x, fb, 256, 64)}


class Reconstruction(NamedTuple):
    audio: torch.Tensor        # the fitted samples, target's shape
    losses: List[float]        # the loss at every 50th step (the script's record)
    step_losses: List[float]   # every step's loss
    step_starts: List[float]   # host clock at each step's start
    t_end: float               # host clock after the last step


def reconstruct_with_transform(target: torch.Tensor, transform: Callable, iterations: int,
                               lr: float = 1e-2,
                               init: Optional[torch.Tensor] = None) -> Reconstruction:
    """Fit raw audio of the target's shape so that ``mean((transform(audio)
    - transform(target))^2)`` falls, by Adam (betas 0.9, 0.999) with the
    NaN guard; ``init`` is the start, by default uniform in [-1e-3, 1e-3)
    from a CPU generator seeded with 0, so that every device starts from
    the same samples."""
    real_repr = transform(target).detach()
    if init is None:
        init = uniform(target.shape, -1e-3, 1e-3, torch.Generator().manual_seed(0))
    audio = init.detach().clone().to(target.device).requires_grad_()
    step_losses, starts = [], [time.perf_counter()]

    def after(i, params, loss):
        step_losses.append(loss)
        starts.append(time.perf_counter())

    _, losses = overfit_model([audio], lambda tgt, gen: torch.mean((transform(audio) - real_repr)
                                                                   ** 2),
                              target, n_iterations=iterations, lr=lr, after_iteration=after)
    t_end = starts.pop()
    return Reconstruction(audio.detach(), losses,
                          torch.stack(step_losses).tolist() if step_losses else [], starts, t_end)


def phaseinvariance_target(n_samples: int, seed: int = 0) -> np.ndarray:
    """The script's target: sustained ``synthetic_audio`` at 22,050 Hz, 8
    events a second (at least 4)."""
    return synthetic_audio(n_samples, 22050, n_events=max(4, int(n_samples / 22050 * 8)),
                           seed=seed, sustained=True)


def run_phaseinvariance(iterations: int = 1000, n_samples: int = 2**17, seed: int = 0,
                        out: Optional[str] = "trained_weights/phaseinvariance",
                        smoke: bool = False, device=None,
                        log: Callable[[str], None] = print) -> Dict[str, dict]:
    """``scripts/phaseinvariance.py:main`` with its flags as keywords
    (``smoke``: 2^13 samples, 50 iterations), each transform fitted from
    :func:`reconstruct_with_transform`'s start. With ``out``:
    ``source.wav``, ``recon_{name}.wav``, ``metrics.json`` and
    ``report.html`` there. Returns {name: {"final_loss", "snr_db",
    "lsd_db", "run": the :class:`Reconstruction`}}."""
    dev = default_device(device)
    if smoke:
        n_samples, iterations = 2**13, 50
    samplerate = 22050
    seg = phaseinvariance_target(n_samples, seed)
    target = torch.from_numpy(seg).reshape(1, 1, -1).to(dev)
    if out:
        os.makedirs(out, exist_ok=True)
        write_wav(os.path.join(out, "source.wav"), seg, samplerate)
    experiments = transforms(dev)
    results = {}
    for name, transform in experiments.items():
        run = reconstruct_with_transform(target, transform, iterations)
        results[name] = {"final_loss": run.losses[-1],
                         "snr_db": round(snr_db(target, run.audio), 3),
                         "lsd_db": round(lsd_db(target, run.audio), 3), "run": run}
        log(f"{name} " + json.dumps({k: v for k, v in results[name].items() if k != "run"}))
        if out:
            write_wav(os.path.join(out, f"recon_{name}.wav"), run.audio[0, 0].cpu().numpy(),
                      samplerate)
    if out:
        metrics = {k: {m: v for m, v in r.items() if m != "run"} for k, r in results.items()}
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=1)
        sections = [("Source", audio_element(seg, samplerate, "source")
                     + "<p>The audio every transform below tries to recover.</p>")]
        for name, r in metrics.items():
            audio, sr = read_wav(os.path.join(out, f"recon_{name}.wav"))
            sections.append((name, audio_element(audio, sr, name)
                             + f"<p>transform loss {r['final_loss']:.3e}, waveform SNR "
                             f"{r['snr_db']} dB, LSD {r['lsd_db']} dB — phase-invariant "
                             "features recover audible structure without matching the "
                             "waveform.</p>"))
        with open(os.path.join(out, "report.html"), "w") as f:
            f.write(html_page("Phase-invariant features", sections))
    log("done")
    return results
