"""The event-level anatomy of a SIAM checkpoint's held-out reconstruction
(counterpart of ``scripts/holdout_anatomy.py``).

For each greedy event it measures, against the time-domain residual the
event was meant to remove:

- ``rho0``: the normalized correlation as placed (lag 0);
- ``rho_max`` and ``lag``: the best normalized correlation over every lag;
- ``rho_chance``: the same event's best correlation against another
  segment, the match an event of this length and spectrum gets by luck;

and four first-half SNRs that bracket what these event waveforms could
deliver: as placed (the trained gains and placement), with the greedy
optimal gain per event at lag 0, with the optimal gain and a lag within
``align`` samples, and with the optimal gain at any lag.

The run's settings come from its ``metrics.json`` config line
(:func:`parse_run_config`); the checkpoint is the newest loadable
``ckpt_*.pkl``. The held-out segment is the quality run's: the dense corpus
of two 24-second files (seeds from 1000) in ``holdout_dir``, seed 987654,
and the chance baseline's segment seed 24680. The helpers are numpy, as in
the script.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Optional

import numpy as np
import torch

from .. import convert
from ..data import AudioIterator
from ..data.synthetic import ensure_demo_dataset
from ..device import default_device, no_tf32
from ..sparse import quantize
from ..train import CheckpointManager
from .siam import SIAMModel, draw_noise, make_iterative_fn


def parse_run_config(run_dir: str) -> dict:
    """The settings of the run's recorded config line (a checkpoint's
    training settings are read, never guessed)."""
    with open(os.path.join(run_dir, "metrics.json")) as f:
        cfg = json.load(f)["config"]
    out = {}
    m = re.search(r"n_samples 2\^(\d+), (\d+) events", cfg)
    out["n_samples"] = 2 ** int(m.group(1))
    out["n_events"] = int(m.group(2))
    for key, pat in [
        ("attn_floor", r"attn_floor ([\d.eE+-]+)"),
        ("attn_leak", r"attn_leak ([\d.eE+-]+)"),
        ("switch_clamp", r"switch_clamp ([\d.eE+-]+)"),
        ("residual_clamp", r"residual_clamp ([\d.eE+-]+)"),
        ("selection_leak", r"selection_leak ([\d.eE+-]+)"),
        ("selection_floor", r"selection_floor ([\d.eE+-]+)"),
        ("switch_bias_init", r"switch_bias_init ([\d.eE+-]+)"),
    ]:
        mm = re.search(pat, cfg)
        out[key] = float(mm.group(1)) if mm else 0.0
    m = re.search(r"STFT (\d+)/(\d+)", cfg)
    out["window"], out["step"] = int(m.group(1)), int(m.group(2))
    out["fixed_noise"] = "fixed_noise True" in cfg
    out["spectral_skip"] = "spectral_skip True" in cfg
    out["spectral_filter"] = "spectral_filter True" in cfg
    out["config_line"] = cfg
    return out


def xcorr_all_lags(res: np.ndarray, w: np.ndarray) -> np.ndarray:
    """c[k] = sum_t res[t] * w[t - (k - N + 1)] for k in [0, 2N-2] via FFT."""
    n = res.shape[-1]
    size = 2 * n
    R = np.fft.rfft(res, size)
    W = np.fft.rfft(w, size)
    c = np.fft.irfft(R * np.conj(W), size)
    # lags -(n-1) .. (n-1): np c[k] corresponds to shift of w by +k (mod)
    return np.concatenate([c[size - (n - 1):], c[:n]])  # index lag+n-1


def snr_db(target: np.ndarray, residual: np.ndarray) -> float:
    return float(
        10.0
        * np.log10(
            np.sum(target**2) / max(float(np.sum(residual**2)), 1e-30)
        )
    )


def greedy_oracle(
    target: np.ndarray,
    events: np.ndarray,
    half: int,
    max_lag: int | None,
) -> float:
    """Sequentially remove each event at its optimal gain (and optimal lag
    within ±max_lag; None = lag fixed at 0), return first-half SNR."""
    res = target.copy()
    n = target.shape[-1]
    for w in events:
        e = float(np.sum(w**2))
        if e < 1e-20:
            continue
        if max_lag is None:
            g = float(np.sum(res * w)) / e
            res = res - g * w
            continue
        c = xcorr_all_lags(res, w)
        lags = np.arange(-(n - 1), n)
        keep = np.abs(lags) <= max_lag
        c_k = np.where(keep, c, 0.0)
        idx = int(np.argmax(np.abs(c_k)))
        lag = int(lags[idx])
        g = float(c[idx]) / e
        w_shift = np.roll(w, lag)
        if lag > 0:
            w_shift[:lag] = 0.0
        elif lag < 0:
            w_shift[lag:] = 0.0
        res = res - g * w_shift
    return snr_db(target[..., :half], res[..., :half])


def widths_for(n_samples: int) -> tuple:
    """(hidden, context) of the trainers at ``n_samples``."""
    if n_samples == 2**15:
        return 64, 32
    if n_samples == 2**17:
        return 128, 32
    return 32, 16


def holdout_segments(holdout_dir: str, n_samples: int, device) -> tuple:
    """(the quality run's held-out segment (1, 1, n), the chance baseline's
    segment (n,) as numpy), from the dense corpus written into
    ``holdout_dir`` when it holds none."""
    path = ensure_demo_dataset(holdout_dir, n_files=2, seconds=24.0, dense=True,
                               seed_offset=1000)
    holdout = next(iter(AudioIterator(1, n_samples, normalize=True, seed=987654,
                                      audio_path=path, device=device)))
    other = next(iter(AudioIterator(1, n_samples, normalize=True, seed=24680, audio_path=path,
                                    as_tensor=False)))[0, 0]
    return holdout, other


def event_rows(target: np.ndarray, other: np.ndarray, channels: np.ndarray) -> tuple:
    """(one row per event: energy, ``rho0``, ``rho_max``, ``lag``,
    ``rho_chance``, the residual after subtracting every event as
    placed)."""
    n = target.shape[-1]
    lags_axis = np.arange(-(n - 1), n)
    rows = []
    res = target.copy()
    for e, w in enumerate(channels):
        energy = float(np.sum(w**2))
        row = {"event": e, "energy": energy}
        if energy > 1e-20:
            norm_w = np.sqrt(energy)
            norm_r = float(np.linalg.norm(res)) or 1e-30
            c = xcorr_all_lags(res, w)
            rho = c / (norm_w * norm_r)
            idx = int(np.argmax(np.abs(rho)))
            row["rho0"] = round(float(rho[n - 1]), 4)
            row["rho_max"] = round(float(np.abs(rho[idx])), 4)
            row["lag"] = int(lags_axis[idx])
            co = xcorr_all_lags(other, w)
            row["rho_chance"] = round(
                float(np.max(np.abs(co)) / (norm_w * (np.linalg.norm(other) or 1e-30))), 4)
        rows.append(row)
        res = res - w   # the trained gains' greedy trajectory, as placed
    return rows, res


def anatomy(run: str, out: str, holdout_dir: Optional[str] = None, align: int = 256,
            noise: Optional[torch.Tensor] = None, device=None,
            log: Callable[[str], None] = print, path: Optional[str] = None) -> dict:
    """The script's summary of the newest checkpoint of ``run``, written
    to ``path`` (default ``out``'s ``anatomy.json``), and returned.
    ``holdout_dir``: where the held-out corpus is (written there when
    absent; default ``out``'s ``dense_corpus_holdout``). ``noise``: the
    decoder's draw (n_events, 1, 1, noise size), from a generator seeded 42
    with the run's fixed noise, else 7, when None. ``device``: ``cuda``
    unless ``"cpu"``."""
    dev = default_device(device)
    cfg = parse_run_config(run)
    n_samples, n_events = cfg["n_samples"], cfg["n_events"]
    hidden, context_dim = widths_for(n_samples)
    os.makedirs(out, exist_ok=True)
    holdout_dir = holdout_dir or os.path.join(out, "dense_corpus_holdout")
    with quantize.selection_knobs(cfg["selection_leak"], cfg["selection_floor"]), \
            torch.no_grad(), no_tf32():
        model = SIAMModel(
            n_samples=n_samples, context_dim=context_dim, in_channels=cfg["window"] // 2 + 1,
            hidden_channels=hidden, n_events=n_events, transform_window_size=cfg["window"],
            transform_step_size=cfg["step"], fft_resonance=True, attn_floor=cfg["attn_floor"],
            attn_leak=cfg["attn_leak"], switch_clamp=cfg["switch_clamp"],
            residual_clamp_scale=cfg["residual_clamp"], switch_bias_init=cfg["switch_bias_init"],
            spectral_skip=cfg["spectral_skip"], spectral_filter=cfg["spectral_filter"],
            device=dev)
        payload = CheckpointManager(run).latest()
        if payload is None:
            raise FileNotFoundError(f"no checkpoint under {run}")
        convert.siam_from_flax(model, payload["params"])
        model.eval()
        step = payload["step"]
        log(f"checkpoint step {step}")
        holdout, other = holdout_segments(holdout_dir, n_samples, dev)
        if noise is None:
            noise = draw_noise(model, (n_events, 1), torch.Generator(device=dev).manual_seed(
                42 if cfg["fixed_noise"] else 7))
        channels, _, _, _ = make_iterative_fn(model)(holdout, noise.to(dev))
    channels = channels[0].cpu().numpy()        # (E, N)
    target = holdout[0, 0].cpu().numpy()        # (N,)
    half = n_samples // 2
    rows, res = event_rows(target, other, channels)
    alive = [r for r in rows if "rho_max" in r]
    summary = {
        "run": run,
        "checkpoint_step": int(step),
        "config": cfg["config_line"],
        "n_alive_events": len(alive),
        "as_placed_snr_db": round(snr_db(target[:half], res[:half]), 3),
        "oracle_gain_snr_db": round(greedy_oracle(target, channels, half, max_lag=None), 3),
        "oracle_align_snr_db": round(greedy_oracle(target, channels, half, max_lag=align), 3),
        "oracle_place_snr_db": round(greedy_oracle(target, channels, half,
                                                   max_lag=n_samples - 1), 3),
        "align_budget": align,
        "rho_max_mean": round(float(np.mean([r["rho_max"] for r in alive])), 4)
        if alive else None,
        "rho_chance_mean": round(float(np.mean([r["rho_chance"] for r in alive])), 4)
        if alive else None,
        "events": rows,
    }
    path = path or os.path.join(out, "anatomy.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    for k in ("as_placed_snr_db", "oracle_gain_snr_db", "oracle_align_snr_db",
              "oracle_place_snr_db", "rho_max_mean", "rho_chance_mean", "n_alive_events"):
        log(f"{k} {summary[k]}")
    log(f"wrote {path}")
    return summary
