"""Rate and distortion of the SIAM codec's wire format (counterpart of
``scripts/codec_rate.py``): quantize each event to what the wire carries,
decode from the dequantized events alone with the encode's noise, and
report kbps beside the SNR, first on a checkpoint's first window and, with
``walk``, over the whole segment through the streaming walk.

Wire layout of one event:

- preset ``f16``: context vector (C x f16), frame index (u16), amplitude (f16);
- preset ``int8``: context vector (C x i8 and one f16 scale), frame, amplitude;
- with ``refine``: the encode-time shift (i16) and gain (f16) of
  ``refine_event_alignment`` as well.

In the walk the event times go on the wire delta-coded in global frame
order, their size the first-order entropy of the deltas.

The segment is the one the checkpoint was fit to: its seed, length and
event count come from the run's ``metrics.json`` ``config`` line where the
caller left them at their defaults, as the script does. Decoding uses the
noise of the encode: event ``i`` renders with ``noise[i]`` everywhere
(``mptpu`` folds ``i`` into ``PRNGKey(42)``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Optional

import numpy as np
import torch

from .. import convert
from ..data.synthetic import synthetic_audio
from ..device import default_device, no_tf32
from ..ops.windows import linspace
from ..perceptual import pif_distance
from ..sparse import quantize
from ..train.checkpoint import load_checkpoint
from ..utils.wav import write_wav
from .inference import quantize_events
from .siam import (SIAMModel, _integer_pow, draw_noise, fade_tail, make_iterative_fn,
                   make_streaming_fn, refine_event_alignment, siam_transform)

SAMPLE_RATE = 22050
# the script's flags that describe the model and the segment, at its defaults
DEFAULTS = dict(selection_leak=0.02, selection_floor=0.02, attn_floor=0.01, attn_leak=0.1,
                switch_clamp=20.0, seed=3, n_samples_log2=17, n_events=32, hidden=128,
                context_dim=32, audio_events=0, stream_windows=1, refine=256)
# the decimals each written number keeps (the script's rounding); other floats keep 3
DIGITS = {"pcm_kbps": 1, "compression_vs_pcm": 1, "time_bits_per_event_entropy": 2}


def rounded_report(report):
    """``report`` with each float rounded as the script writes it: 4
    decimals for a PIF distance, those of ``DIGITS``, else 3."""
    def walk(obj, key=""):
        if isinstance(obj, dict):
            return {k: walk(v, k) for k, v in obj.items()}
        if isinstance(obj, float):
            return round(obj, 4 if key.endswith("pif_dist") else DIGITS.get(key, 3))
        return obj

    return walk(report)


def recorded_config(run: str) -> tuple[str, dict]:
    """(the ``config`` line of ``run``'s ``metrics.json``, the settings it
    records: ``seed``, ``n_samples_log2``, ``n_events``, ``audio_events``,
    ``stream_windows``); empty when there is no readable file."""
    path = os.path.join(run, "metrics.json")
    try:
        with open(path) as f:
            cfg = json.load(f).get("config", "")
    except (OSError, ValueError):
        return "", {}
    recorded = {}
    for name, pattern in (("seed", r"seed (\d+)"), ("n_samples_log2", r"n_samples 2\^(\d+)"),
                          ("n_events", r"(\d+) events"), ("audio_events", r"audio_events (\d+)"),
                          ("stream_windows", r"stream_windows (\d+)")):
        m = re.search(pattern, cfg)
        if m:
            recorded[name] = int(m.group(1))
    return cfg, recorded


def choose_checkpoint(run: str, ckpt: Optional[str] = None) -> str:
    """``ckpt``, else ``run``'s ``ema_best.pkl``, else its last
    ``ckpt_*.pkl``; raises when there is none."""
    if ckpt is not None:
        return ckpt
    ema = os.path.join(run, "ema_best.pkl")
    if os.path.exists(ema):
        return ema
    cands = sorted(f for f in os.listdir(run) if f.startswith("ckpt_") and f.endswith(".pkl"))
    if not cands:
        raise FileNotFoundError(f"no checkpoint (.pkl) in {run}: pass ckpt explicitly")
    return os.path.join(run, cands[-1])


def segment(n_samples: int, seed: int = 3, audio_events: int = 0,
            stream_windows: int = 1) -> np.ndarray:
    """The segment a checkpoint was fit to: ``n_samples`` and half a
    window for each further window, 8 events a second (or
    ``audio_events`` a window), dense."""
    n_win = max(1, stream_windows)
    total_len = n_samples + (n_win - 1) * (n_samples // 2)
    base_events = audio_events or int(n_samples / SAMPLE_RATE * 8)
    return synthetic_audio(total_len, SAMPLE_RATE,
                           n_events=int(round(base_events * total_len / n_samples)), seed=seed,
                           sustained=True)


def walk_target(seg: torch.Tensor, n_samples: int) -> torch.Tensor:
    """The walk's target: ``seg`` (1, 1, total) with its last half window
    faded by ``linspace(1, 0) ** 8``."""
    half = n_samples // 2
    out = seg.clone()
    out[..., out.shape[-1] - half:] *= _integer_pow(linspace(1.0, 0.0, half, device=seg.device), 8)
    return out


def snr(t: torch.Tensor, r: torch.Tensor) -> float:
    return float(10 * torch.log10(torch.clamp_min(torch.sum(t**2), 1e-12)
                                  / torch.clamp_min(torch.sum((t - r) ** 2), 1e-12)))


def rate_report(run: str, out: str, ckpt: Optional[str] = None, walk: bool = False,
                noise: Optional[torch.Tensor] = None, device=None,
                log: Callable[[str], None] = print, **flags) -> dict:
    """The script's report on the checkpoint of ``run``
    (:func:`choose_checkpoint`), written with the WAVs into ``out`` (the
    script writes into ``run``): ``codec_rate.json`` (rounded as the
    script rounds) and ``recon_wire_f16.wav`` with ``refine``, with
    ``walk`` also ``recon_wire_walk_f16.wav``. Returns the report
    unrounded.

    ``flags`` are the script's (``DEFAULTS``): a segment flag left at its
    default takes the value ``run``'s config line records. ``noise`` is the
    decoder's draw (n_events, 1, 1, noise size), from a generator seeded 42
    on the device when None. ``device``: ``cuda`` unless ``"cpu"``."""
    unknown = set(flags) - set(DEFAULTS)
    if unknown:
        raise TypeError(f"unknown flags {sorted(unknown)}")
    a = dict(DEFAULTS, **flags)
    dev = default_device(device)
    cfg, recorded = recorded_config(run)
    for name, val in recorded.items():
        if a[name] == DEFAULTS[name]:
            if a[name] != val:
                a[name] = val
                log(f"[config] --{name.replace('_', '-')} <- {val} (from "
                    f"{os.path.join(run, 'metrics.json')})")
        elif a[name] != val:
            log(f"WARNING: --{name.replace('_', '-')}={a[name]} contradicts the run's recorded "
                f"config ({val}); scoring against a different segment than the checkpoint was "
                "fit to")
    # the knobs as a fresh process of the script has them, whatever the caller set
    with quantize.selection_knobs(a["selection_leak"], a["selection_floor"]), torch.no_grad(), \
            no_tf32():
        return _report(run, out, ckpt, walk, noise, dev, log, a, cfg)


def _report(run, out, ckpt, walk, noise, dev, log, a, cfg) -> dict:
    n_samples = 2 ** a["n_samples_log2"]
    half = n_samples // 2
    window, step_sz = 2048, 256
    m = re.search(r"STFT (\d+)/(\d+)", cfg)
    if m:
        window, step_sz = int(m.group(1)), int(m.group(2))
    # the trainers' capacity at 2^15 (the config line does not record it)
    if a["n_samples_log2"] == 15 and a["hidden"] == DEFAULTS["hidden"]:
        a["hidden"] = 64
    n_events = a["n_events"]
    model = SIAMModel(
        n_samples=n_samples, context_dim=a["context_dim"], in_channels=window // 2 + 1,
        hidden_channels=a["hidden"], n_events=n_events, transform_window_size=window,
        transform_step_size=step_sz, fft_resonance=True, attn_floor=a["attn_floor"],
        attn_leak=a["attn_leak"], switch_clamp=a["switch_clamp"], residual_clamp_scale=4.0,
        encoder_clamp=1e4, spectral_skip="spectral_skip True" in cfg,
        spectral_filter="spectral_filter True" in cfg, device=dev)

    # the segment the checkpoint was fit to, its first window
    seg = segment(n_samples, a["seed"], a["audio_events"], a["stream_windows"])
    seg_t = torch.from_numpy(seg.copy()).to(dev).reshape(1, 1, -1)
    target = seg_t[..., :n_samples]
    # the encoder sees the fade-tailed window, as in training; scores are on
    # the first half, where the fade is 1
    enc_input = target * fade_tail(n_samples, device=dev)

    ckpt_path = choose_checkpoint(run, ckpt)
    payload = load_checkpoint(ckpt_path)
    if payload is None:
        raise FileNotFoundError(f"no loadable checkpoint at {ckpt_path}")
    convert.siam_from_flax(model, payload["params"])
    model.eval()
    log(f"loaded {ckpt_path} (step {payload['step']})")
    if noise is None:
        noise = draw_noise(model, (n_events, 1), torch.Generator(device=dev).manual_seed(42))
    noise = noise.to(dev)

    channels, vecs, schedules, _ = make_iterative_fn(model)(enc_input, noise)
    recon_raw = torch.sum(channels, dim=1, keepdim=True)

    def decode(vecs_q, sched_q):
        return torch.cat([model.generate(vecs_q[:, i: i + 1], sched_q[:, i: i + 1],
                                         noise=noise[i]) for i in range(vecs_q.shape[1])], dim=1)

    os.makedirs(out, exist_ok=True)
    wire_seconds = half / SAMPLE_RATE   # the walk sends half a window of fresh audio a window
    pcm_kbps = SAMPLE_RATE * 16 / 1000.0
    report = {
        "ckpt": ckpt_path,
        "n_events": n_events,
        "covered_span_s": wire_seconds,
        "raw_first_half_snr_db": snr(target[..., :half], recon_raw[..., :half]),
        "pcm_kbps": pcm_kbps,
        "presets": {},
    }
    for preset in ("f16", "int8"):
        vecs_q, sched_q, ev_bytes = quantize_events(vecs, schedules, preset)
        if a["refine"]:
            ev_bytes += 2 + 2   # shift i16 + gain f16
        ch_q = decode(vecs_q, sched_q)
        recon_q = torch.sum(ch_q, dim=1, keepdim=True)
        kbps = ev_bytes * n_events * 8 / wire_seconds / 1000.0
        row = {
            "bytes_per_event": ev_bytes,
            "bytes_per_window": ev_bytes * n_events,
            "kbps": kbps,
            "compression_vs_pcm": pcm_kbps / kbps,
            "wire_first_half_snr_db": snr(target[..., :half], recon_q[..., :half]),
        }
        if a["refine"]:
            # corrections against the original, at hand at encode, then
            # quantized as everything else on the wire
            _, shifts, gains = refine_event_alignment(target[..., :half], ch_q[..., :half],
                                                      max_shift=a["refine"])
            gains16 = gains.half().float()
            n = ch_q.shape[-1]
            idxs = (torch.arange(n, device=dev)[None, None, :] - shifts[..., None]) % n
            recon_ref = torch.einsum("be,ben->bn", gains16, ch_q.gather(-1, idxs))[:, None]
            row["refined_first_half_snr_db"] = snr(target[..., :half], recon_ref[..., :half])
            # whether the wire needs the refinement to score above 0 dB (on
            # the written SNR, as the script decides)
            row["refine_required"] = bool(round(row["wire_first_half_snr_db"], 3) < 1.0)
            if preset == "f16":
                write_wav(os.path.join(out, "recon_wire_f16.wav"),
                          recon_ref[0, 0].cpu().numpy(), SAMPLE_RATE)
        report["presets"][preset] = row

    if walk:
        report["walk"] = _walk_report(model, seg_t, noise, decode, a, window, step_sz, out)

    written = rounded_report(report)
    log(json.dumps(written, indent=1))
    with open(os.path.join(out, "codec_rate.json"), "w") as f:
        json.dump(written, f, indent=1)
    return report


def _walk_report(model, seg_t, noise, decode, a, window, step_sz, out) -> dict:
    """The whole segment through the default (handoff) walk: per preset the
    fixed-width and entropy-coded kbps, the SNR, LSD and PIF distance of
    the wire decode and, with ``refine``, of its refinement."""
    n_events, n_samples = a["n_events"], model.n_samples
    total_len = seg_t.shape[-1]
    dev = seg_t.device
    target = walk_target(seg_t, n_samples)
    padded = torch.nn.functional.pad(target, (0, n_samples))
    _, w_vecs, w_times, _ = make_streaming_fn(model)(padded, noise, fixed_noise=True,
                                                     return_event_vectors=True)
    n_windows = w_vecs.shape[1] // n_events
    frame_step = model.n_frames // 2
    duration_s = total_len / SAMPLE_RATE

    def lsd(t, r):
        ts = siam_transform(t, window, step_sz)
        rs = siam_transform(r, window, step_sz)
        return float(torch.sqrt(torch.mean((20 * torch.log10(ts + 1e-8)
                                            - 20 * torch.log10(rs + 1e-8)) ** 2)))

    walk = {"n_windows": int(n_windows), "duration_s": duration_s, "presets": {}}
    length = total_len + n_samples
    for preset in ("f16", "int8"):
        tracks = torch.zeros((1, n_windows * n_events, length), device=dev)
        global_frames = []
        for wi in range(n_windows):
            sl = slice(wi * n_events, (wi + 1) * n_events)
            vq, sq, ev_bytes = quantize_events(w_vecs[:, sl], w_times[:, sl], preset)
            ch_q = decode(vq, sq)
            # where the window starts, clamped so that it fits, as
            # lax.dynamic_update_slice places it
            off = min(wi * frame_step * step_sz, length - ch_q.shape[-1])
            tracks[:, sl, off: off + ch_q.shape[-1]] = ch_q
            frames = torch.argmax(w_times[:, sl], dim=-1)[0].cpu().numpy()
            global_frames.extend((wi * frame_step + frames).tolist())
        tracks = tracks[..., :total_len]
        raw_recon = torch.sum(tracks, dim=1, keepdim=True)
        # delta-coded global times: the first-order entropy of the sorted
        # deltas is the entropy-coded size
        deltas = np.diff(np.sort(np.asarray(global_frames)))
        if len(deltas):
            _, counts = np.unique(deltas, return_counts=True)
            probs = counts / counts.sum()
            bits_per_delta = float(-(probs * np.log2(probs)).sum())
        else:
            bits_per_delta = 0.0
        n_ev_total = n_windows * n_events
        time_bytes_entropy = 2 + (n_ev_total - 1) * bits_per_delta / 8.0   # first time as u16
        fixed_bytes = ev_bytes * n_ev_total
        if a["refine"]:
            fixed_bytes += 4 * n_ev_total   # shift i16 + gain f16
        entropy_bytes = fixed_bytes - 2 * n_ev_total + time_bytes_entropy
        row = {
            "events_total": int(n_ev_total),
            "kbps_fixed": fixed_bytes * 8 / duration_s / 1000.0,
            "kbps_entropy_times": entropy_bytes * 8 / duration_s / 1000.0,
            "time_bits_per_event_entropy": bits_per_delta,
            "wire_full_snr_db": snr(target, raw_recon),
            "wire_full_lsd_db": lsd(target, raw_recon),
            "wire_full_pif_dist": float(pif_distance(target, raw_recon)),
        }
        if a["refine"]:
            refined, _, gains = refine_event_alignment(target, tracks, max_shift=a["refine"])
            recon_ref = torch.einsum("be,ben->bn", gains.half().float(), refined)[:, None]
            row["refined_full_snr_db"] = snr(target, recon_ref)
            row["refined_full_lsd_db"] = lsd(target, recon_ref)
            row["refined_full_pif_dist"] = float(pif_distance(target, recon_ref))
            row["refine_required"] = bool(round(row["wire_full_snr_db"], 3) < 1.0)
            if preset == "f16":
                write_wav(os.path.join(out, "recon_wire_walk_f16.wav"),
                          recon_ref[0, 0].cpu().numpy(), SAMPLE_RATE)
        walk["presets"][preset] = row
    return walk
