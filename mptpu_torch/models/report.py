"""The demo pages of the codec and its runs (counterpart of
``scripts/report.py``): a SIAM model's reconstruction of a segment, its
events over time and, with ``streaming``, the walk over twice the segment
(:func:`make_report`); an overfit run directory's own artifacts and
evaluation files (:func:`make_overfit_report`, no forward); a song-splat
run's whole-song artifacts (:func:`make_songsplat_report`). Each writes a
standalone HTML article to the path the caller gives and returns its
components. The components are the script's own markup, copied.
"""

from __future__ import annotations

import html
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import convert
from ..data import get_one_audio_segment
from ..device import default_device, no_tf32
from ..obs.article import AudioComponent, ImageComponent, conjure_article
from ..ops import max_norm, stft
from ..train import CheckpointManager
from ..utils.wav import read_wav
from .siam import SIAMModel, draw_noise, make_iterative_fn, streaming_encode


def event_scatter_svg(vecs: np.ndarray, times: np.ndarray, width=400, height=200):
    """Inline SVG scatter of events: x=time, y=first PC of event vector
    (the t-SNE scatter analog of ``scatter.py``)."""
    v = vecs.reshape(-1, vecs.shape[-1])
    t = times.reshape(-1)
    # first principal component without sklearn
    c = v - v.mean(0)
    u, s, vt = np.linalg.svd(c, full_matrices=False)
    pc = c @ vt[0]
    pc = (pc - pc.min()) / (np.ptp(pc) + 1e-9)
    t = (t - t.min()) / (np.ptp(t) + 1e-9)
    dots = "".join(
        f'<circle cx="{float(x) * width:.1f}" cy="{(1 - float(y)) * height:.1f}" '
        f'r="4" fill="rgba(80,80,220,0.6)"/>'
        for x, y in zip(t, pc)
    )
    return (
        f'<svg viewBox="0 0 {width} {height}" width="100%" height="{height}">'
        f"{dots}</svg>"
    )


class _SvgComponent:
    def __init__(self, svg, title=""):
        self.svg, self.title = svg, title

    def render(self):
        t = f"<h4>{self.title}</h4>" if self.title else ""
        return f'<div class="component">{t}{self.svg}</div>'


class _TableComponent:
    """Render a training-quality metrics table (scripts/siam_quality.py's
    metrics.json) into the article."""

    def __init__(self, metrics: dict, title="Training quality"):
        self.metrics = metrics
        self.title = title

    def render(self):
        m = self.metrics
        rows = "".join(
            f"<tr><td>{e['step']}</td><td>{e['holdout_snr_db']:.2f}</td>"
            f"<td>{e['holdout_lsd_db']:.2f}</td><td>{e['recon_rms']:.5f}</td></tr>"
            for e in m.get("eval", [])
        )
        head = (
            f"<p>{m.get('config','')}</p>"
            f"<p>init {m.get('init_s','?')}s; first step {m.get('first_step_s','?')}s; "
            f"steady-state {m.get('ms_per_step_synced','?')} ms/step (per-step-synced), "
            f"{m.get('ms_per_step_pipelined','?')} ms/step (pipelined)</p>"
        )
        return (
            f'<div class="component"><h4>{self.title}</h4>{head}'
            "<table border=1 cellpadding=4><tr><th>step</th>"
            "<th>held-out SNR (dB)</th><th>held-out LSD (dB)</th>"
            f"<th>recon RMS</th></tr>{rows}</table></div>"
        )


class _OverfitTableComponent:
    """Render a siam_overfit metrics.json eval trajectory."""

    def __init__(self, metrics: dict, title="Overfit trajectory"):
        self.metrics = metrics
        self.title = title

    def render(self):
        m = self.metrics
        evals = m.get("eval", [])
        has_aligned = any("aligned_first_half_snr_db" in e for e in evals)
        has_windows = any("window_snr_db" in e for e in evals)
        # thin long runs to ~40 rows
        step = max(1, len(evals) // 40)
        def aligned_cell(e):
            if not has_aligned:
                return ""
            v = e.get("aligned_first_half_snr_db")
            return f"<td>{v:.2f}</td>" if v is not None else "<td>—</td>"

        def windows_cell(e):
            if not has_windows:
                return ""
            v = e.get("window_snr_db")
            if v is None:
                return "<td>—</td>"
            return "<td>" + " / ".join(f"{x:.1f}" for x in v) + "</td>"

        rows = "".join(
            f"<tr><td>{e['step']}</td><td>{e['first_half_snr_db']:.2f}</td>"
            + aligned_cell(e)
            + windows_cell(e)
            + f"<td>{e['full_snr_db']:.2f}</td><td>{e['sched_max']:.2f}</td>"
            f"<td>{e.get('alive_events', '—')}</td>"
            f"<td>{e['rollbacks']}</td></tr>"
            for e in evals[::step]
        )
        best = m.get("best_first_half_snr_db",
                     max((e["first_half_snr_db"] for e in evals), default=0.0))
        best_aligned = m.get("best_aligned_first_half_snr_db")
        head_aligned = (
            "<th>aligned SNR (dB)</th>" if has_aligned else ""
        )
        head_windows = (
            "<th>per-window SNR (dB)</th>" if has_windows else ""
        )
        aligned_line = (
            f"<p><b>best aligned (shift+gain refined) first-half SNR: "
            f"{best_aligned:.2f} dB</b></p>"
            if best_aligned is not None
            else ""
        )
        return (
            f'<div class="component"><h4>{self.title}</h4>'
            f"<p>{html_escape(m.get('config', ''))}</p>"
            f"<p><b>best first-half SNR: {best:.2f} dB</b></p>{aligned_line}"
            "<table border=1 cellpadding=4><tr><th>step</th>"
            f"<th>first-half SNR (dB)</th>{head_aligned}{head_windows}"
            "<th>full SNR (dB)</th>"
            "<th>sched_max</th><th>alive events</th><th>rollbacks</th></tr>"
            f"{rows}</table></div>"
        )


def html_escape(s: str) -> str:
    return html.escape(s)


class _CodecRateComponent:
    """Render scripts/codec_rate.py's codec_rate.json: the wire-format
    rate/distortion table (kbps, compression vs PCM, wire SNR)."""

    def __init__(self, rate: dict, title="Wire-format rate/distortion"):
        self.rate = rate
        self.title = title

    def render(self):
        r = self.rate
        rows = "".join(
            f"<tr><td>{name}</td><td>{p['bytes_per_event']}</td>"
            f"<td>{p['bytes_per_window']}</td><td>{p['kbps']:.2f}</td>"
            f"<td>{p['compression_vs_pcm']:.0f}x</td>"
            f"<td>{p['wire_first_half_snr_db']:.2f}</td>"
            f"<td>{p.get('refined_first_half_snr_db', float('nan')):.2f}"
            "</td></tr>"
            for name, p in r.get("presets", {}).items()
        )
        return (
            f'<div class="component"><h4>{self.title}</h4>'
            f"<p>{r.get('n_events', '?')} event tuples per window; the "
            f"streaming walk delivers {r.get('covered_span_s', '?')} s of "
            f"fresh audio per window (16-bit PCM at the same rate: "
            f"{r.get('pcm_kbps', '?')} kbps). Float encode first-half "
            f"SNR: {r.get('raw_first_half_snr_db', '?')} dB.</p>"
            "<table border=1 cellpadding=4><tr><th>preset</th>"
            "<th>B/event</th><th>B/window</th><th>kbps</th>"
            "<th>vs PCM</th><th>wire SNR (dB)</th>"
            "<th>+shift/gain refined (dB)</th></tr>"
            f"{rows}</table></div>"
        )


def _spec_img(x: np.ndarray, title: str, window: int) -> ImageComponent:
    """The log magnitude STFT (``window`` / 256, padded) of a signal."""
    s = stft(torch.from_numpy(np.asarray(x, dtype=np.float32)).reshape(1, 1, -1), window, 256,
             pad=True).numpy()
    return ImageComponent(np.log(1e-4 + s[0, 0]).T, title)


def make_overfit_report(run_dir: str, out_path: str, log: Callable[[str], None] = print) -> list:
    """Render an overfit run directory's own artifacts (``target.wav``,
    ``recon_best.wav``, ``metrics.json``, and where present the refinement,
    walk and rate evaluations' files): no model forward, so the audio is
    what the trainer's best eval and the evaluations wrote."""
    target, sr = read_wav(os.path.join(run_dir, "target.wav"))
    recon, _ = read_wav(os.path.join(run_dir, "recon_best.wav"))
    with open(os.path.join(run_dir, "metrics.json")) as f:
        metrics = json.load(f)

    best = metrics.get("best_first_half_snr_db",
                       max((e["first_half_snr_db"]
                            for e in metrics.get("eval", [])), default=0.0))
    components = [
        AudioComponent(target, sr, "Original (one fixed segment)"),
        AudioComponent(recon, sr, "Best reconstruction"),
        _spec_img(target, "Original spectrogram (log)", 512),
        _spec_img(recon, "Reconstruction spectrogram (log)", 512),
        _OverfitTableComponent(metrics),
    ]
    aligned_wav = os.path.join(run_dir, "recon_aligned_best.wav")
    refine_json = os.path.join(run_dir, "refine_eval.json")
    if os.path.exists(aligned_wav):
        aligned, _ = read_wav(aligned_wav)
        note = ""
        if os.path.exists(refine_json):
            with open(refine_json) as f:
                re_ = json.load(f)
            note = (
                f": raw {re_.get('raw_first_half_snr_db', '?')} dB -> "
                f"refit {re_.get('refit_first_half_snr_db', '?')} dB -> "
                f"aligned {re_.get('aligned_first_half_snr_db', '?')} dB "
                "first half"
            )
        components.insert(2, AudioComponent(
            aligned, sr,
            "Best encode-time-refined reconstruction (OMP shift+gain "
            f"re-projection){note}",
        ))
    stream_wav = os.path.join(run_dir, "recon_streaming.wav")
    stream_refit_wav = os.path.join(run_dir, "recon_streaming_refit.wav")
    stream_json = os.path.join(run_dir, "stream_eval.json")
    if os.path.exists(stream_json) and (
        os.path.exists(stream_refit_wav) or os.path.exists(stream_wav)
    ):
        with open(stream_json) as f:
            se = json.load(f)
        if os.path.exists(stream_refit_wav) and "refit_full_snr_db" in se:
            # a checkpoint trained through the gain re-fit decodes through it
            streamed, _ = read_wav(stream_refit_wav)
            caption = (
                "Streaming-walk reconstruction (full-segment coverage, "
                "per-(window,event) OMP gain re-fit — the codec's decode "
                f"path for refit-trained checkpoints): "
                f"{se.get('refit_full_snr_db', '?')} dB full-segment SNR, "
                f"{se.get('refit_first_half_snr_db', '?')} dB first half "
                f"(raw unit-gain walk: "
                f"{se.get('streaming_full_snr_db', '?')} dB)"
            )
        else:
            streamed, _ = read_wav(stream_wav)
            caption = (
                "Streaming-walk reconstruction (full-segment coverage): "
                f"{se.get('streaming_full_snr_db', '?')} dB full-segment "
                f"SNR, {se.get('streaming_first_half_snr_db', '?')} dB "
                "first half"
            )
        components.insert(2, AudioComponent(streamed, sr, caption))
        pristine_wav = os.path.join(run_dir, "recon_streaming_pristine.wav")
        if os.path.exists(pristine_wav) and "pristine_full_snr_db" in se:
            pristine, _ = read_wav(pristine_wav)
            components.insert(3, AudioComponent(
                pristine, sr,
                "Streaming walk with PRISTINE window inputs (no residual "
                "handoff — matches how --stream-windows checkpoints were "
                f"trained): {se.get('pristine_full_snr_db', '?')} dB "
                "full-segment SNR, "
                f"{se.get('pristine_second_half_snr_db', '?')} dB second "
                "half",
            ))
    rate_json = os.path.join(run_dir, "codec_rate.json")
    if os.path.exists(rate_json):
        with open(rate_json) as f:
            rate = json.load(f)
        components.append(_CodecRateComponent(rate))
        wire_wav = os.path.join(run_dir, "recon_wire_f16.wav")
        if os.path.exists(wire_wav):
            wired, _ = read_wav(wire_wav)
            f16 = rate.get("presets", {}).get("f16", {})
            components.append(AudioComponent(
                wired, sr,
                "Decoded from the QUANTIZED wire (f16 preset, "
                f"{f16.get('kbps', '?')} kbps, shift/gain refined): "
                f"{f16.get('refined_first_half_snr_db', '?')} dB "
                "first-half SNR",
            ))
    conjure_article(
        out_path,
        "SIAM overfit existence proof",
        components,
        intro_markdown=(
            "# SIAM overfit: the flagship codec reconstructing audio\n"
            "The reference's `--overfit` demonstration mode "
            "(iterativedecomposition.py:612-647) fit to one segment. "
            f"Best first-half waveform SNR: **{best:.2f} dB** "
            "(the encoder's streaming mask confines single-window events "
            "to the first half; full coverage comes from the streaming "
            "walk)."
        ),
    )
    log(f"overfit report -> {out_path}")
    return components


def make_songsplat_report(run_dir: str, out_path: str, log: Callable[[str], None] = print) -> list:
    """Render a song-splat run's whole-song artifacts (``song_target.wav``,
    ``song_recon.wav``, ``song_eval.json``)."""
    target, sr = read_wav(os.path.join(run_dir, "song_target.wav"))
    recon, _ = read_wav(os.path.join(run_dir, "song_recon.wav"))
    with open(os.path.join(run_dir, "song_eval.json")) as f:
        ev = json.load(f)
    components = [
        AudioComponent(target, sr, "Original song (24 s)"),
        AudioComponent(
            recon, sr,
            f"Splat reconstruction — covered-region LSD "
            f"{ev.get('covered_lsd_db', '?')} dB (waveform SNR "
            f"{ev.get('covered_snr_db', '?')} dB: the training loss "
            "is magnitude-only, so phase — and with it waveform "
            "SNR — is unpinned by construction)",
        ),
        _spec_img(target, "Original spectrogram (log)", 2048),
        _spec_img(recon, "Reconstruction spectrogram (log)", 2048),
    ]
    conjure_article(
        out_path,
        "Whole-song splatting",
        components,
        intro_markdown=(
            "# Whole-song event splatting\n"
            f"{ev.get('trained_steps', ev.get('iterations', '?'))} "
            "optimizer steps; "
            "190 events over 24 s (compression ratio 0.012); "
            "per-segment OMP gain re-fit at render "
            f"(ridge {ev.get('refit_ridge', 0)})."
        ),
    )
    log(f"songsplat report -> {out_path}")
    return components


def report_model(tiny: bool = False, device=None) -> SIAMModel:
    """The script's model: ``--tiny``'s widths or ``SIAMModel()``'s
    defaults, parameters from a generator seeded 0."""
    if tiny:
        return SIAMModel(n_samples=2**13, context_dim=16, in_channels=257, hidden_channels=32,
                         n_events=4, transform_window_size=512, transform_step_size=256,
                         fft_resonance=True, device=device)
    return SIAMModel(device=device)


def make_report(checkpoint_dir: Optional[str], out_path: str, tiny: bool = False,
                streaming: bool = False, audio_path: Optional[str] = None,
                seed: Optional[int] = None, metrics_path: Optional[str] = None,
                noise: Optional[torch.Tensor] = None, stream_noise: Optional[torch.Tensor] = None,
                device=None, log: Callable[[str], None] = print) -> list:
    """The codec's page: a segment of the corpus (``audio_path``, ``seed``),
    its reconstruction by the newest checkpoint of ``checkpoint_dir`` (the
    model's seeded parameters without one), the reconstruction's
    spectrogram and the events over time, the quality run's table of
    ``metrics_path``, and with ``streaming`` the walk over twice the
    segment. ``noise`` (n_events, 1, 1, noise size) and ``stream_noise``
    (n_windows, n_events, 1, 1, noise size) are the decoder's draws, from a
    generator on the device seeded 0 when None. ``device``: ``cuda``
    unless ``"cpu"``."""
    dev = default_device(device)
    model = report_model(tiny, dev)
    samplerate = 22050
    segment = get_one_audio_segment(model.n_samples, samplerate, audio_path=audio_path,
                                    seed=seed, device=dev).reshape(1, 1, model.n_samples)
    payload = CheckpointManager(checkpoint_dir).latest() if checkpoint_dir else None
    if payload is not None:
        convert.siam_from_flax(model, payload["params"])
        log(f"loaded checkpoint at step {payload['step']}")
    else:
        log("no checkpoint found — reporting with freshly initialized weights")
    model.eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    if noise is None:
        noise = draw_noise(model, (model.n_events, 1), gen)
    with torch.no_grad(), no_tf32():
        channels, vecs, schedules, _ = make_iterative_fn(model)(segment, noise.to(dev))
        recon = max_norm(torch.sum(channels, dim=1, keepdim=True))
        event_times = torch.argmax(schedules, dim=-1).cpu().numpy().astype(np.float64)
        components = [
            AudioComponent(segment[0, 0].cpu().numpy(), samplerate, "Original"),
            AudioComponent(recon[0, 0].cpu().numpy(), samplerate, "Reconstruction"),
            ImageComponent(stft(recon, 512, 256, pad=True)[0, 0].T.cpu().numpy(),
                           "Reconstruction spectrogram"),
            _SvgComponent(event_scatter_svg(vecs.cpu().numpy(), event_times),
                          "Event vectors over time"),
        ]
        if metrics_path:
            if os.path.exists(metrics_path):
                with open(metrics_path) as f:
                    components.append(_TableComponent(json.load(f)))
            else:
                log(f"metrics file {metrics_path} not found — skipping table")
        if streaming:
            long_audio = get_one_audio_segment(
                model.n_samples * 2, samplerate, audio_path=audio_path,
                seed=None if seed is None else seed + 1, device=dev).reshape(1, 1, -1)
            streamed = streaming_encode(model, long_audio,
                                        None if stream_noise is None else stream_noise.to(dev),
                                        None if stream_noise is not None else gen)
            components.append(AudioComponent(max_norm(streamed)[0, 0].cpu().numpy(), samplerate,
                                             "Streaming reconstruction (2x segment length)"))
    n_params = (sum(int(np.prod(np.shape(x))) for x in _leaves(payload["params"]))
                if payload is not None else sum(p.numel() for p in model.parameters()))
    conjure_article(
        out_path,
        "Sparse Interpretable Audio Model",
        components,
        intro_markdown=(
            "# Sparse interpretable audio codec\n"
            f"Model size: {n_params / 1e6:.2f}M parameters. "
            f"{model.n_events} events per {model.n_samples / samplerate:.1f}s segment."
        ),
    )
    log(f"report -> {out_path}")
    return components


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
