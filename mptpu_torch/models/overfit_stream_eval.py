"""The streaming walk's eval of a SIAM overfit checkpoint (counterpart of
``scripts/overfit_stream_eval.py``).

The encoder's in-window mask keeps a single window's events in its first
half by design; the half-overlap walk covers the whole segment. This
encodes the overfit target through the walk (padded with one window of
silence, so that the walk's windows tile past the segment's end) and
reports the whole segment's SNR, LSD and PIF distance beside each half's
SNR, for the default walk (the time-domain residual handoff) and the
spectrogram write-back walk, and on request the walk with each (window,
event) gain re-fit (and alignment refinement) against the target, and the
walk with every window encoded from the pristine input.

Every window decodes with the trainer's ``--fixed-noise`` draw (event ``i``
with ``noise[i]``; ``mptpu`` folds ``i`` into ``PRNGKey(42)``). The run's
``metrics.json`` config line sets ``spectral_skip`` and
``spectral_filter``; the checkpoint is ``ema_best.pkl`` or the newest
``ckpt_*.pkl``. The port writes into the directory the caller gives.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import torch

from ..device import default_device, no_tf32
from ..sparse import quantize
from ..utils.wav import write_wav
from .codec_rate import SAMPLE_RATE, choose_checkpoint, recorded_config, segment, walk_target
from .overfit_refine_eval import WIDTHS, check_flags, eval_model, load_into
from .siam import draw_noise, make_streaming_fn
from .siam_overfit import lsd_db, pif_dist, snr_db

DEFAULTS = dict(selection_leak=0.02, selection_floor=0.0, attn_floor=0.01, attn_leak=0.1,
                switch_clamp=20.0, seed=3, n_samples_log2=17, n_events=32, hidden=128,
                context_dim=32, audio_events=0, stream_windows=1, gain_refit=0.0,
                align_refine=0, pristine_windows=False)


def stream_eval(run: str, out: str, ckpt: Optional[str] = None,
                noise: Optional[torch.Tensor] = None, device=None,
                log: Callable[[str], None] = print, **flags) -> dict:
    """The script's report, written into ``out`` as ``stream_eval.json``
    (rounded as the script rounds) with ``recon_streaming.wav`` (and
    ``recon_streaming_refit.wav``, ``recon_streaming_pristine.wav`` when
    those walks run); returns it unrounded. ``flags`` are the script's
    (``DEFAULTS``), ``noise`` the decoder's draw (n_events, 1, 1, noise
    size; from a generator seeded 42 when None). ``device``: ``cuda``
    unless ``"cpu"``."""
    a = check_flags(flags, DEFAULTS)
    dev = default_device(device)
    cfg, _ = recorded_config(run)
    n = 2 ** a["n_samples_log2"]
    widths = dict(WIDTHS, n_samples=n, n_events=a["n_events"], hidden=a["hidden"],
                  context_dim=a["context_dim"])
    with quantize.selection_knobs(a["selection_leak"], a["selection_floor"]), torch.no_grad(), \
            no_tf32():
        model = eval_model(widths, dev, attn_floor=a["attn_floor"], attn_leak=a["attn_leak"],
                           switch_clamp=a["switch_clamp"],
                           spectral_skip="spectral_skip True" in cfg,
                           spectral_filter="spectral_filter True" in cfg)
        path = choose_checkpoint(run, ckpt)
        load_into(model, path, log)
        seg = torch.from_numpy(segment(n, a["seed"], a["audio_events"],
                                       a["stream_windows"])).to(dev).reshape(1, 1, -1)
        total_len = seg.shape[-1]
        half = n // 2
        # scored against what the model was trained to reconstruct: in the
        # union of the walk's windows only the last half window is faded
        target = walk_target(seg, n)
        padded = torch.nn.functional.pad(target, (0, n))
        if noise is None:
            noise = draw_noise(model, (model.n_events, 1),
                               torch.Generator(device=dev).manual_seed(42))
        stream = make_streaming_fn(model)

        def walk(**kw):
            return stream(padded, noise.to(dev), fixed_noise=True, **kw)[..., :total_len]

        walks = {"streaming": walk(), "spec": walk(mode="spec")}
        if a["gain_refit"]:
            walks["refit"] = walk(refit_gains_against=padded, refit_ridge=a["gain_refit"],
                                  align_refine=a["align_refine"])
        if a["pristine_windows"]:
            walks["pristine"] = walk(
                refit_gains_against=padded if a["gain_refit"] else None,
                refit_ridge=a["gain_refit"] or 1e-3, align_refine=a["align_refine"],
                pristine_windows=True)

        def halves(prefix, recon):
            return {f"{prefix}_first_half_snr_db": float(snr_db(target[..., :half],
                                                                recon[..., :half])),
                    f"{prefix}_second_half_snr_db": float(snr_db(target[..., half:],
                                                                 recon[..., half:]))}

        def full(prefix, recon):
            return {f"{prefix}_full_snr_db": float(snr_db(target, recon)),
                    f"{prefix}_full_lsd_db": float(lsd_db(target, recon, widths["window"],
                                                          widths["step"]))}

        rec = walks["streaming"]
        report = {"ckpt": path, "stream_windows": max(1, a["stream_windows"]),
                  "total_len": int(total_len), "default_mode": "handoff", **full("streaming", rec)}
        report.update(halves("streaming", rec))
        report["streaming_full_pif_dist"] = pif_dist(target, rec)
        report["spec_full_snr_db"] = float(snr_db(target, walks["spec"]))
        report["spec_first_half_snr_db"] = float(snr_db(target[..., :half],
                                                        walks["spec"][..., :half]))
        if "refit" in walks:
            report.update(refit_ridge=a["gain_refit"], align_refine=a["align_refine"],
                          **full("refit", walks["refit"]))
            report["refit_full_pif_dist"] = pif_dist(target, walks["refit"])
            report.update(halves("refit", walks["refit"]))
        if "pristine" in walks:
            report.update(full("pristine", walks["pristine"]))
            report["pristine_full_pif_dist"] = pif_dist(target, walks["pristine"])
            report.update(halves("pristine", walks["pristine"]))
    written = {k: (round(v, 4) if k.endswith("pif_dist") else round(v, 3) if k.endswith("_db")
                   else v) for k, v in report.items()}
    log(json.dumps(written, indent=1))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "stream_eval.json"), "w") as f:
        json.dump(written, f, indent=1)
    for name, wav in (("streaming", "recon_streaming.wav"), ("refit", "recon_streaming_refit.wav"),
                      ("pristine", "recon_streaming_pristine.wav")):
        if name in walks:
            write_wav(os.path.join(out, wav), walks[name][0, 0].cpu().numpy(), SAMPLE_RATE)
    return report
