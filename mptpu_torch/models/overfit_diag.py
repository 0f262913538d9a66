"""Split a SIAM overfit checkpoint's residual error into phase, magnitude
and coverage parts (counterpart of ``scripts/overfit_diag.py``).

On the first-half eval of one fade-tailed window (the model at the
scripts' widths, the newest ``ckpt_*.pkl`` of the run, the fixed noise of
``PRNGKey(42)``, see :mod:`.overfit_refine_eval`):

- the waveform SNR, and the SNR after the best global gain (is amplitude
  calibration the gap?);
- the magnitude-spectrogram SNR (phase-blind: high while the waveform
  SNR is low means the residual is phase error);
- the events' energies and how many are alive;
- the error energy by quarter of the covered half (coverage gaps?).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..device import default_device, no_tf32
from ..sparse import quantize
from .overfit_refine_eval import (WIDTHS, check_flags, eval_model, first_window, load_into,
                                  newest_checkpoint)
from .siam import siam_transform
from .siam_overfit import snr_db

DEFAULTS = dict(selection_leak=0.02, selection_floor=0.0, attn_floor=0.01, attn_leak=0.1,
                switch_clamp=20.0, switch_bias_init=1.0, seed=3)


def diag(run: str, out: str, ckpt: Optional[str] = None, noise: Optional[torch.Tensor] = None,
         device=None, log: Callable[[str], None] = print, widths: Optional[dict] = None,
         **flags) -> dict:
    """The script's report, written into ``out`` as ``diag.json`` (rounded
    as the script rounds); returns it unrounded. ``flags`` are the
    script's (``DEFAULTS``), ``widths`` the model's, ``noise`` the
    decoder's draw (from a generator seeded 42 when None)."""
    a = check_flags(flags, DEFAULTS)
    w = dict(WIDTHS, **(widths or {}))
    dev = default_device(device)
    with quantize.selection_knobs(a["selection_leak"], a["selection_floor"]), torch.no_grad(), \
            no_tf32():
        model = eval_model(w, dev, attn_floor=a["attn_floor"], attn_leak=a["attn_leak"],
                           switch_clamp=a["switch_clamp"], switch_bias_init=a["switch_bias_init"])
        path = newest_checkpoint(run, ckpt)
        load_into(model, path, log)
        target, (channels, _, schedules, _) = first_window(model, a["seed"], noise, 42)
        half = w["n_samples"] // 2
        recon = torch.sum(channels, dim=1, keepdim=True)
        t_h, r_h = target[..., :half], recon[..., :half]
        g = float(torch.sum(t_h * r_h) / torch.clamp_min(torch.sum(r_h**2), 1e-12))
        ts = siam_transform(t_h, w["window"], w["step"])
        rs = siam_transform(r_h, w["window"], w["step"])
        mag_snr = float(10 * torch.log10(torch.sum(ts**2)
                                         / torch.clamp_min(torch.sum((ts - rs) ** 2), 1e-12)))
        ev_energy = torch.sum(channels[0, :, :half] ** 2, dim=-1).cpu().numpy()
        target_energy = float(torch.sum(t_h**2))
        err = ((t_h - r_h)[0, 0] ** 2).cpu().numpy()
        tgt = (t_h[0, 0] ** 2).cpu().numpy()
        report = {
            "ckpt": path,
            "wave_snr_db": float(snr_db(t_h, r_h)),
            "optimal_gain": g,
            "gain_adjusted_snr_db": float(snr_db(t_h, g * r_h)),
            "mag_spec_snr_db": mag_snr,
            "sched_max": float(torch.max(schedules)),
        }
    q = half // 4
    ordered = np.sort(ev_energy)
    report.update(
        alive_events=int(np.sum(ev_energy > 1e-6 * target_energy)),
        event_energy_top8=[float(x) for x in ordered[::-1][:8]],
        event_energy_bottom8=[float(x) for x in ordered[:8]],
        target_energy_half=target_energy,
        err_by_quartile=[dict(err=float(err[i * q:(i + 1) * q].sum()),
                              tgt=float(tgt[i * q:(i + 1) * q].sum())) for i in range(4)])
    written = dict(report)
    for k in ("wave_snr_db", "gain_adjusted_snr_db", "mag_spec_snr_db", "target_energy_half"):
        written[k] = round(report[k], 3)
    for k in ("optimal_gain", "sched_max"):
        written[k] = round(report[k], 4)
    written["event_energy_top8"] = [round(x, 4) for x in report["event_energy_top8"]]
    written["event_energy_bottom8"] = [round(x, 6) for x in report["event_energy_bottom8"]]
    log(json.dumps(written, indent=1))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "diag.json"), "w") as f:
        json.dump(written, f, indent=1)
    return report
