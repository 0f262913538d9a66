"""The generalization report: held-out metric trajectories of several
quality runs (a fixed corpus against a fresh one) as small-multiple SVG
line charts, a plateau table and each run's eval table, in one standalone
HTML article (counterpart of ``scripts/report_generalization.py``, whose
chart and table code is numpy and is copied here). The script reads
``trained_weights/<run>/metrics.json``; the port takes the run directories
and the output path from the caller.
"""

from __future__ import annotations

import html
import json
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.article import conjure_article

# the series' colours, assigned in order; text in ink
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]
INK, INK2, GRID = "#0b0b0b", "#52514e", "#e4e3df"

METRICS = [
    ("first_half_lsd_db", "First-half holdout LSD (dB, lower is better)"),
    ("holdout_snr_db", "Holdout waveform SNR (dB, higher is better)"),
    ("first_half_pif_dist", "First-half PIF perceptual distance (lower is better)"),
    ("holdout_lsd_db", "Full-segment holdout LSD (dB, lower is better)"),
]


def line_chart_svg(series, title, width=640, height=260):
    """series: list of (label, color, xs, ys). One y-axis, recessive
    grid, 2px lines, point markers with native tooltips, direct end
    labels in ink beside a colored dot."""
    ml, mr, mt, mb = 52, 120, 14, 30
    pw, ph = width - ml - mr, height - mt - mb
    all_x = np.concatenate([np.asarray(x, float) for _, _, x, _ in series])
    all_y = np.concatenate([np.asarray(y, float) for _, _, _, y in series])
    x0, x1 = float(all_x.min()), float(all_x.max())
    y0, y1 = float(all_y.min()), float(all_y.max())
    ypad = max((y1 - y0) * 0.08, 1e-6)
    y0, y1 = y0 - ypad, y1 + ypad
    if x1 <= x0:
        x1 = x0 + 1.0

    def sx(x):
        return ml + (x - x0) / (x1 - x0) * pw

    def sy(y):
        return mt + (1.0 - (y - y0) / (y1 - y0)) * ph

    parts = [
        f'<svg viewBox="0 0 {width} {height}" width="100%" '
        f'font-family="system-ui,sans-serif" font-size="11">'
    ]
    # recessive grid + y tick labels
    for gy in np.linspace(y0 + ypad, y1 - ypad, 4):
        parts.append(
            f'<line x1="{ml}" y1="{sy(gy):.1f}" x2="{ml + pw}" '
            f'y2="{sy(gy):.1f}" stroke="{GRID}" stroke-width="1"/>'
            f'<text x="{ml - 6}" y="{sy(gy) + 3:.1f}" text-anchor="end" '
            f'fill="{INK2}">{gy:.1f}</text>'
        )
    # x axis ticks (steps)
    for gx in np.linspace(x0, x1, 5):
        parts.append(
            f'<text x="{sx(gx):.1f}" y="{height - 8}" text-anchor="middle" '
            f'fill="{INK2}">{gx / 1000:.0f}k</text>'
        )
    parts.append(
        f'<line x1="{ml}" y1="{mt + ph}" x2="{ml + pw}" y2="{mt + ph}" '
        f'stroke="{INK2}" stroke-width="1"/>'
    )
    for label, color, xs, ys in series:
        pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
        parts.append(
            f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="2" stroke-linejoin="round"/>'
        )
        for x, y in zip(xs, ys):
            parts.append(
                f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="2.5" '
                f'fill="{color}"><title>{html.escape(label)} — step '
                f"{int(x):,}: {y:.3f}</title></circle>"
            )
        # direct end label: colored dot + ink text
        ex, ey = sx(xs[-1]), sy(ys[-1])
        parts.append(
            f'<circle cx="{ex + 10:.1f}" cy="{ey:.1f}" r="4" fill="{color}"/>'
            f'<text x="{ex + 18:.1f}" y="{ey + 4:.1f}" fill="{INK}">'
            f"{html.escape(label)}</text>"
        )
    parts.append("</svg>")
    return (
        f'<div class="component"><h3>{html.escape(title)}</h3>'
        + "".join(parts)
        + "</div>"
    )


class _Raw:
    def __init__(self, markup):
        self.markup = markup

    def render(self):
        return self.markup


def plateau_row(label, evals, key):
    ys = [e[key] for e in evals if key in e]
    if not ys:
        return None
    last10 = ys[-min(10, len(ys)) :]
    steps = [e["step"] for e in evals if key in e]
    # least-squares slope per 10k steps over the last half
    n2 = max(2, len(ys) // 2)
    xs = np.asarray(steps[-n2:], float)
    yy = np.asarray(ys[-n2:], float)
    slope = float(np.polyfit(xs, yy, 1)[0] * 1e4) if len(xs) > 1 else 0.0
    return dict(
        label=label,
        best=min(ys),
        last=ys[-1],
        mean_last10=float(np.mean(last10)),
        slope_per_10k=slope,
        steps=steps[-1],
    )


INTRO = (
    "The round-4 fixed-corpus experiment trained 30k steps on 144 s of "
    "synthetic audio: every holdout metric froze by ~5k steps while the "
    "training loss kept falling — memorization, with corpus entropy as "
    "the isolated blocker (BENCHMARKS.md). This page tracks the "
    "counter-experiment: identical model and knobs, but freshly "
    "synthesized training segments every batch (seed space disjoint "
    "from the holdout), the regime closest to the reference's ~34 h "
    "MusicNet runs (v3blogpost.py:59-93). The question: does the "
    "first-half holdout LSD break below the 25.1 dB plateau — and if "
    "it does, does waveform SNR follow?"
)


def make_generalization_report(runs: Sequence[Tuple[str, str]], out_path: str,
                               log: Callable[[str], None] = print,
                               root: Optional[str] = None) -> List[_Raw]:
    """The page of ``runs`` ((run directory, label) pairs; an empty label
    takes the directory's name), written to ``out_path``; returns its
    components. With ``root`` the directories are named under it, and a
    run's name is the one given (the script's ``--runs`` under
    ``trained_weights``). A run without ``metrics.json`` or without evals is
    skipped; raises when none is left."""
    loaded = []
    for i, (d, label) in enumerate(runs):
        path = os.path.join(root or "", d, "metrics.json")
        name = d if root else os.path.basename(os.path.normpath(d))
        if not os.path.exists(path):
            log(f"skip {name}: no metrics.json")
            continue
        with open(path) as f:
            m = json.load(f)
        evals = m.get("eval", [])
        if not evals:
            log(f"skip {name}: empty eval trajectory")
            continue
        loaded.append((label or name, SERIES[i % len(SERIES)], evals, m))
    if not loaded:
        raise ValueError("no runs with eval trajectories found")

    components = []
    # on a fresh corpus every batch is unseen, so the smoothed training loss
    # is itself a generalization loss: plotted first, against the fixed run's
    loss_series = []
    for label, color, _, m in loaded:
        pts = m.get("losses", [])
        if len(pts) < 8:
            continue
        xs = np.asarray([p[0] for p in pts], float)
        ys = np.asarray([p[1] for p in pts], float)
        k = max(1, len(ys) // 60)  # ~60 plotted points
        n = (len(ys) // k) * k
        xs = xs[:n].reshape(-1, k).mean(axis=1)
        ys = ys[:n].reshape(-1, k).mean(axis=1)
        loss_series.append((label, color, xs.tolist(), ys.tolist()))
    if loss_series:
        components.append(_Raw(line_chart_svg(
            loss_series,
            "Training loss, block-averaged (fresh corpus: every "
            "batch unseen => this IS a generalization loss)")))
    for key, title in METRICS:
        series = []
        for label, color, evals, _ in loaded:
            xs = [e["step"] for e in evals if key in e]
            ys = [e[key] for e in evals if key in e]
            if xs:
                series.append((label, color, xs, ys))
        if series:
            components.append(_Raw(line_chart_svg(series, title)))

    rows = [r for r in (plateau_row(label, evals, "first_half_lsd_db")
                        for label, _, evals, _ in loaded) if r]
    tbl = [
        "<table><tr><th>run</th><th>steps</th><th>best LSD</th>"
        "<th>last LSD</th><th>mean last-10</th>"
        "<th>slope dB/10k (last half)</th></tr>"
    ]
    for r in rows:
        tbl.append(
            f"<tr><td>{html.escape(r['label'])}</td><td>{r['steps']:,}</td>"
            f"<td>{r['best']:.2f}</td><td>{r['last']:.2f}</td>"
            f"<td>{r['mean_last10']:.2f}</td><td>{r['slope_per_10k']:+.3f}</td></tr>"
        )
    tbl.append("</table>")
    components.append(_Raw('<div class="component"><h3>First-half holdout LSD plateau '
                           "analysis</h3>" + "".join(tbl) + "</div>"))
    # every chart has a table twin
    for label, _, evals, _ in loaded:
        hdr = [k for k, _ in METRICS if any(k in e for e in evals)]
        t = ["<details><summary>%s — full eval table</summary><table><tr>"
             "<th>step</th>" % html.escape(label)]
        t.append("".join(f"<th>{h}</th>" for h in hdr) + "</tr>")
        for e in evals:
            t.append(f"<tr><td>{e['step']:,}</td>"
                     + "".join(f"<td>{e.get(h, '')}</td>" for h in hdr) + "</tr>")
        t.append("</table></details>")
        components.append(_Raw("".join(t)))
    conjure_article(out_path, "Generalization: corpus entropy A/B", components, INTRO)
    log(f"wrote {out_path}")
    return components
