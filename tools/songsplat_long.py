#!/usr/bin/env python3
"""The whole-song splat trainer at ``scripts/songsplat.py``'s reference
configuration for as many steps as ``mptpu``'s own run of it, on a CUDA
card.

    python3 tools/songsplat_long.py [--steps 2000]

``trained_weights/songsplat_full/song_eval.json`` is ``mptpu``'s run: 2,000
steps, the whole song rendered with the gain refit at ridge 1e-4. This
trains ``train_songsplat(iterations=--steps, port=0)`` (output in a
temporary directory, the script's synthetic song) and prints the card's
name and power limit, steps a second on the host clock, the means of every
100 steps' own losses and of the first and last 20, the loss over
the render's segments with one fixed noise (``chip_smoke.py``'s
``songsplat_fixed_loss``) before and after, and the covered SNR and LSD of
the whole-song render at ``mptpu``'s refit for the untrained and the trained
model, beside ``mptpu``'s file. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
REFIT = 1e-4   # the ridge of mptpu's run


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=2000)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("songsplat_long: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mptpu_torch import parity_mode
    from mptpu_torch.models import songsplat as ss

    parity_mode()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    total, seg, eps, cap = ss.REFERENCE
    song = ss.get_song(None, total, 22050)
    untrained = ss.SongSplatModel(total, seg, events_per_second=eps, events_per_segment=cap,
                                  device=dev)
    before = chip_smoke.songsplat_fixed_loss(untrained, song)
    _, eval_before = ss.render_song(untrained, song, REFIT, device=dev)
    del untrained
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        run = ss.train_songsplat(iterations=args.steps, port=0, out=out, refit=REFIT,
                                 device=dev, log=lambda line: None)
        wall = time.perf_counter() - t0
    steps_s = (args.steps - 1) / (run.t_end - run.step_starts[1])
    after = chip_smoke.songsplat_fixed_loss(run.model, song)
    losses, w = run.step_losses, 100
    print(f"train_songsplat at the reference configuration ({total} samples, segments of {seg}, "
          f"{eps:g} events a second, capacity {cap}), {args.steps} steps: {steps_s:.2f} steps/s "
          f"after the first (host clock), {wall:.1f} s with the checkpoints and the render")
    print(f"the means of every {w} steps' own losses: "
          + ", ".join(f"{np.mean(losses[s: s + w]):.1f}" for s in range(0, len(losses), w)))
    print(f"the means of the first and last 20 steps' losses: {np.mean(losses[:20]):.1f}, "
          f"{np.mean(losses[-20:]):.1f}; every loss finite: {bool(np.isfinite(losses).all())}")
    print(f"the loss over the render's segments, one fixed noise: {before:.1f} before, "
          f"{after:.1f} after")
    print(f"the whole song at refit {REFIT:g}, untrained: {json.dumps(eval_before)}")
    print(f"the whole song at refit {REFIT:g}, trained: {json.dumps(run.eval)}")
    theirs = ROOT / "trained_weights" / "songsplat_full" / "song_eval.json"
    if theirs.exists():   # a copy of the repo without trained_weights/ lacks it
        print(f"mptpu's run ({theirs.relative_to(ROOT)}): {theirs.read_text()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
