#!/usr/bin/env python3
"""How far the octave bands and the splat loss's feature are from float64,
on a CUDA card and on the CPU.

    python3 tools/band_precision.py

On ``chip_smoke.py``'s splat target (2^16 samples of three decaying sines
plus noise) it prints, for every band of ``fft_frequency_decompose`` (min
size 512) and for ``splat_loss_transform``, the largest float32 error over
the largest value, against the same device in float64: on the card and on
the CPU, and on the card once more with each band's inverse FFT fed the
raw slice of the spectrum, without ``_real_ends`` zeroing the imaginary
parts of its first and last coefficients. Needs a card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("band_precision: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mptpu_torch import parity_mode
    from mptpu_torch.ops import decompose
    from mptpu_torch.models.splat_overfit import splat_loss_transform

    parity_mode()
    n = chip_smoke.SPLAT["n_samples"]
    x_np = chip_smoke.sines_signal(n, np.random.default_rng(0)).reshape(1, 1, n)

    def outputs(device, dtype):
        x = torch.from_numpy(x_np).to(device, dtype)
        out = {f"band {k}": v for k, v in decompose.fft_frequency_decompose(x, 512).items()}
        out["splat feature"] = splat_loss_transform(x)
        return {k: v.double().cpu() for k, v in out.items()}

    runs = {
        "card": (outputs("cuda", torch.float32), outputs("cuda", torch.float64)),
        "CPU": (outputs("cpu", torch.float32), outputs("cpu", torch.float64)),
    }
    kept = decompose._real_ends
    decompose._real_ends = lambda spec: spec
    try:
        runs["card, raw slices"] = (outputs("cuda", torch.float32),
                                    outputs("cuda", torch.float64))
    finally:
        decompose._real_ends = kept
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"{smi.stdout.strip()}; float32 max abs err over the largest value, against float64 "
          f"on the same device ({', '.join(runs)})")
    for key in runs["card"][0]:
        errs = []
        for f32, f64 in runs.values():
            scale = float(f64[key].abs().max())
            errs.append(float((f32[key] - f64[key]).abs().max()) / scale)
        print(f"{key:14s} " + "  ".join(f"{e:.2e}" for e in errs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
