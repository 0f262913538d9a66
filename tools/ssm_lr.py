#!/usr/bin/env python3
"""The SSM overfit (BASELINE #5) at two learning rates, and how far its
float32 gradients are from float64, on a CUDA card.

    python3 tools/ssm_lr.py [--steps 300]

It writes the demo corpus under a temporary ``MPTPU_CACHE`` and, for each
of its four files alone, trains ``train_model_for_segment`` at full width
(2^18 samples, window 128, control 64, state 128, 512 sites) on that
file's ``get_one_audio_segment(seed=0)`` for ``--steps`` steps at lr 1e-2
(``scripts/ssm_article.py``'s) and at 1e-3, and prints the first, the
largest (with its step) and the last loss. Then, on the corpus as
``chip_smoke.py``'s phase 8 reads it, one forward and backward in float32
on the card with cuDNN's RNN, on the card without cuDNN, and on the CPU,
each against float64 on the card: the gradients by group (max abs error
over the largest) and how many signs of the loss's l1 residual differ.
Needs a card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssm_lr: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mptpu_torch import parity_mode
    from mptpu_torch.data import ensure_demo_dataset, get_one_audio_segment
    from mptpu_torch.models import OverfitControlPlane, train_model_for_segment
    from mptpu_torch.models.ssm_overfit import transform

    parity_mode()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = chip_smoke.SSM
    n, window, cpd, state, sites = (cfg[k] for k in ("n_samples", "window", "control", "state",
                                                      "sites"))
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["MPTPU_CACHE"] = tmp
        os.environ.pop("AUDIO_PATH", None)
        demo = ensure_demo_dataset(os.path.join(tmp, "demo_audio"))
        for name in sorted(os.listdir(demo)):
            alone = os.path.join(tmp, name + ".alone")
            os.makedirs(alone)
            shutil.copy(os.path.join(demo, name), alone)
            for lr in (1e-2, 1e-3):
                fit = train_model_for_segment(n, window, cpd, state, sites, args.steps, lr,
                                              audio_path=alone, seed=0, device=dev)
                losses = np.asarray(fit.losses)
                print(f"{name} alone, lr {lr:g}, {args.steps} steps: first {losses[0]:.1f}, "
                      f"largest {losses.max():.1f} at step {int(losses.argmax())}, last "
                      f"{losses[-1]:.1f}; {fit.steps_per_sec:.1f} steps/s")

        target = get_one_audio_segment(n, seed=0, device=dev)
        state_dict = OverfitControlPlane(cpd, window, state, n, window, sites,
                                         device=dev).state_dict()

        def forward_backward(device, dtype, cudnn=True):
            torch.backends.cudnn.enabled = cudnn
            try:
                m = OverfitControlPlane(cpd, window, state, n, window, sites, device=device)
                m.load_state_dict(state_dict)
                m = m.to(dtype)
                audio, diff = m()
                residual = transform(audio) - transform(target.to(device, dtype))
                loss = residual.abs().sum() + diff.abs().sum()
                names, params = zip(*m.named_parameters())
                grads = dict(zip(names, torch.autograd.grad(loss, params)))
            finally:
                torch.backends.cudnn.enabled = True
            return grads, torch.sign(residual.detach()).cpu(), float(loss.detach())

        ref = forward_backward(dev, torch.float64)
        groups = chip_smoke.SSM_GROUPS
        runs = {"card, cuDNN": forward_backward(dev, torch.float32),
                "card, no cuDNN": forward_backward(dev, torch.float32, cudnn=False),
                "CPU": forward_backward(torch.device("cpu"), torch.float32)}
        print(f"phase 8's target, loss {ref[2]:.4f} in float64 on the card")
        for label, (grads, signs, loss) in runs.items():
            errs = {g: max(chip_smoke.share_err(grads[k], ref[0][k]) for k in names)
                    for g, names in groups.items()}
            print(f"{label}, float32 against float64 on the card: loss {loss:.4f}; gradients "
                  + ", ".join(f"{g} {e:.2e}" for g, e in errs.items())
                  + f"; signs of the l1 residual that differ {int((signs != ref[1]).sum())} "
                  f"of {signs.numel()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
