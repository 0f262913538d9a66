"""Command line of ``scripts/textural.py``: overfit the textural model (a
bank of atoms placed by a learned scheduler) to a synthetic segment,
writing ``target.wav``, ``recon.wav`` and ``metrics.json`` into ``--out``
(``trained_weights/textural`` in the working directory by default).

    python -m mptpu_torch.scripts.textural [--iterations 2000] [--smoke]
        [--out DIR] [--device cuda]

``--smoke``: 2^12 samples, 8 events, 8 atoms of 128 taps. A traceback
dump and exit at 7,200 s, as in the script.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..models import textural
from .common import add_device, watchdog

WATCHDOG_S = 7200


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--n-samples", type=int, default=2**16)
    p.add_argument("--n-events", type=int, default=64)
    p.add_argument("--n-atoms", type=int, default=64)
    p.add_argument("--atom-size", type=int, default=2048)
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--confidence-weight", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="trained_weights/textural")
    p.add_argument("--smoke", action="store_true")
    return add_device(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    watchdog(WATCHDOG_S)
    os.makedirs(args.out, exist_ok=True)
    flags = {k: v for k, v in vars(args).items() if k != "device"}
    textural.train_textural(**flags, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
