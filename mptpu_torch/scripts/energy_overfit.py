"""Command line of ``scripts/energy_overfit.py``: overfit the
energy-conserving instrument and its impulse amplitudes to one corpus
segment (``seed=5``) and print its losses and steps a second.

    python -m mptpu_torch.scripts.energy_overfit [--iterations 500] [--tiny]
        [--disc-weight 0.1] [--device cuda]

``--tiny``: 2^12 samples, block 128, 32 channels, 2 layers.
"""

from __future__ import annotations

import argparse
import sys

from ..models import energy_overfit
from .common import add_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=500)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--disc-weight", type=float, default=0.1)
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    energy_overfit.overfit_energy(args.iterations, args.tiny, args.disc_weight,
                                  device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
