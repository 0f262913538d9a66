"""Command line of ``scripts/resonance_overfit.py``: overfit the resonance
stack to one corpus segment (``seed=9``) and print its losses and steps a
second.

    python -m mptpu_torch.scripts.resonance_overfit [--iterations 500] [--tiny]
        [--device cuda]

``--tiny``: 2^12 samples (2^15 otherwise).
"""

from __future__ import annotations

import argparse
import sys

from ..models import resonance_overfit
from .common import add_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=500)
    parser.add_argument("--tiny", action="store_true")
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resonance_overfit.overfit_resonance(args.iterations, args.tiny, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
