"""Command line of ``scripts/phaseinvariance.py``: overfit raw audio
samples so that a transform of them matches the transform of a synthetic
target, for three transforms (magnitude STFTs 512 / 256 and 2048 / 256,
the auditory image model), writing ``source.wav``, ``recon_<name>.wav``,
``metrics.json`` and ``report.html`` into ``--out``
(``trained_weights/phaseinvariance`` in the working directory by default).

    python -m mptpu_torch.scripts.phaseinvariance [--iterations 1000]
        [--n-samples N] [--smoke] [--out DIR] [--device cuda]

``--smoke``: 2^13 samples and 50 iterations, whatever the other flags say.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..models import phaseinvariance
from .common import add_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--n-samples", type=int, default=2**17)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="trained_weights/phaseinvariance")
    p.add_argument("--smoke", action="store_true")
    return add_device(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    flags = {k: v for k, v in vars(args).items() if k != "device"}
    phaseinvariance.run_phaseinvariance(**flags, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
