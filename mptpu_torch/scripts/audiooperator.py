"""Command line of ``scripts/audiooperator.py``: train the audio operator
on freshly sampled synthetic events (start, duration, envelope, latent),
writing ``metrics.json`` into ``--out`` (``trained_weights/audiooperator``
in the working directory by default).

    python -m mptpu_torch.scripts.audiooperator [--iterations 2000]
        [--smoke] [--overfit] [--out DIR] [--device cuda]

``--smoke``: 2^11 samples, 16 bands, model width 32, envelopes of 32,
latents of 8, pooling 128 / 32. A traceback dump and exit at 7,200 s, as
in the script.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..models import audiooperator
from .common import add_device, watchdog

WATCHDOG_S = 7200


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--n-samples", type=int, default=2**15)
    p.add_argument("--n-bands", type=int, default=512)
    p.add_argument("--max-freq", type=float, default=2048.0)
    p.add_argument("--envelope-resolution", type=int, default=128)
    p.add_argument("--latent-dim", type=int, default=64)
    p.add_argument("--model-dim", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--pool-window", type=int, default=512)
    p.add_argument("--pool-step", type=int, default=128)
    p.add_argument("--overfit", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="trained_weights/audiooperator")
    p.add_argument("--smoke", action="store_true")
    return add_device(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    watchdog(WATCHDOG_S)
    os.makedirs(args.out, exist_ok=True)
    flags = {k: v for k, v in vars(args).items() if k != "device"}
    audiooperator.train_audiooperator(**flags, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
