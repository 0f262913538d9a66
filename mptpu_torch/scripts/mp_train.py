"""Command line of ``scripts/mp_train.py`` (BASELINE #1 and #2): learn a
dictionary by greedy matching pursuit on streamed segments, flat or per
octave band with ``--multiband``, and report the reconstruction SNR.

    python -m mptpu_torch.scripts.mp_train [--n-atoms 512] [--atom-size 512]
        [--n-samples 16384] [--steps 100] [--sweeps 25] [--multiband] [--tiny]
        [--device cuda]

``--tiny``: 64 atoms x 128 taps, 4,096 samples, 16 steps, 4 sweeps.
``--multiband`` stores the band dictionaries under ``trained_weights`` in
the working directory, as the script does.
"""

from __future__ import annotations

import argparse
import sys

from ..models import mp_train
from .common import add_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-atoms", type=int, default=512)
    parser.add_argument("--atom-size", type=int, default=512)
    parser.add_argument("--n-samples", type=int, default=16384)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--sweeps", type=int, default=25)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--multiband", action="store_true")
    parser.add_argument("--audio-path", type=str, default=None)
    parser.add_argument("--tiny", action="store_true")
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tiny:
        args.n_atoms, args.atom_size = 64, 128
        args.n_samples, args.steps, args.sweeps = 4096, 16, 4
    kw = dict(n_atoms=args.n_atoms, atom_size=args.atom_size, n_samples=args.n_samples,
              n_steps=args.steps, sweeps=args.sweeps, batch_size=args.batch_size,
              audio_path=args.audio_path, device=args.device)
    if args.multiband:
        mp_train.train_multiband("trained_weights", **kw)
    else:
        mp_train.train_flat(**kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
