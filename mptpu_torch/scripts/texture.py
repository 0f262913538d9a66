"""Command line of ``scripts/texture.py``: synthesize a waveform whose
texture (or scattering) features match one corpus segment's, writing the
dashboard, ``recon.wav`` and ``target.wav`` into ``--out``
(``trained_weights/texture`` in the working directory by default).

    python -m mptpu_torch.scripts.texture [--iterations 1000] [--tiny]
        [--features texture|scattering] [--out DIR] [--device cuda]

``--tiny``: 2^12 samples and 16 filters (2^17 and 64 otherwise).
"""

from __future__ import annotations

import argparse
import sys

from ..models import texture
from .common import add_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--features", choices=("texture", "scattering"),
                   default="texture")
    p.add_argument("--out", type=str, default="trained_weights/texture")
    p.add_argument("--log-every", type=int, default=50)
    return add_device(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    texture.synthesize_texture(args.iterations, args.lr, args.tiny, args.features, args.out,
                               args.log_every, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
