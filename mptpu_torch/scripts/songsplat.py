"""Command line of ``scripts/songsplat.py``: fit one song-length event
bank by splatting random segments, then render the whole song, writing
checkpoints, ``song_eval.json``, ``song_target.wav`` and ``song_recon.wav``
into ``--out`` (``trained_weights/songsplat`` in the working directory by
default) and serving the dashboard on ``--port`` when it is not 0.

    python -m mptpu_torch.scripts.songsplat [--iterations N] [--tiny]
        [--song path.wav] [--resume | --render-only] [--device cuda]

``--tiny``: a 2^15-sample song, 2^12-sample segments, 16 events a second,
8 a segment.
"""

from __future__ import annotations

import argparse
import sys

from ..models import songsplat
from .common import add_device, watchdog


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=1000)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--song", type=str, default=None)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--out", type=str, default="trained_weights/songsplat")
    parser.add_argument("--log-every", type=int, default=25)
    parser.add_argument("--sparsity", type=float, default=0.0)
    parser.add_argument("--refit", type=float, default=0.0,
                        help="per-segment OMP gain re-fit ridge for the "
                             "whole-song render (0 = raw amplitudes)")
    parser.add_argument("--watchdog-s", type=int, default=0,
                        help="hard in-process exit bound (0 = off)")
    parser.add_argument("--resume", action="store_true",
                        help="restore the newest checkpoint in --out "
                             "before training")
    parser.add_argument("--render-only", action="store_true",
                        help="skip training; render the whole-song "
                             "artifact from the newest checkpoint "
                             "(implies --resume)")
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    watchdog(args.watchdog_s)
    songsplat.train_songsplat(
        iterations=args.iterations, tiny=args.tiny, song=args.song, port=args.port,
        out=args.out, log_every=args.log_every, sparsity=args.sparsity, refit=args.refit,
        resume=args.resume or args.render_only, render_only=args.render_only,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
