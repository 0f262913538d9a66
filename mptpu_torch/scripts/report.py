"""Command line of ``scripts/report.py``: the static demo page. By default
the codec's page (a corpus segment, its reconstruction by the newest
checkpoint of ``--checkpoint``, the spectrogram, the events and, with
``--metrics``, a quality run's table); with ``--overfit-run`` or
``--songsplat-run`` that run directory's own artifacts, no model forward.

    python -m mptpu_torch.scripts.report [--checkpoint trained_weights/siam]
        [--out report.html] [--tiny] [--streaming] [--device cuda]

The decoder's noise is the port's (a generator seeded 0).
"""

from __future__ import annotations

import argparse
import sys

from ..models import report
from .common import add_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, default="trained_weights/siam")
    parser.add_argument("--out", type=str, default="report.html")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--streaming", action="store_true")
    parser.add_argument("--audio-path", type=str, default=None)
    parser.add_argument("--seed", type=int, default=None,
                        help="segment seed; match the trainer's --seed to report\n"
                             "on the exact audio an --overfit run was fit to")
    parser.add_argument("--metrics", type=str, default=None,
                        help="path to a siam_quality metrics.json to render")
    parser.add_argument("--songsplat-run", type=str, default=None,
                        help="render a songsplat run directory's whole-"
                             "song artifacts")
    parser.add_argument("--overfit-run", type=str, default=None,
                        help="render an overfit run directory's own "
                             "artifacts (target.wav/recon_best.wav/"
                             "metrics.json); no model forward")
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.overfit_run:
        report.make_overfit_report(args.overfit_run, args.out)
    elif args.songsplat_run:
        report.make_songsplat_report(args.songsplat_run, args.out)
    else:
        report.make_report(args.checkpoint, args.out, tiny=args.tiny, streaming=args.streaming,
                           audio_path=args.audio_path, seed=args.seed,
                           metrics_path=args.metrics, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
