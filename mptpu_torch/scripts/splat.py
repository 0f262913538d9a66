"""Command line of ``scripts/splat.py`` (BASELINE #3): overfit the audio
splatting model to one corpus segment, print its losses and steps a
second, and with ``--article`` write the HTML article (original,
reconstruction, the events perturbed, the spectrogram).

    python -m mptpu_torch.scripts.splat [--iterations 3000] [--n-events 64]
        [--n-samples 65536] [--article out.html] [--tiny] [--device cuda]

``--tiny``: 2^13 samples, 8 events, 50 iterations. The losses are read
once, after the fit, and printed as the script prints them during it.
"""

from __future__ import annotations

import argparse
import sys

from ..data.audioiter import get_one_audio_segment
from ..models import splat_overfit
from .common import add_device, print_losses


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=3000)
    parser.add_argument("--n-events", type=int, default=64)
    parser.add_argument("--n-samples", type=int, default=2**16)
    parser.add_argument("--article", type=str, default=None)
    parser.add_argument("--audio-path", type=str, default=None)
    parser.add_argument("--iterative-loss", action="store_true")
    parser.add_argument("--tiny", action="store_true")
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tiny:
        args.n_samples, args.n_events, args.iterations = 2**13, 8, 50
    target = get_one_audio_segment(args.n_samples, 22050, audio_path=args.audio_path,
                                   device=args.device).reshape(1, 1, args.n_samples)
    fit = splat_overfit.overfit_splat(target, n_events=args.n_events,
                                      n_iterations=args.iterations,
                                      use_iterative_loss=args.iterative_loss, device=args.device)
    print_losses(fit.losses, 100)
    print(f"{fit.steps_per_sec:.2f} overfit steps/sec")
    splat_overfit.splat_article(fit, target, args.article)
    if args.article:
        print(f"article written to {args.article}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
