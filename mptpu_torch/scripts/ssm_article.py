"""Command line of ``scripts/ssm_article.py`` (BASELINE #5): overfit the
playable state-space model's control plane to one corpus segment, print
its losses and steps a second, and with ``--article`` write the HTML
article and its weights JSON beside it.

    python -m mptpu_torch.scripts.ssm_article [--iterations 1000]
        [--article ssm.html] [--tiny] [--device cuda]

``--tiny``: 2^13 samples, window 64, control plane 16, state 32, 64
active sites. The losses are read once, after the fit, and printed as the
script prints them during it.
"""

from __future__ import annotations

import argparse
import sys

from ..models import ssm_overfit
from .common import add_device, print_losses


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=1000)
    parser.add_argument("--article", type=str, default=None)
    parser.add_argument("--audio-path", type=str, default=None)
    parser.add_argument("--tiny", action="store_true")
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    kwargs = dict(n_iterations=args.iterations, article_path=args.article,
                  audio_path=args.audio_path)
    if args.tiny:
        kwargs.update(
            n_samples=2**13, window_size=64, control_plane_dim=16,
            state_dim=32, n_active_sites=64,
        )
    fit = ssm_overfit.train_model_for_segment(**kwargs, device=args.device)
    print_losses(fit.losses, 100)
    print(f"{fit.steps_per_sec:.2f} steps/sec")
    if args.article:
        weights = args.article.replace(".html", "_weights.json")
        print(f"article -> {args.article}; weights -> {weights}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
