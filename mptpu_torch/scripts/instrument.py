"""Command line of ``scripts/instrument.py``: the playable instrument over
a SIAM checkpoint, rendering a demo phrase to ``--demo`` or, without it,
reading REPL commands from stdin:

  note <time_s> [amp] [seed]   queue a random-latent note at time_s
  vec <i> <time_s> [amp]       queue bank vector i at time_s
  harvest                      fill the vector bank from a real segment
  render [out.wav]             render queued notes to WAV
  list | clear | quit

    python -m mptpu_torch.scripts.instrument [--checkpoint DIR] [--tiny]
        [--demo out.wav] [--device cuda]

``--checkpoint`` is a directory (its newest checkpoint; the model's own
seeded parameters without one) or a ``.pkl`` file, ``trained_weights/siam``
in the working directory by default. The codec's noise is the port's
(a generator seeded ``--noise-seed``).
"""

from __future__ import annotations

import argparse
import sys

from ..models import instrument
from .common import add_device, watchdog


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, default="trained_weights/siam")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--demo", type=str, default=None,
                        help="render a demo phrase to this wav and exit")
    parser.add_argument("--harvest-seed", type=int, default=None,
                        help="harvest the demo's note vectors from a real "
                             "segment (match the overfit trainer's --seed "
                             "to play the checkpoint's learned sounds)")
    parser.add_argument("--selection-leak", type=float, default=0.0,
                        help="match the checkpoint's training-time decoder "
                             "semantics (see scripts/siam_overfit.py)")
    parser.add_argument("--selection-floor", type=float, default=0.0)
    parser.add_argument("--harvest-wav", type=str, default=None,
                        help="harvest note vectors from this wav (e.g. an "
                             "overfit run's target.wav) instead of the "
                             "synthetic iterator")
    parser.add_argument("--noise-seed", type=int, default=0,
                        help="codec PRNG seed; a --fixed-noise overfit "
                             "checkpoint memorizes PRNGKey(42)'s draws, "
                             "so pass 42 to play its learned sounds")
    parser.add_argument("--n-samples-log2", type=int, default=0,
                        help="with --n-events/--hidden/--context-dim: "
                             "play a scaled-config checkpoint (must "
                             "match its training geometry)")
    parser.add_argument("--n-events", type=int, default=0)
    parser.add_argument("--hidden", type=int, default=0)
    parser.add_argument("--context-dim", type=int, default=0)
    parser.add_argument("--attn-floor", type=float, default=0.0)
    parser.add_argument("--attn-leak", type=float, default=0.0)
    parser.add_argument("--watchdog-s", type=int, default=0,
                        help="self-bound --demo renders (a wedged TPU "
                             "relay otherwise blocks forever); 0 = off "
                             "for the interactive REPL")
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    watchdog(args.watchdog_s)
    size_overrides = None
    if args.n_samples_log2:
        size_overrides = {
            "n_samples": 2 ** args.n_samples_log2,
            "n_events": args.n_events or 32,
            "hidden": args.hidden or 128,
            "context_dim": args.context_dim or 32,
            "window": 2048,
            "attn_floor": args.attn_floor,
            "attn_leak": args.attn_leak,
        }
    inst = instrument.build_instrument(
        args.checkpoint, args.tiny, noise_seed=args.noise_seed, size_overrides=size_overrides,
        selection_leak=args.selection_leak, selection_floor=args.selection_floor,
        device=args.device)
    if args.demo:
        instrument.demo_phrase(inst, args.demo, harvest_seed=args.harvest_seed,
                               harvest_wav=args.harvest_wav)
    else:
        instrument.repl(inst, sys.stdin)
    return 0


if __name__ == "__main__":
    sys.exit(main())
