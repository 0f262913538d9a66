"""Command line of ``scripts/train_siam.py``, the flagship SIAM trainer:
stream audio batches, train the iterative decomposition, keep the event
reservoir, serve the dashboard on ``--port`` (0 serves none) and, with
``--save-weights``, checkpoint under ``trained_weights/siam`` in the
working directory.

    python -m mptpu_torch.scripts.train_siam [--tiny] [--iterations N]
        [--port 9999] [--save-weights] [--load-weights] [--device cuda]

The command line runs as one process, so ``--data-parallel`` trains on
the whole batch, as the script does on one device. Cutting the batch over
several cards from the command line (a ``torchrun`` group) is not ported
(ROADMAP A12b); ``models.siam_train.train_and_monitor(data_parallel=True)``
does it for a caller that has joined a process group.
"""

from __future__ import annotations

import argparse
import sys

from ..models import siam_train
from .common import add_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--overfit", action="store_true")
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--port", type=int, default=9999)
    parser.add_argument("--save-weights", action="store_true")
    parser.add_argument("--load-weights", action="store_true")
    parser.add_argument("--iterations", type=int, default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="small config for smoke testing")
    parser.add_argument("--audio-path", type=str, default=None)
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard the batch over all devices")
    parser.add_argument("--attn-floor", type=float, default=0.0,
                        help="amplitude floor keeping event gradients alive")
    parser.add_argument("--switch-clamp", type=float, default=100.0,
                        help="straight-through cap on the event-switch "
                             "amplitude (0 = exact reference semantics)")
    parser.add_argument("--residual-clamp", type=float, default=4.0,
                        help="residual-carry clip as a multiple of "
                             "max|initial spec| (0 = exact reference)")
    parser.add_argument("--encoder-clamp", type=float, default=1e4,
                        help="per-block activation clip in the gated "
                             "encoder stack (0 = exact reference)")
    parser.add_argument("--attn-leak", type=float, default=0.0,
                        help="straight-through leaky backward for the attention\n"
                             "relu (forward stays exact reference relu)")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--selection-leak", type=float, default=0.0,
                        help="leaky-relu slope for relu item selections; keeps\n"
                             "gradients alive if every selection goes negative")
    parser.add_argument("--seed", type=int, default=None,
                        help="data seed; with --overfit pins the segment so a\n"
                             "report can be generated on the same audio")
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    siam_train.train_and_monitor(
        batch_size=args.batch_size,
        overfit=args.overfit,
        port=args.port,
        save_weights=args.save_weights,
        load_weights=args.load_weights,
        iterations=args.iterations,
        tiny=args.tiny,
        audio_path=args.audio_path,
        data_parallel=False,   # one process: the whole batch
        attn_floor=args.attn_floor,
        attn_leak=args.attn_leak,
        switch_clamp=args.switch_clamp,
        residual_clamp=args.residual_clamp,
        encoder_clamp=args.encoder_clamp,
        log_every=args.log_every,
        seed=args.seed,
        selection_leak=args.selection_leak,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
