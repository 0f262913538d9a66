"""Command line of ``scripts/worker.py``: the synth-preset embedding
worker. It reads preset JSON files from ``--inbox``, renders and embeds
each with the SIAM encoder and a random projection, and writes an index
chunk for each into ``--outbox`` (``worker_inbox`` and ``worker_outbox``
in the working directory by default), polling until stopped or once with
``--once``.

    python -m mptpu_torch.scripts.worker [--inbox DIR] [--outbox DIR] [--once]
        [--tiny] [--checkpoint DIR] [--device cuda]

``--tiny`` is on by default, as in the script.
"""

from __future__ import annotations

import argparse
import sys

from ..models import worker
from .common import add_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--inbox", type=str, default="worker_inbox")
    parser.add_argument("--outbox", type=str, default="worker_outbox")
    parser.add_argument("--once", action="store_true")
    parser.add_argument("--tiny", action="store_true", default=True)
    parser.add_argument("--checkpoint", type=str, default=None)
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    worker.run_worker(args.inbox, args.outbox, once=args.once, tiny=args.tiny,
                      checkpoint_dir=args.checkpoint, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
