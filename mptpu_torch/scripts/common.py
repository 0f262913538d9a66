"""What the command lines share: the ``--device`` flag, the watchdog and
the printing of a run's logged losses."""

from __future__ import annotations

import argparse
import faulthandler
import sys
from typing import Sequence


def add_device(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The one flag a command line adds to its script's: where it runs."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cpu runs on the CPU; the default needs "
                             "CUDA and raises without it)")
    return parser


def watchdog(seconds: int) -> None:
    """Dump every thread's traceback and exit after ``seconds`` (0: none),
    as the scripts' ``--watchdog-s`` does."""
    if seconds:
        faulthandler.dump_traceback_later(seconds, exit=True)


def print_losses(losses: Sequence[float], every: int, digits: int = 4) -> None:
    """``iter i loss ...`` for every ``every``-th of a finished run's
    losses, as the scripts print them while they run."""
    for i in range(0, len(losses), every):
        print(f"iter {i} loss {float(losses[i]):.{digits}f}")


def fail(message: str) -> int:
    """The scripts' ``sys.exit(message)``: the message on stderr, code 1."""
    print(message, file=sys.stderr)
    return 1
